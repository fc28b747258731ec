"""Fine-tune a HuggingFace Llama through the HF importer
(examples/python/hf_finetune.py on the port): the checkpoint's weights are
mapped onto the port's own Llama graph (frontends/hf.py), so training runs
the port's lowerings and kernels.

With no --model, a tiny Llama is built locally: by `transformers` where it
is installed, else as a stand-in with the same attribute names and seeded
weights (frontends/hf_standin.py). Nothing is downloaded.

Run (tiny local model):  python -m flexflow_tpu_torch.examples.hf_finetune -b 4 -e 1
Run (a checkpoint directory on disk, with transformers installed):
    python -m flexflow_tpu_torch.examples.hf_finetune --model /path/to/ckpt -b 4
"""

import sys

import numpy as np

from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, LossType
from flexflow_tpu_torch.frontends.hf import (
    copy_hf_weights, import_hf_causal_lm,
)

SEQ = 64
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, tie_word_embeddings=False)


def load_hf_model(path=None):
    """(model, where it came from)."""
    if path:
        from transformers import AutoModelForCausalLM

        return AutoModelForCausalLM.from_pretrained(path), path
    try:
        import torch
        from transformers import LlamaConfig, LlamaForCausalLM
    except ImportError:
        from flexflow_tpu_torch.frontends.hf_standin import llama_standin

        return llama_standin(**TINY), "a tiny Llama stand-in"
    torch.manual_seed(0)
    cfg = LlamaConfig(max_position_embeddings=SEQ, **TINY)
    return LlamaForCausalLM(cfg), "a locally built tiny Llama"


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    path = None
    if "--model" in args:
        i = args.index("--model")
        if i + 1 >= len(args):
            raise ValueError("flag --model requires a checkpoint path")
        path = args[i + 1]
        del args[i:i + 2]
    cfg = FFConfig.from_args(args)
    hf, source = load_hf_model(path)

    ff = FFModel(cfg)
    import_hf_causal_lm(hf, ff, batch_size=cfg.batch_size, seq_len=SEQ)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    n = copy_hf_weights(hf, ff)
    print(f"imported {n} weight tensors from {source}")

    # synthetic next-token data: a cycling alphabet
    rs = np.random.RandomState(0)
    nrows = cfg.batch_size * 8
    starts = rs.randint(0, 16, nrows)
    x = ((starts[:, None] + np.arange(SEQ)[None]) % 16).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    m = ff.fit(x, y, epochs=cfg.epochs, verbose=True)
    print(f"fine-tuned {m.train_all} sequences")
    return m


if __name__ == "__main__":
    main()
