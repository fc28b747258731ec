"""Llama decoder training (examples/python/llama_train.py on the port).

The reference's example trains under a hand TP strategy on a mesh with a
model axis (--mesh data=2,model=4), a searched one (--budget), or a
pipeline over a pipe axis (--pipeline --mesh data=2,pipe=4). The port
runs one card: those meshes raise (ROADMAP.md queue 1 item 12); --budget
runs the strategy search on the one card's mesh. It trains the same tiny
Llama on one card; --pipeline builds its blocks as one PIPELINE
composite, which the port runs block after block on the card.

Run:  python -m flexflow_tpu_torch.examples.llama_train -b 8 -e 1 [--pipeline]
"""

import dataclasses
import sys

import numpy as np

from flexflow_tpu_torch import (
    AdamOptimizer, FFConfig, FFModel, LossType, MetricsType,
)
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

SEQ = 256


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    use_pipeline = "--pipeline" in args
    if use_pipeline:
        args.remove("--pipeline")
    cfg = FFConfig.from_args(args)
    lcfg = LlamaConfig.tiny(vocab=2048)
    if use_pipeline:
        # 4 layers, so the composite stacks more than the tiny config's 2
        lcfg = dataclasses.replace(lcfg, layers=4)
    ff = FFModel(cfg)
    build_llama(ff, lcfg, batch_size=cfg.batch_size, seq_len=SEQ,
                use_pipeline=use_pipeline)
    ff.compile(
        optimizer=AdamOptimizer(lr=1e-3),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
    )
    rs = np.random.RandomState(0)
    n = cfg.batch_size * 8
    x = rs.randint(0, lcfg.vocab_size, (n, SEQ)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    return ff.fit(x, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
