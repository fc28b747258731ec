"""Llama decoder training (examples/python/llama_train.py on the port).

The reference's example trains under a hand TP strategy on a mesh with a
model axis (--mesh data=2,model=4), a searched one (--budget), or a
pipeline over a pipe axis (--pipeline --mesh data=2,pipe=4). The port
runs the first two one process per card: on a --mesh it trains under
llama_tp_strategy, with --budget under the searched strategy (rank 0
searches, every rank runs its result); a mesh with a `seq` axis builds
the attention as ring attention and cuts the sequence over it
(seq_parallel=True: the ring between the ranks). A pipe axis raises
(ROADMAP.md queue 1 item 12); --pipeline on one card builds the blocks as
one PIPELINE composite, which runs block after block.

Run:  python -m flexflow_tpu_torch.examples.llama_train -b 8 -e 1 [--pipeline]
      torchrun --nproc-per-node 4 -m flexflow_tpu_torch \
          flexflow_tpu_torch/examples/llama_train.py -b 8 --mesh data=2,model=2
      (or --mesh data=2,seq=2)
"""

import dataclasses
import sys

import numpy as np

from flexflow_tpu_torch import (
    AdamOptimizer, FFConfig, FFModel, LossType, MetricsType,
)
from flexflow_tpu_torch.models.llama import (
    LlamaConfig, build_llama, llama_tp_strategy,
)

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
    ring = (cfg.mesh_shape or {}).get("seq", 1) > 1 and not use_pipeline
    build_llama(ff, lcfg, batch_size=cfg.batch_size, seq_len=SEQ,
                use_pipeline=use_pipeline, use_ring_attention=ring)
    strategy = None
    if cfg.mesh_shape and not use_pipeline and cfg.search_budget == 0:
        strategy = llama_tp_strategy(lcfg, seq_parallel=ring)
    ff.compile(
        optimizer=AdamOptimizer(lr=1e-3),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
        strategy=strategy,
    )
    rs = np.random.RandomState(0)
    n = cfg.batch_size * 8
    x = rs.randint(0, lcfg.vocab_size, (n, SEQ)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    return ff.fit(x, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
