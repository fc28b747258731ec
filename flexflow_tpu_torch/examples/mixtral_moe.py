"""Mixtral-style MoE decoder training (examples/python/mixtral_moe.py on
the port).

The reference's example places experts over a mesh's expert axis
(--mesh data=2,expert=4 with mixtral_ep_strategy). The port runs one
card: that mesh raises (ROADMAP.md queue 1 item 12), so every expert
runs on the card, through the fused EXPERTS bank.

Run:  python -m flexflow_tpu_torch.examples.mixtral_moe -b 8 -e 1
"""

import sys

import numpy as np

from flexflow_tpu_torch import AdamOptimizer, FFConfig, FFModel, LossType
from flexflow_tpu_torch.models.mixtral import MixtralConfig, build_mixtral

SEQ = 128


def main(argv=None):
    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    mcfg = MixtralConfig.tiny()
    ff = FFModel(cfg)
    build_mixtral(ff, mcfg, batch_size=cfg.batch_size, seq_len=SEQ)
    ff.compile(
        optimizer=AdamOptimizer(lr=1e-3),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
    )
    rs = np.random.RandomState(0)
    n = cfg.batch_size * 4
    x = rs.randint(0, mcfg.vocab_size, (n, SEQ)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    return ff.fit(x, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
