"""DLRM click-through training on synthetic clicks (examples/python/
dlrm_train.py on the port): sparse embedding bags, bottom and top MLPs,
MSE, several input tensors.

Run:  python -m flexflow_tpu_torch.examples.dlrm_train -b 32 -e 2
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
)
from flexflow_tpu_torch.models.dlrm import build_dlrm

NUM_SPARSE, VOCAB, EMBED, DENSE = 4, 1000, 16, 8


def synthetic_clicks(n=1024, seed=0):
    rs = np.random.RandomState(seed)
    dense = rs.randn(n, DENSE).astype(np.float32)
    sparse = [rs.randint(0, VOCAB, (n, 1)).astype(np.int32)
              for _ in range(NUM_SPARSE)]
    # clicks follow the dense features through a fixed projection
    w = rs.randn(DENSE, 1)
    y = (1.0 / (1.0 + np.exp(-dense @ w))).astype(np.float32)
    return dense, sparse, y


def main(argv=None):
    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    ff = FFModel(cfg)
    build_dlrm(ff, num_sparse=NUM_SPARSE, vocab=VOCAB, embed_dim=EMBED,
               dense_dim=DENSE, bot_mlp=(64, 32, EMBED), top_mlp=(64, 1),
               batch_size=cfg.batch_size)
    ff.compile(
        optimizer=SGDOptimizer(lr=0.05),
        loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        metrics=[MetricsType.MEAN_SQUARED_ERROR],
    )
    dense, sparse, y = synthetic_clicks()
    return ff.fit([dense] + sparse, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
