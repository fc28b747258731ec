"""AlexNet on CIFAR-10-shaped synthetic data (examples/python/
alexnet_cifar10.py on the port; the reference's bootcamp demo).

Run:  python -m flexflow_tpu_torch.examples.alexnet_cifar10 -b 64 -e 2
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
)
from flexflow_tpu_torch.models.alexnet import build_alexnet_cifar10


def synthetic_cifar(n=2048, seed=0):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, n).astype(np.int32)
    x = (rs.randn(n, 3, 32, 32).astype(np.float32)
         + y[:, None, None, None] * 0.05)
    return x, y


def main(argv=None):
    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    ff = FFModel(cfg)
    build_alexnet_cifar10(ff, batch_size=cfg.batch_size)
    ff.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.ACCURACY],
    )
    x, y = synthetic_cifar(n=cfg.batch_size * 8)
    return ff.fit(x, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
