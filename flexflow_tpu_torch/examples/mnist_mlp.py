"""MLP classifier (examples/python/mnist_mlp.py on the port): 784-512-512-10
on synthetic MNIST-shaped data (nothing is downloaded).

Run:  python -m flexflow_tpu_torch.examples.mnist_mlp -b 64 -e 3
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
)
from flexflow_tpu_torch.models.mlp import build_mlp


def synthetic_mnist(n=4096, seed=0):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, n)
    protos = rs.randn(10, 784).astype(np.float32)
    x = protos[y] + 0.3 * rs.randn(n, 784).astype(np.float32)
    return x, y.astype(np.int32)


def main(argv=None):
    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    ff = FFModel(cfg)
    build_mlp(ff, 784, [512, 512], 10, batch_size=cfg.batch_size)
    ff.compile(
        optimizer=SGDOptimizer(lr=0.05),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.ACCURACY,
                 MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
    )
    x, y = synthetic_mnist()
    ff.fit(x, y, epochs=cfg.epochs)
    return ff.eval(x[:1024], y[:1024])


if __name__ == "__main__":
    main()
