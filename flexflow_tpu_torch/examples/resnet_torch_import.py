"""A residual CNN written in PyTorch, imported through the torch.fx
frontend and trained (examples/python/resnet_torch_import.py on the
port): torch module -> fx trace -> FFModel.

Run:  python -m flexflow_tpu_torch.examples.resnet_torch_import -b 8 -e 1
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
)


def make_torch_resnet_block():
    """A small residual CNN with ResNet's op mix (conv, BatchNorm, ReLU,
    average pool, linear head)."""
    import torch.nn as nn

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 16, 3, padding=1)
            self.bn1 = nn.BatchNorm2d(16)
            self.relu = nn.ReLU()
            self.conv2 = nn.Conv2d(16, 16, 3, padding=1)
            self.bn2 = nn.BatchNorm2d(16)
            self.fc = nn.Linear(16, 10)

        def forward(self, x):
            h = self.relu(self.bn1(self.conv1(x)))
            h = self.bn2(self.conv2(h))
            h = self.relu(h)
            h = nn.functional.avg_pool2d(h, 32)  # static: fx-traceable
            h = h.flatten(1)
            return self.fc(h)

    return Block()


def main(argv=None):
    from flexflow_tpu_torch.frontends.torch_fx import PyTorchModel

    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    ff = FFModel(cfg)
    x = ff.create_tensor((cfg.batch_size, 3, 32, 32), name="input")
    module = make_torch_resnet_block()
    out = PyTorchModel(module).torch_to_ff(ff, [x])[0]
    ff.softmax(out, name="softmax")
    ff.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.ACCURACY],
    )
    rs = np.random.RandomState(0)
    n = cfg.batch_size * 4
    xs = rs.randn(n, 3, 32, 32).astype(np.float32)
    ys = rs.randint(0, 10, n).astype(np.int32)
    return ff.fit(xs, ys, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
