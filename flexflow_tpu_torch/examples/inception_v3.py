"""Inception-v3 on synthetic images (examples/python/inception_v3.py on
the port): multi-branch concat blocks, at 75x75 so the example stays
small.

The reference's example takes --budget for its strategy search, and so
does the port's: compile() runs the search (search/api.py) on the
configured mesh.

Run:  python -m flexflow_tpu_torch.examples.inception_v3 -b 4 -e 1
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
)
from flexflow_tpu_torch.models.inception import build_inception_v3


def main(argv=None):
    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    ff = FFModel(cfg)
    size, classes = 75, 10
    build_inception_v3(ff, image_size=size, classes=classes)
    ff.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.ACCURACY],
    )
    rs = np.random.RandomState(0)
    n = max(cfg.batch_size * 2, 8)
    x = rs.randn(n, 3, size, size).astype(np.float32)
    y = rs.randint(0, classes, n).astype(np.int32)
    return ff.fit(x, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
