"""CANDLE-UNO drug-response regression on synthetic features
(examples/python/candle_uno.py on the port): three encoder towers, a
dense head, one growth value.

Run:  python -m flexflow_tpu_torch.examples.candle_uno -b 16 -e 2
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    FFConfig, FFModel, LossType, MetricsType, SGDOptimizer,
)
from flexflow_tpu_torch.models.candle_uno import build_candle_uno


def main(argv=None):
    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    ff = FFModel(cfg)
    dims = {"gene": 64, "drug1": 48, "drug2": 48}
    build_candle_uno(ff, feature_dims=dims, tower_dims=(64, 32),
                     head_dims=(64, 32))
    ff.compile(
        optimizer=SGDOptimizer(lr=0.01),
        loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        metrics=[MetricsType.MEAN_SQUARED_ERROR],
    )
    rs = np.random.RandomState(0)
    n = max(cfg.batch_size * 4, 32)
    xs = [rs.randn(n, 1).astype(np.float32)]
    xs += [rs.randn(n, d).astype(np.float32) for d in dims.values()]
    y = rs.rand(n, 1).astype(np.float32)
    return ff.fit(xs, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
