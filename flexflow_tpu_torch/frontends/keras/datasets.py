"""Dataset loaders with the keras API shape (reference
python/flexflow/keras/datasets: mnist/cifar10/reuters).

Nothing is downloaded: the loaders generate DETERMINISTIC SYNTHETIC
data with the real datasets' shapes/dtypes/class counts — each class is a
noisy prototype so models actually learn. Swap in real data by replacing
these functions; the shapes match keras exactly.
"""

from __future__ import annotations

import numpy as np


def _protos(n_classes: int, shape, seed: int):
    rs = np.random.RandomState(seed)
    return rs.rand(n_classes, *shape).astype(np.float32)


def _make(n: int, n_classes: int, shape, seed: int, noise: float = 0.15):
    rs = np.random.RandomState(seed + 1)
    y = rs.randint(0, n_classes, n)
    protos = _protos(n_classes, shape, seed)
    x = protos[y] + noise * rs.randn(n, *shape).astype(np.float32)
    x = np.clip(x, 0.0, 1.0)
    return (x * 255).astype(np.uint8), y.astype(np.int64)


class mnist:
    @staticmethod
    def load_data(n_train: int = 8192, n_test: int = 1024, seed: int = 0):
        """(x_train, y_train), (x_test, y_test) — x: uint8 (n, 28, 28)."""
        xtr, ytr = _make(n_train, 10, (28, 28), seed)
        xte, yte = _make(n_test, 10, (28, 28), seed + 100)
        return (xtr, ytr), (xte, yte)


class cifar10:
    @staticmethod
    def load_data(n_train: int = 8192, n_test: int = 1024, seed: int = 0):
        """(x_train, y_train), (x_test, y_test) — x: uint8 (n, 32, 32, 3),
        y: (n, 1) like keras."""
        xtr, ytr = _make(n_train, 10, (32, 32, 3), seed)
        xte, yte = _make(n_test, 10, (32, 32, 3), seed + 100)
        return (xtr, ytr[:, None]), (xte, yte[:, None])
