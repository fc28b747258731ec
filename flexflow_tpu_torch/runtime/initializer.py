"""Weight initializers (counterpart of flexflow_tpu/runtime/initializer.py).

Each initializer is a function of (torch.Generator, shape, dtype, device)
and draws on the target device, so a model's weights never pass through
host memory. torch.Generator and jax.random draw different numbers from
the same seed: the distributions match the reference's, the values do
not (tests that compare the two packages carry the JAX weights over with
runtime.weights.params_from_numpy). The constructors take the
reference's arguments; a `seed` field is kept as the reference keeps it,
and the draw comes from the per-leaf generator Executor.init_params
hands in.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape: Tuple[int, ...],
                 dtype: torch.dtype, device) -> torch.Tensor:
        raise NotImplementedError


def _fans(shape) -> Tuple[int, int]:
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv OIHW: receptive field x channels (a stacked 3-D or 4-D leaf is
    # read the same way, as the reference reads it)
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def _uniform(gen, shape, lo: float, hi: float, dtype, device):
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.uniform_(lo, hi, generator=gen).to(dtype)


@dataclasses.dataclass(frozen=True)
class GlorotUniformInitializer(Initializer):
    seed: int = 0

    def __call__(self, gen, shape, dtype, device):
        if len(shape) < 2:
            return torch.zeros(shape, dtype=dtype, device=device)
        fan_in, fan_out = _fans(shape)
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        return _uniform(gen, shape, -limit, limit, dtype, device)


@dataclasses.dataclass(frozen=True)
class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ConstantInitializer(Initializer):
    value: float = 0.0

    def __call__(self, gen, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class UniformInitializer(Initializer):
    minv: float = -0.05
    maxv: float = 0.05
    seed: int = 0

    def __call__(self, gen, shape, dtype, device):
        return _uniform(gen, shape, self.minv, self.maxv, dtype, device)


@dataclasses.dataclass(frozen=True)
class NormInitializer(Initializer):
    mean: float = 0.0
    stddev: float = 0.02
    seed: int = 0

    def __call__(self, gen, shape, dtype, device):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.normal_(self.mean, self.stddev, generator=gen).to(dtype)


@dataclasses.dataclass(frozen=True)
class ArrayInitializer(Initializer):
    """Initialize from a fixed host array (imported constants). The array
    is captured by object identity."""

    array: object = None

    def __call__(self, gen, shape, dtype, device):
        arr = np.asarray(self.array)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"ArrayInitializer shape {arr.shape} != {shape}")
        return torch.as_tensor(arr).to(device=device, dtype=dtype)


_BY_NAME = {
    "glorot_uniform": GlorotUniformInitializer(),
    "zeros": ZeroInitializer(),
    "ones": ConstantInitializer(1.0),
    "normal": NormInitializer(),
    "uniform": UniformInitializer(),
}


def resolve(init) -> Initializer:
    """The initializer a WeightSpec names, or `init` itself when it is an
    Initializer (a layer method's override); None is glorot_uniform."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return _BY_NAME["glorot_uniform"]
    return _BY_NAME[init]
