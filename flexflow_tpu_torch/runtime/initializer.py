"""Weight initializers (counterpart of flexflow_tpu/runtime/initializer.py).

Each initializer is a function of (torch.Generator, shape, dtype, device)
and draws on the target device, so a model's weights never pass through
host memory. torch.Generator and jax.random draw different numbers from
the same seed: the distributions match the reference's, the values do
not (tests that compare the two packages carry the JAX weights over with
runtime.weights.params_from_numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape: Tuple[int, ...],
                 dtype: torch.dtype, device) -> torch.Tensor:
        raise NotImplementedError


def _fans(shape) -> Tuple[int, int]:
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class GlorotUniformInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        if len(shape) < 2:
            return torch.zeros(shape, dtype=dtype, device=device)
        fan_in, fan_out = _fans(shape)
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.uniform_(-limit, limit, generator=gen).to(dtype)


class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class ConstantInitializer(Initializer):
    value: float = 0.0

    def __call__(self, gen, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class NormInitializer(Initializer):
    mean: float = 0.0
    stddev: float = 0.02

    def __call__(self, gen, shape, dtype, device):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        return x.normal_(self.mean, self.stddev, generator=gen).to(dtype)


_BY_NAME = {
    "glorot_uniform": GlorotUniformInitializer(),
    "zeros": ZeroInitializer(),
    "ones": ConstantInitializer(1.0),
    "normal": NormInitializer(),
}


def resolve(name: str) -> Initializer:
    """The initializer a WeightSpec names."""
    return _BY_NAME[name]
