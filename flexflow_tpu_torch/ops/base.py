"""Operator attrs base class and weight declaration (counterpart of
flexflow_tpu/ops/base.py)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.pcg.tensor import (
    ParallelDim,
    ParallelTensorShape,
    TensorShape,
)


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One weight tensor of an op: logical shape + default initializer
    name ("glorot_uniform", "zeros", "ones", "normal")."""

    shape: TensorShape
    initializer: str = "glorot_uniform"
    trainable: bool = True


class OpAttrs:
    """Base class for operator attribute dataclasses (frozen, hashable):
    `infer` gives output shapes, `weights` the op's weight specs."""

    def infer(self, *ins: ParallelTensorShape) -> Tuple[ParallelTensorShape, ...]:
        raise NotImplementedError

    def weights(self, *ins: ParallelTensorShape) -> Dict[str, WeightSpec]:
        return {}


def elementwise_like(s: ParallelTensorShape,
                     dtype: Optional[DataType] = None) -> ParallelTensorShape:
    """Output shape identical to input (degrees propagate through)."""
    return dataclasses.replace(s, dtype=dtype or s.dtype)


def fresh(dims: Tuple[int, ...], dtype: DataType) -> ParallelTensorShape:
    """Unsharded shape from logical dims."""
    return ParallelTensorShape(tuple(ParallelDim(d) for d in dims), dtype)


def broadcast_dims(a: Tuple[int, ...], b: Tuple[int, ...]) -> Tuple[int, ...]:
    """Numpy broadcast of logical dims."""
    out = []
    la, lb = len(a), len(b)
    n = max(la, lb)
    for i in range(n):
        da = a[la - n + i] if la - n + i >= 0 else 1
        db = b[lb - n + i] if lb - n + i >= 0 else 1
        if da != db and da != 1 and db != 1:
            raise ValueError(f"cannot broadcast {a} with {b}")
        out.append(max(da, db))
    return tuple(out)
