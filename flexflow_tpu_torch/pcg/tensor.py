"""Tensor shape IR (counterpart of flexflow_tpu/pcg/tensor.py).

Shapes are plain data: logical dims + dtype, and per-dim partition
degrees with the names of the mesh axes that would shard them. The port
runs on one device, so degrees stay 1; they are kept so the attrs' shape
inference reads the same as the reference's. There is no PartitionSpec.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from flexflow_tpu_torch.ffconst import DataType


@dataclasses.dataclass(frozen=True)
class TensorShape:
    """Logical (unsharded) shape, numpy dim order (dim 0 = batch)."""

    dims: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def __str__(self) -> str:
        return f"{list(self.dims)}:{self.dtype.value}"


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One dimension: global `size` split `degree` ways over mesh `axes`."""

    size: int
    degree: int = 1
    axes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"degree must be >= 1, got {self.degree}")
        if self.size % self.degree != 0:
            raise ValueError(
                f"size {self.size} not divisible by degree {self.degree}")


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    """Per-dim partition degrees plus a replica degree, kept out of band
    so logical dim indices match the frontend shape."""

    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.FLOAT
    replica: ParallelDim = dataclasses.field(
        default_factory=lambda: ParallelDim(1, 1))

    @staticmethod
    def from_shape(shape: TensorShape) -> "ParallelTensorShape":
        return ParallelTensorShape(
            tuple(ParallelDim(d) for d in shape.dims), shape.dtype)

    def to_shape(self) -> TensorShape:
        return TensorShape(tuple(d.size for d in self.dims), self.dtype)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def __str__(self) -> str:
        parts = []
        for d in self.dims:
            s = str(d.size)
            if d.degree > 1:
                s += f"/{d.degree}" + (f"{list(d.axes)}" if d.axes else "")
            parts.append(s)
        r = f" r{self.replica.degree}" if self.replica.degree > 1 else ""
        return f"[{', '.join(parts)}]{r}:{self.dtype.value}"
