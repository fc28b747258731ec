"""Tensor shape IR (counterpart of flexflow_tpu/pcg/tensor.py).

Shapes are plain data: logical dims + dtype, and per-dim partition
degrees with the names of the mesh axes that shard them. The strategy
search reasons about degrees on a modeled machine; on the port's one card
every shard lives on that card. There is no PartitionSpec.
"""

from __future__ import annotations

import dataclasses
import math
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

    def size_bytes(self) -> int:
        return self.num_elements() * self.dtype.size_bytes

    def num_elements(self) -> int:
        return math.prod(self.dims) if self.dims else 1

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

    @property
    def shard_size(self) -> int:
        return self.size // self.degree

    def with_degree(self, degree: int,
                    axes: Tuple[str, ...] = ()) -> "ParallelDim":
        return ParallelDim(self.size, degree, axes)


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

    def degree(self, dim: int) -> int:
        return self.dims[dim].degree

    @property
    def replica_degree(self) -> int:
        return self.replica.degree

    def total_degree(self) -> int:
        """Number of shards (devices this tensor's computation spans)."""
        return math.prod(d.degree for d in self.dims) * self.replica.degree

    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(d.shard_size for d in self.dims)

    def shard_bytes(self) -> int:
        return math.prod(self.shard_shape()) * self.dtype.size_bytes

    def global_bytes(self) -> int:
        return self.to_shape().size_bytes()

    def is_fully_replicated(self) -> bool:
        return all(d.degree == 1 for d in self.dims)

    def with_dim_degree(self, dim: int, degree: int,
                        axes: Tuple[str, ...] = ()) -> "ParallelTensorShape":
        dims = list(self.dims)
        dims[dim] = dims[dim].with_degree(degree, axes)
        return dataclasses.replace(self, dims=tuple(dims))

    def with_replica(self, degree: int,
                     axes: Tuple[str, ...] = ()) -> "ParallelTensorShape":
        return dataclasses.replace(self,
                                   replica=ParallelDim(degree, degree, axes))

    def __str__(self) -> str:
        parts = []
        for d in self.dims:
            s = str(d.size)
            if d.degree > 1:
                s += f"/{d.degree}" + (f"{list(d.axes)}" if d.axes else "")
            parts.append(s)
        r = f" r{self.replica.degree}" if self.replica.degree > 1 else ""
        return f"[{', '.join(parts)}]{r}:{self.dtype.value}"
