"""Attribute dataclasses of the Llama path's operators (counterpart of
flexflow_tpu/ops/attrs.py): INPUT, EMBEDDING, RMS_NORM, LINEAR,
ELEMENT_BINARY, ELEMENT_UNARY, SOFTMAX, MULTIHEAD_ATTENTION.

Field names, order and defaults match the reference, so `repr(attrs)` —
and with it Graph.structure_hash — agrees between the two packages, and
the weight specs keep the JAX layouts: `kernel` (in, out), `wq` (E, H, D),
`wk`/`wv` (E, Hkv, D), `wo` (H, D, E), `scale`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.ops.base import (
    OpAttrs,
    WeightSpec,
    broadcast_dims,
    elementwise_like,
)
from flexflow_tpu_torch.pcg.tensor import (
    ParallelDim,
    ParallelTensorShape,
    TensorShape,
)

Shape = ParallelTensorShape


def _carry(dim: ParallelDim, size: Optional[int] = None) -> ParallelDim:
    """Copy a dim's sharding onto a (possibly resized) output dim; drops
    the sharding if the new size is not divisible by the degree."""
    size = dim.size if size is None else size
    if size % dim.degree == 0:
        return ParallelDim(size, dim.degree, dim.axes)
    return ParallelDim(size)


@dataclasses.dataclass(frozen=True)
class InputAttrs(OpAttrs):
    """PCG source node for a user input."""

    shape: TensorShape

    def infer(self, *ins):
        return (ParallelTensorShape.from_shape(self.shape),)


@dataclasses.dataclass(frozen=True)
class LinearAttrs(OpAttrs):
    """Dense layer: y = act(x @ W + b); W (in_dim, out_dim), b (out_dim,)."""

    out_dim: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE
    dtype: Optional[DataType] = None

    def infer(self, x: Shape):
        out_dims = (tuple(_carry(d) for d in x.dims[:-1])
                    + (ParallelDim(self.out_dim),))
        return (Shape(out_dims, self.dtype or x.dtype, x.replica),)

    def weights(self, x: Shape):
        in_dim = x.dims[-1].size
        w = {"kernel": WeightSpec(TensorShape((in_dim, self.out_dim),
                                              x.dtype))}
        if self.use_bias:
            w["bias"] = WeightSpec(TensorShape((self.out_dim,), x.dtype),
                                   "zeros")
        return w


@dataclasses.dataclass(frozen=True)
class EmbeddingAttrs(OpAttrs):
    """Embedding lookup: int ids (batch, bag) -> (batch, bag, out_dim)
    (NONE) or (batch, out_dim) (SUM/AVG pool the bag dim)."""

    num_entries: int
    out_dim: int
    aggr: AggrMode = AggrMode.NONE
    dtype: DataType = DataType.FLOAT

    def infer(self, x: Shape):
        lead = x.dims if self.aggr == AggrMode.NONE else x.dims[:-1]
        dims = tuple(_carry(d) for d in lead) + (ParallelDim(self.out_dim),)
        return (Shape(dims, self.dtype, x.replica),)

    def weights(self, x: Shape):
        return {"kernel": WeightSpec(
            TensorShape((self.num_entries, self.out_dim), self.dtype),
            "normal")}


@dataclasses.dataclass(frozen=True)
class MultiHeadAttentionAttrs(OpAttrs):
    """Multi-head attention with GQA (kv_heads < num_heads), causal
    masking and rotary embeddings. Weights packed per head."""

    embed_dim: int
    num_heads: int
    kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    causal: bool = False
    use_bias: bool = False
    dropout: float = 0.0
    rope: bool = False
    rope_theta: float = 10000.0

    @property
    def kdim(self) -> int:
        return self.head_dim or self.embed_dim // self.num_heads

    @property
    def num_kv(self) -> int:
        return self.kv_heads or self.num_heads

    def infer(self, q: Shape, k: Shape = None, v: Shape = None):
        dims = (tuple(_carry(d) for d in q.dims[:-1])
                + (ParallelDim(self.embed_dim),))
        return (Shape(dims, q.dtype, q.replica),)

    def weights(self, q: Shape, k: Shape = None, v: Shape = None):
        k = k or q
        v = v or q
        dt = q.dtype
        hd = self.kdim
        w = {
            "wq": WeightSpec(TensorShape(
                (q.dims[-1].size, self.num_heads, hd), dt)),
            "wk": WeightSpec(TensorShape(
                (k.dims[-1].size, self.num_kv, hd), dt)),
            "wv": WeightSpec(TensorShape(
                (v.dims[-1].size, self.num_kv, hd), dt)),
            "wo": WeightSpec(TensorShape(
                (self.num_heads, hd, self.embed_dim), dt)),
        }
        if self.use_bias:
            w["bq"] = WeightSpec(TensorShape((self.num_heads, hd), dt),
                                 "zeros")
            w["bk"] = WeightSpec(TensorShape((self.num_kv, hd), dt), "zeros")
            w["bv"] = WeightSpec(TensorShape((self.num_kv, hd), dt), "zeros")
            w["bo"] = WeightSpec(TensorShape((self.embed_dim,), dt), "zeros")
        return w


@dataclasses.dataclass(frozen=True)
class ElementBinaryAttrs(OpAttrs):
    """add/subtract/multiply/divide/max/min with numpy broadcast."""

    kind: str
    position_table: bool = False

    def infer(self, a: Shape, b: Shape):
        out = broadcast_dims(tuple(d.size for d in a.dims),
                             tuple(d.size for d in b.dims))
        src = a if a.ndim >= b.ndim else b
        dims = []
        for i, size in enumerate(out):
            sd = src.dims[i]
            dims.append(_carry(sd, size) if sd.size == size
                        else ParallelDim(size))
        return (Shape(tuple(dims), a.dtype, src.replica),)


@dataclasses.dataclass(frozen=True)
class ElementUnaryAttrs(OpAttrs):
    """Elementwise unary op (`kind`: silu, relu, exp, ...); `scalar` feeds
    pow's exponent and the scalar_* operand."""

    kind: str
    scalar: float = 0.0
    inplace: bool = False

    def infer(self, x: Shape):
        return (elementwise_like(x),)


@dataclasses.dataclass(frozen=True)
class RMSNormAttrs(OpAttrs):
    eps: float = 1e-6

    def infer(self, x: Shape):
        return (elementwise_like(x),)

    def weights(self, x: Shape):
        return {"scale": WeightSpec(
            TensorShape((x.dims[-1].size,), x.dtype), "ones")}


@dataclasses.dataclass(frozen=True)
class SoftmaxAttrs(OpAttrs):
    axis: int = -1

    def infer(self, x: Shape):
        return (elementwise_like(x),)
