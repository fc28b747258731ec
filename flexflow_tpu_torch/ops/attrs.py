"""Attribute dataclasses of the ported operators (counterpart of
flexflow_tpu/ops/attrs.py): INPUT, WEIGHT, EMBEDDING, RMS_NORM,
LAYER_NORM, LINEAR, ELEMENT_BINARY, ELEMENT_UNARY, SOFTMAX,
MULTIHEAD_ATTENTION, RING_ATTENTION, TOPK and the MoE ops (GROUP_BY,
AGGREGATE, AGGREGATE_SPEC, EXPERTS).

Field names, order and defaults match the reference, so `repr(attrs)` —
and with it Graph.structure_hash — agrees between the two packages, and
the weight specs keep the JAX layouts: `kernel` (in, out), `wq` (E, H, D),
`wk`/`wv` (E, Hkv, D), `wo` (H, D, E), `scale`, `bias`, `weight`, the
experts' `w1` (n, dim, hidden) and `w2` (n, hidden, out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
class WeightAttrs(OpAttrs):
    """PCG source node for a standalone weight (create_weight), e.g.
    GPT-2's learned position table."""

    shape: TensorShape
    initializer: str = "glorot_uniform"

    def infer(self, *ins):
        return (ParallelTensorShape.from_shape(self.shape),)

    def weights(self, *ins):
        return {"weight": WeightSpec(self.shape, self.initializer)}


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


SEQ_MODES = ("ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class RingAttentionAttrs(MultiHeadAttentionAttrs):
    """Sequence-parallel attention: MultiHeadAttention's math and
    weights with the sequence cut over the mesh's `seq` axis. `seq_mode`
    picks the exchange: "ring" rotates k/v blocks (parallel/ring.py);
    "ulysses" (the reference's all-to-all of sequence for heads) is not
    ported yet and raises."""

    seq_mode: str = "ring"

    def __post_init__(self):
        if self.seq_mode == "ulysses":
            raise NotImplementedError(
                'seq_mode="ulysses" is not ported yet (ROADMAP.md, queue 1 '
                'item 12); use "ring"')
        if self.seq_mode not in SEQ_MODES:
            raise ValueError(f"seq_mode must be one of {SEQ_MODES}, got "
                             f"{self.seq_mode!r}")


@dataclasses.dataclass(frozen=True)
class ElementBinaryAttrs(OpAttrs):
    """add/subtract/multiply/divide/max/min with numpy broadcast.
    `position_table` marks the add of a learned absolute-position row
    table (add_position_embedding): under a KV cache the lowering takes
    the table's rows at the cache positions."""

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
class LayerNormAttrs(OpAttrs):
    """LayerNorm over `axes`, with a scale and a bias over those axes
    when `elementwise_affine`."""

    axes: Tuple[int, ...] = (-1,)
    elementwise_affine: bool = True
    eps: float = 1e-5

    def infer(self, x: Shape):
        return (elementwise_like(x),)

    def weights(self, x: Shape):
        if not self.elementwise_affine:
            return {}
        norm_shape = tuple(x.dims[a].size for a in self.axes)
        return {
            "scale": WeightSpec(TensorShape(norm_shape, x.dtype), "ones"),
            "bias": WeightSpec(TensorShape(norm_shape, x.dtype), "zeros"),
        }


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


@dataclasses.dataclass(frozen=True)
class TopKAttrs(OpAttrs):
    """Top-k along the last dim -> (values, int32 indices)."""

    k: int
    sorted: bool = True

    def infer(self, x: Shape):
        dims = tuple(_carry(d) for d in x.dims[:-1]) + (ParallelDim(self.k),)
        return (Shape(dims, x.dtype, x.replica),
                Shape(dims, DataType.INT32, x.replica))


# ---------------------------------------------------------------------------
# MoE ops


def moe_capacity(rows: int, k: int, alpha: float, n_experts: int) -> int:
    """Rows each expert takes: ceil(k * rows * alpha / n_experts), at
    least 1. A (row, choice) past its expert's capacity is dropped."""
    return max(1, int(math.ceil(k * rows * alpha / n_experts)))


@dataclasses.dataclass(frozen=True)
class GroupByAttrs(OpAttrs):
    """Route tokens to per-expert buffers. Inputs: data (batch, dim),
    assignments (batch, k) int. Outputs: n_experts tensors (capacity,
    dim), capacity = ceil(k * batch * alpha / n)."""

    n_experts: int
    alpha: float = 1.0  # capacity factor

    def capacity(self, batch: int, k: int) -> int:
        return moe_capacity(batch, k, self.alpha, self.n_experts)

    def infer(self, x: Shape, assign: Shape):
        cap = self.capacity(x.dims[0].size, assign.dims[-1].size)
        out = Shape((ParallelDim(cap), _carry(x.dims[-1])), x.dtype,
                    x.replica)
        return tuple(out for _ in range(self.n_experts))


@dataclasses.dataclass(frozen=True)
class AggregateAttrs(OpAttrs):
    """Weighted combine of expert outputs. Inputs: gate_preds (batch, k),
    gate_assign (batch, k), true_gate_assign (batch, k), the full gate
    (batch, n), then n expert outputs (cap, dim). Output: (batch, dim).
    `lambda_bal` weighs the load-balancing term."""

    n_experts: int
    lambda_bal: float = 0.0

    def infer(self, *ins: Shape):
        gate_preds, expert0 = ins[0], ins[4]
        batch = gate_preds.dims[0].size
        dims = (_carry(gate_preds.dims[0], batch), _carry(expert0.dims[-1]))
        return (Shape(dims, expert0.dtype, expert0.replica),)


@dataclasses.dataclass(frozen=True)
class AggregateSpecAttrs(AggregateAttrs):
    """Speculative aggregate: every (sample, choice) slot's expert output
    as its own row, (batch * k, dim), for a loss over repeated labels."""

    def infer(self, *ins: Shape):
        gate_preds, expert0 = ins[0], ins[4]
        batch, k = gate_preds.dims[0].size, gate_preds.dims[-1].size
        dims = (ParallelDim(batch * k), _carry(expert0.dims[-1]))
        return (Shape(dims, expert0.dtype, expert0.replica),)


EXPERT_DISPATCHES = ("sort", "dense")


@dataclasses.dataclass(frozen=True)
class ExpertsAttrs(OpAttrs):
    """Fused MoE FFN bank: top-k gate -> capacity dispatch -> two-layer
    expert FFN over stacked weights -> weighted combine. Inputs: tokens
    (..., dim), gate logits (..., n_experts). Output: (..., out_dim).
    `normalize` renormalizes the top-k gate probabilities to sum 1
    (Mixtral's convention); `dispatch` "sort" routes rows by a token sort
    into a static (n * cap, dim) buffer, "dense" by one-hot matmuls (the
    numerics oracle)."""

    n_experts: int
    k: int
    hidden_dim: int
    out_dim: int
    alpha: float = 1.0
    activation: ActiMode = ActiMode.GELU
    lambda_bal: float = 1e-2
    normalize: bool = True
    dispatch: str = "sort"

    def capacity(self, batch: int) -> int:
        return moe_capacity(batch, self.k, self.alpha, self.n_experts)

    def infer(self, x: Shape, gate: Shape):
        dims = (tuple(_carry(d) for d in x.dims[:-1])
                + (ParallelDim(self.out_dim),))
        return (Shape(dims, x.dtype, x.replica),)

    def weights(self, x: Shape, gate: Shape):
        dim, dt, n = x.dims[-1].size, x.dtype, self.n_experts
        return {
            "w1": WeightSpec(TensorShape((n, dim, self.hidden_dim), dt)),
            "w2": WeightSpec(TensorShape((n, self.hidden_dim, self.out_dim),
                                         dt)),
        }
