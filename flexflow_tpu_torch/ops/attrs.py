"""Attribute dataclasses of the ported operators (counterpart of
flexflow_tpu/ops/attrs.py): INPUT, WEIGHT, EMBEDDING, RMS_NORM,
LAYER_NORM, LINEAR, ELEMENT_BINARY, ELEMENT_UNARY, SOFTMAX,
MULTIHEAD_ATTENTION, RING_ATTENTION, TOPK, the MoE ops (GROUP_BY,
AGGREGATE, AGGREGATE_SPEC, EXPERTS), the CNN ops (CONV2D, POOL2D,
BATCH_NORM), DROPOUT, the shape ops (FLAT, RESHAPE, TRANSPOSE, REVERSE,
CONCAT, SPLIT, CAST), BATCH_MATMUL, GATHER, REDUCE_SUM, MEAN, LSTM, CACHE
and the PIPELINE composite.

Field names, order and defaults match the reference, so `repr(attrs)` —
and with it Graph.structure_hash — agrees between the two packages, and
the weight specs keep the JAX layouts: `kernel` (in, out), `wq` (E, H, D),
`wk`/`wv` (E, Hkv, D), `wo` (H, D, E), `scale`, `bias`, `weight`, the
experts' `w1` (n, dim, hidden) and `w2` (n, hidden, out), a conv's
`kernel` (out, in / groups, kh, kw), BatchNorm's `scale`, `bias` and its
non-trainable `running_mean` / `running_var` (C,), LSTM's `wx` (in, 4H),
`wh` (H, 4H) and `bias` (4H,), gates in the order i, f, g, o, and
PIPELINE's `ln1`, `wq`, `wk`, `wv`, `wo`, `ln2`, `gate`, `up` and `down`
in the same layouts with a leading layer dim L.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType, PoolType
from flexflow_tpu_torch.ops.base import (
    OpAttrs,
    WeightSpec,
    broadcast_dims,
    elementwise_like,
    fresh,
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


# ---------------------------------------------------------------------------
# conv / pool / BatchNorm / dropout


@dataclasses.dataclass(frozen=True)
class Conv2DAttrs(OpAttrs):
    """2-D convolution, NCHW input, OIHW kernel (out, in / groups, kh,
    kw), symmetric padding per spatial dim."""

    out_channels: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    groups: int = 1
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE

    def infer(self, x: Shape):
        n, c, h, w = (d.size for d in x.dims)
        oh = (h + 2 * self.padding[0] - self.kernel[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel[1]) // self.stride[1] + 1
        dims = (_carry(x.dims[0]), ParallelDim(self.out_channels),
                ParallelDim(oh), ParallelDim(ow))
        return (Shape(dims, x.dtype, x.replica),)

    def weights(self, x: Shape):
        cin = x.dims[1].size
        w = {"kernel": WeightSpec(TensorShape(
            (self.out_channels, cin // self.groups, *self.kernel), x.dtype))}
        if self.use_bias:
            w["bias"] = WeightSpec(TensorShape((self.out_channels,), x.dtype),
                                   "zeros")
        return w


@dataclasses.dataclass(frozen=True)
class Pool2DAttrs(OpAttrs):
    """Max or average pooling over NCHW's spatial dims."""

    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    padding: Tuple[int, int] = (0, 0)
    pool_type: PoolType = PoolType.MAX
    activation: ActiMode = ActiMode.NONE

    def infer(self, x: Shape):
        n, c, h, w = (d.size for d in x.dims)
        oh = (h + 2 * self.padding[0] - self.kernel[0]) // self.stride[0] + 1
        ow = (w + 2 * self.padding[1] - self.kernel[1]) // self.stride[1] + 1
        dims = (_carry(x.dims[0]), _carry(x.dims[1]), ParallelDim(oh),
                ParallelDim(ow))
        return (Shape(dims, x.dtype, x.replica),)


@dataclasses.dataclass(frozen=True)
class BatchNormAttrs(OpAttrs):
    """BatchNorm over the channel dim of NCHW. The running statistics are
    non-trainable weights the train step updates (LowerCtx.state_updates)."""

    relu: bool = False
    momentum: float = 0.1
    eps: float = 1e-5

    def infer(self, x: Shape):
        return (elementwise_like(x),)

    def weights(self, x: Shape):
        c = TensorShape((x.dims[1].size,), x.dtype)
        return {
            "scale": WeightSpec(c, "ones"),
            "bias": WeightSpec(c, "zeros"),
            "running_mean": WeightSpec(c, "zeros", trainable=False),
            "running_var": WeightSpec(c, "ones", trainable=False),
        }


@dataclasses.dataclass(frozen=True)
class DropoutAttrs(OpAttrs):
    rate: float
    seed: int = 0

    def infer(self, x: Shape):
        return (elementwise_like(x),)


# ---------------------------------------------------------------------------
# shape ops


@dataclasses.dataclass(frozen=True)
class ReshapeAttrs(OpAttrs):
    shape: Tuple[int, ...]

    def infer(self, x: Shape):
        if math.prod(self.shape) != x.to_shape().num_elements():
            raise ValueError(f"reshape {x} -> {self.shape}: element count "
                             "mismatch")
        return (fresh(self.shape, x.dtype),)


@dataclasses.dataclass(frozen=True)
class FlatAttrs(OpAttrs):
    """Flatten all non-batch dims."""

    def infer(self, x: Shape):
        rest = math.prod(d.size for d in x.dims[1:])
        return (Shape((_carry(x.dims[0]), ParallelDim(rest)), x.dtype,
                      x.replica),)


@dataclasses.dataclass(frozen=True)
class TransposeAttrs(OpAttrs):
    perm: Tuple[int, ...]

    def infer(self, x: Shape):
        dims = tuple(_carry(x.dims[p]) for p in self.perm)
        return (Shape(dims, x.dtype, x.replica),)


@dataclasses.dataclass(frozen=True)
class ReverseAttrs(OpAttrs):
    axis: int

    def infer(self, x: Shape):
        return (elementwise_like(x),)


@dataclasses.dataclass(frozen=True)
class ConcatAttrs(OpAttrs):
    axis: int

    def infer(self, *ins: Shape):
        ax = self.axis % ins[0].ndim
        total = sum(s.dims[ax].size for s in ins)
        dims = tuple(ParallelDim(total) if i == ax else _carry(d)
                     for i, d in enumerate(ins[0].dims))
        return (Shape(dims, ins[0].dtype, ins[0].replica),)


@dataclasses.dataclass(frozen=True)
class SplitAttrs(OpAttrs):
    sizes: Tuple[int, ...]
    axis: int

    def infer(self, x: Shape):
        ax = self.axis % x.ndim
        return tuple(
            Shape(tuple(ParallelDim(sz) if i == ax else _carry(d)
                        for i, d in enumerate(x.dims)), x.dtype, x.replica)
            for sz in self.sizes)


@dataclasses.dataclass(frozen=True)
class CastAttrs(OpAttrs):
    dtype: DataType

    def infer(self, x: Shape):
        return (elementwise_like(x, self.dtype),)


# ---------------------------------------------------------------------------
# batch matmul / gather / reduce / LSTM


@dataclasses.dataclass(frozen=True)
class BatchMatmulAttrs(OpAttrs):
    """(b..., m, k) @ (b..., k, n); a_seq_length_dim / b_seq_length_dim
    (>= 0) name the dims FFConfig.seq_length truncates."""

    a_seq_length_dim: int = -1
    b_seq_length_dim: int = -1

    def infer(self, a: Shape, b: Shape):
        if a.ndim != b.ndim or a.ndim < 2:
            raise ValueError(f"batch_matmul rank mismatch: {a} vs {b}")
        if a.dims[-1].size != b.dims[-2].size:
            raise ValueError(f"batch_matmul inner dim mismatch: {a} vs {b}")
        dims = tuple(_carry(d) for d in a.dims[:-1]) + (_carry(b.dims[-1]),)
        return (Shape(dims, a.dtype, a.replica),)


@dataclasses.dataclass(frozen=True)
class GatherAttrs(OpAttrs):
    """torch.gather semantics along `axis`: the output has the index's
    shape."""

    axis: int

    def infer(self, x: Shape, index: Shape):
        return (Shape(tuple(_carry(d) for d in index.dims), x.dtype,
                      x.replica),)


@dataclasses.dataclass(frozen=True)
class ReduceAttrs(OpAttrs):
    """reduce_sum (`kind` "sum") or mean ("mean") over `axes`."""

    kind: str
    axes: Tuple[int, ...]
    keepdims: bool = False

    def infer(self, x: Shape):
        for a in self.axes:
            if not -x.ndim <= a < x.ndim:
                raise ValueError(
                    f"reduce axis {a} out of range for {x.ndim}-D input")
        ax = {a % x.ndim for a in self.axes}
        dims = []
        for i, d in enumerate(x.dims):
            if i in ax:
                if self.keepdims:
                    dims.append(ParallelDim(1))
            else:
                dims.append(_carry(d))
        return (Shape(tuple(dims), x.dtype, x.replica),)


@dataclasses.dataclass(frozen=True)
class LSTMAttrs(OpAttrs):
    """One LSTM layer over a whole sequence. Inputs: x (batch, seq, in)
    [, h0 (batch, hidden), c0 (batch, hidden)]. Outputs: y (batch, seq,
    hidden), h_n and c_n (batch, hidden). Gates i, f, g, o: `wx` and `wh`
    are torch.nn.LSTM's weight_ih / weight_hh transposed, `bias` its
    b_ih + b_hh."""

    hidden: int
    use_bias: bool = True
    reverse: bool = False

    def infer(self, x: Shape, h0: Optional[Shape] = None,
              c0: Optional[Shape] = None):
        if x.ndim != 3:
            raise ValueError(f"lstm expects (batch, seq, in_dim), got {x}")
        for nm, st in (("h0", h0), ("c0", c0)):
            if st is None:
                continue
            if st.ndim != 2 or st.dims[0].size != x.dims[0].size \
                    or st.dims[1].size != self.hidden:
                raise ValueError(
                    f"lstm initial state {nm} must be (batch="
                    f"{x.dims[0].size}, hidden={self.hidden}), got {st}")
        b, s = x.dims[0], x.dims[1]
        h = ParallelDim(self.hidden)
        y = Shape((_carry(b), ParallelDim(s.size), h), x.dtype, x.replica)
        state = Shape((_carry(b), h), x.dtype, x.replica)
        return (y, state, state)

    def weights(self, x: Shape, *state):
        in_dim = x.dims[-1].size
        w = {
            "wx": WeightSpec(TensorShape((in_dim, 4 * self.hidden),
                                         x.dtype)),
            "wh": WeightSpec(TensorShape((self.hidden, 4 * self.hidden),
                                         x.dtype)),
        }
        if self.use_bias:
            w["bias"] = WeightSpec(TensorShape((4 * self.hidden,), x.dtype),
                                   "zeros")
        return w


@dataclasses.dataclass(frozen=True)
class CacheAttrs(OpAttrs):
    """Activation cache: a non-trainable buffer of the input, written by
    every training step and read back outside training (FFModel.cache,
    FFModel.cache_score)."""

    def infer(self, x: Shape):
        return (elementwise_like(x),)

    def weights(self, x: Shape):
        return {"cached": WeightSpec(x.to_shape(), "zeros", trainable=False)}


@dataclasses.dataclass(frozen=True)
class PipelineAttrs(OpAttrs):
    """`layers` identical Llama decoder blocks (RMSNorm -> GQA attention
    with RoPE -> RMSNorm -> SwiGLU MLP) as one composite, their weights
    STACKED on a leading layer dim. On one device the lowering runs the
    blocks in turn (ops/torch_ops.py _pipeline); `n_microbatches` is the
    GPipe schedule's, which needs a `pipe` mesh axis, and has no effect
    there, as in the reference without one."""

    layers: int
    heads: int
    kv_heads: int
    hidden: int
    n_microbatches: int = 4
    causal: bool = True
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5

    def infer(self, x: Shape):
        return (elementwise_like(x),)

    def weights(self, x: Shape):
        dim = x.dims[-1].size
        hd = dim // self.heads
        dt = x.dtype
        L = self.layers

        def w(*shape):
            return WeightSpec(TensorShape((L,) + shape, dt))

        return {
            "ln1": WeightSpec(TensorShape((L, dim), dt), "ones"),
            "wq": w(dim, self.heads, hd),
            "wk": w(dim, self.kv_heads, hd),
            "wv": w(dim, self.kv_heads, hd),
            "wo": w(self.heads, hd, dim),
            "ln2": WeightSpec(TensorShape((L, dim), dt), "ones"),
            "gate": w(dim, self.hidden),
            "up": w(dim, self.hidden),
            "down": w(self.hidden, dim),
        }

    def flops(self, ins, outs):
        """Matmul FLOPs of one forward: the projections and the MLP at
        2 a multiply-add, and QK^T + PV at causal half density."""
        x = ins[0]
        tokens = math.prod(d.size for d in x.dims[:-1])
        seq = x.dims[-2].size if x.ndim >= 2 else 1
        dim = x.dims[-1].size
        hd = dim // self.heads
        per_layer = (
            dim * self.heads * hd
            + 2 * dim * self.kv_heads * hd
            + self.heads * hd * dim
            + 3 * dim * self.hidden
        )
        dense = 2 * tokens * per_layer
        attn = 2 * tokens * seq * dim
        return self.layers * (dense + attn)
