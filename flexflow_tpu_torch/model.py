"""FFModel — the central user-facing model object (counterpart of
flexflow_tpu/model.py).

Layer-building methods record a lazy PCG exactly as the JAX package's do
(same node names, guids and attrs); `compile()` infers shapes, builds the
eager Executor on the configured device and draws the parameters there;
`fit`, `eval` and `predict` train and run the model on numpy batches;
`generate` decodes through a dense KV cache; `serve` starts the batch
server (the dynamic batcher); `serve_generation` starts a
continuous-batching server, dense by default or paged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch.config import TRANSFER_GUARDS, FFConfig
from flexflow_tpu_torch.ffconst import (
    ActiMode,
    AggrMode,
    DataType,
    LossType,
    MetricsType,
    OpType,
    ParamSyncType,
    PoolType,
)
from flexflow_tpu_torch.ops import attrs as A
from flexflow_tpu_torch.parallel.mesh import Mesh, make_mesh, process_count
from flexflow_tpu_torch.parallel.sharding import ShardingView
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.pcg.tensor import TensorShape
from flexflow_tpu_torch.runtime.executor import Executor
from flexflow_tpu_torch.runtime.metrics import LOSS_KEYS, PerfMetrics
from flexflow_tpu_torch.runtime.optimizer import Optimizer, SGDOptimizer


@dataclasses.dataclass
class Tensor:
    """Frontend tensor handle: points at a graph node output."""

    node: Node
    idx: int = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.node.outputs[self.idx].dims)

    @property
    def dtype(self) -> DataType:
        return self.node.outputs[self.idx].dtype

    def __repr__(self):
        return f"Tensor({self.node.name}:{self.idx} {self.shape})"


_MERGED = "_merged"


def carry_params(params, built: Graph, graph: Graph):
    """Re-key (trainable, nontrainable) trees made for the graph as built
    to `graph`, a rewrite of it by the strategy search. A node the rewrite
    kept keeps its key and weights; a linear that merge_parallel_linears
    made of several bias-free ones ("{a}_{b}_merged") takes their kernels
    concatenated on the out dim in its name's order (the rule's weight
    map), so the rewritten graph computes the same function. Any other
    weighted node the built graph lacks raises."""
    tr, ntr = params
    linears = {n.name: n.stable_key() for n in built.nodes
               if n.op_type == OpType.LINEAR}

    def kernel(name: str):
        if name in linears:
            return tr[linears[name]]["kernel"]
        parts = split(name[:-len(_MERGED)]) if name.endswith(_MERGED) \
            else None
        if not parts:
            return None
        return torch.cat([kernel(p) for p in parts], dim=-1)

    def split(stem: str):
        # the names of the merged linears, each a built linear or itself
        # a merge, joined by "_"
        for i in range(len(stem), 0, -1):
            head, rest = stem[:i], stem[i + 1:]
            if head in linears or (head.endswith(_MERGED)
                                   and kernel(head) is not None):
                if i == len(stem):
                    return [head]
                if stem[i] == "_" and (tail := split(rest)):
                    return [head] + tail
        return None

    out_tr, out_ntr = {}, {}
    for node in graph.nodes:
        key = node.stable_key()
        if key in tr or key in ntr:
            for src, dst in ((tr, out_tr), (ntr, out_ntr)):
                if key in src:
                    dst[key] = src[key]
            continue
        if node.attrs is None or not node.attrs.weights(*node.in_shapes):
            continue
        k = kernel(node.name) if node.op_type == OpType.LINEAR else None
        if k is None:
            raise ValueError(
                f"params hold no weights for {key!r}, which the strategy "
                "search's rewrite made, and none to carry to it")
        out_tr[key] = {"kernel": k}
    return out_tr, out_ntr


class FFModel:
    """Build a layer graph, compile it for its device (one process per
    card on a mesh of several), train or serve it."""

    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.graph = Graph()
        self._executor: Optional[Executor] = None
        self._mesh: Optional[Mesh] = None
        # the process mesh (parallel/spmd.ProcessMesh) when the mesh spans
        # several processes
        self._pmesh = None
        self._params = None  # (trainable, nontrainable)
        self._opt_state = None
        self._optimizer: Optional[Optimizer] = None
        self._loss_type = LossType.SPARSE_CATEGORICAL_CROSSENTROPY
        self._metrics: List[MetricsType] = []
        self._step_count = 0
        # each fit call draws from a fresh stream, config.seed + 1 + the
        # calls before it, as the reference's fit does
        self._fit_calls = 0
        # fit traces written under config.profiler_trace_dir
        self._profiler_traces = 0
        self.current_metrics: Optional[PerfMetrics] = None
        self._used_names: set = set()
        # node key -> weight name -> Initializer, from the layer methods'
        # initializer arguments (init_params draws these leaves from them)
        self._init_overrides: Dict[str, Dict] = {}
        # cache node name -> score function, and the buffer cache_score
        # last compared against
        self._cache_scores: Dict[str, object] = {}
        self._cache_snapshots: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    # graph building helpers

    def _add(self, op_type: OpType, op_attrs, inputs: Sequence[Tensor],
             name: Optional[str]) -> Node:
        name = name or op_type.value
        # node names are unique: parameters are keyed by name + guid
        if name in self._used_names:
            base = name
            while name in self._used_names:
                name = f"{base}_{self.graph.new_guid()}"
        self._used_names.add(name)
        node = self.graph.create_node(op_type, op_attrs, name)
        for i, t in enumerate(inputs):
            self.graph.add_edge(t.node, node, t.idx, i)
        node.outputs = tuple(
            op_attrs.infer(*[t.node.outputs[t.idx] for t in inputs]))
        return node

    def _one(self, op_type, op_attrs, inputs, name) -> Tensor:
        return Tensor(self._add(op_type, op_attrs, inputs, name))

    def _record_init(self, node: Node, **inits):
        """Record a layer method's initializer arguments (None keeps the
        weight's default) for compile() to draw from."""
        d = {k: v for k, v in inits.items() if v is not None}
        if d:
            self._init_overrides[node.stable_key()] = d

    def create_weight(self, dims: Sequence[int],
                      dtype: DataType = DataType.FLOAT, initializer=None,
                      name: Optional[str] = None) -> Tensor:
        """A standalone weight as a graph source (glorot_uniform, as the
        reference draws it, unless an `initializer` is given)."""
        node = self._add(OpType.WEIGHT,
                         A.WeightAttrs(TensorShape(tuple(dims), dtype)), [],
                         name or "weight")
        self._record_init(node, weight=initializer)
        return Tensor(node)

    # ------------------------------------------------------------------
    # layers (the reference's layer methods, with its signatures)

    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.FLOAT,
                      name: Optional[str] = None) -> Tensor:
        shape = TensorShape(tuple(dims), dtype)
        return self._one(OpType.INPUT, A.InputAttrs(shape), [],
                         name or "input")

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.NONE, use_bias: bool = True,
              kernel_initializer=None, bias_initializer=None,
              name: Optional[str] = None) -> Tensor:
        node = self._add(
            OpType.LINEAR,
            A.LinearAttrs(out_dim, use_bias, ActiMode.coerce(activation)),
            [input], name or "dense")
        self._record_init(node, kernel=kernel_initializer,
                          bias=bias_initializer)
        return Tensor(node)

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int = 1, stride_w: int = 1,
               padding_h: int = 0, padding_w: int = 0,
               activation: ActiMode = ActiMode.NONE, groups: int = 1,
               use_bias: bool = True, kernel_initializer=None,
               bias_initializer=None, name: Optional[str] = None) -> Tensor:
        """2-D convolution of an NCHW tensor, OIHW kernel."""
        node = self._add(
            OpType.CONV2D,
            A.Conv2DAttrs(out_channels, (kernel_h, kernel_w),
                          (stride_h, stride_w), (padding_h, padding_w),
                          groups, use_bias, ActiMode.coerce(activation)),
            [input], name or "conv2d")
        self._record_init(node, kernel=kernel_initializer,
                          bias=bias_initializer)
        return Tensor(node)

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int = 0,
               padding_w: int = 0, pool_type: PoolType = PoolType.MAX,
               activation: ActiMode = ActiMode.NONE,
               name: Optional[str] = None) -> Tensor:
        return self._one(
            OpType.POOL2D,
            A.Pool2DAttrs((kernel_h, kernel_w), (stride_h, stride_w),
                          (padding_h, padding_w), PoolType.coerce(pool_type),
                          ActiMode.coerce(activation)),
            [input], name or "pool2d")

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.NONE,
                  dtype: DataType = DataType.FLOAT, kernel_initializer=None,
                  name: Optional[str] = None) -> Tensor:
        node = self._add(
            OpType.EMBEDDING,
            A.EmbeddingAttrs(num_entries, out_dim, AggrMode.coerce(aggr),
                             dtype),
            [input], name or "embedding")
        self._record_init(node, kernel=kernel_initializer)
        return Tensor(node)

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, causal: bool = False,
                            kv_heads: Optional[int] = None,
                            rope: bool = False, rope_theta: float = 10000.0,
                            kernel_initializer=None,
                            name: Optional[str] = None) -> Tensor:
        node = self._add(
            OpType.MULTIHEAD_ATTENTION,
            A.MultiHeadAttentionAttrs(
                embed_dim, num_heads, kv_heads,
                kdim // num_heads if kdim else None, causal, bias, dropout,
                rope, rope_theta),
            [query, key, value], name or "attention")
        self._record_init(node, wq=kernel_initializer, wk=kernel_initializer,
                          wv=kernel_initializer, wo=kernel_initializer)
        return Tensor(node)

    def ring_attention(self, query: Tensor, key: Tensor, value: Tensor,
                       embed_dim: int, num_heads: int, causal: bool = True,
                       kv_heads: Optional[int] = None, rope: bool = False,
                       rope_theta: float = 10000.0, seq_mode: str = "ring",
                       name: Optional[str] = None) -> Tensor:
        """Sequence-parallel attention: MULTIHEAD_ATTENTION's weights
        (no biases) with the sequence cut over the mesh's `seq` axis
        (parallel/ring.py), exchanged as a ring or, with
        seq_mode="ulysses", by the all-to-all of sequence for heads."""
        return self._one(
            OpType.RING_ATTENTION,
            A.RingAttentionAttrs(embed_dim, num_heads, kv_heads, None, causal,
                                 False, 0.0, rope, rope_theta, seq_mode),
            [query, key, value], name or "ring_attention")

    def ulysses_attention(self, query: Tensor, key: Tensor, value: Tensor,
                          embed_dim: int, num_heads: int, causal: bool = True,
                          kv_heads: Optional[int] = None, rope: bool = False,
                          rope_theta: float = 10000.0,
                          name: Optional[str] = None) -> Tensor:
        """DeepSpeed-Ulysses sequence parallelism: ring_attention with
        seq_mode="ulysses"."""
        return self.ring_attention(
            query, key, value, embed_dim, num_heads, causal=causal,
            kv_heads=kv_heads, rope=rope, rope_theta=rope_theta,
            seq_mode="ulysses", name=name or "ulysses_attention")

    def _binary(self, kind: str, x: Tensor, y: Tensor, name) -> Tensor:
        return self._one(OpType.ELEMENT_BINARY, A.ElementBinaryAttrs(kind),
                         [x, y], name or kind)

    def add(self, x, y, name=None):
        return self._binary("add", x, y, name)

    def add_position_embedding(self, x, table, name=None):
        """Add a learned absolute-position row table (seq_len, dim) onto
        (batch, seq, dim) activations, as an add MARKED as a position
        table: under a KV cache the lowering takes the table rows at the
        cache positions, and the servers refuse lengths beyond the table
        (GPT-2/BERT-style positions)."""
        return self._one(OpType.ELEMENT_BINARY,
                         A.ElementBinaryAttrs("add", position_table=True),
                         [x, table], name or "add_pos")

    def subtract(self, x, y, name=None):
        return self._binary("subtract", x, y, name)

    def multiply(self, x, y, name=None):
        return self._binary("multiply", x, y, name)

    def divide(self, x, y, name=None):
        return self._binary("divide", x, y, name)

    def max(self, x, y, name=None):
        return self._binary("max", x, y, name)

    def min(self, x, y, name=None):
        return self._binary("min", x, y, name)

    def batch_matmul(self, a: Tensor, b: Tensor, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name=None) -> Tensor:
        return self._one(
            OpType.BATCH_MATMUL,
            A.BatchMatmulAttrs(a_seq_length_dim, b_seq_length_dim), [a, b],
            name or "batch_matmul")

    # ---- elementwise unary ----

    def _unary(self, kind: str, x: Tensor, name, scalar: float = 0.0,
               inplace: bool = False) -> Tensor:
        return self._one(OpType.ELEMENT_UNARY,
                         A.ElementUnaryAttrs(kind, scalar, inplace), [x],
                         name or kind)

    def silu(self, x, name=None):
        return self._unary("silu", x, name)

    def exp(self, x, name=None):
        return self._unary("exp", x, name)

    def sin(self, x, name=None):
        return self._unary("sin", x, name)

    def cos(self, x, name=None):
        return self._unary("cos", x, name)

    def relu(self, x, inplace: bool = True, name=None):
        return self._unary("relu", x, name, inplace=inplace)

    def gelu(self, x, name=None):
        return self._unary("gelu", x, name)

    def sigmoid(self, x, name=None):
        return self._unary("sigmoid", x, name)

    def tanh(self, x, name=None):
        return self._unary("tanh", x, name)

    def elu(self, x, name=None):
        return self._unary("elu", x, name)

    def rsqrt(self, x, name=None):
        return self._unary("rsqrt", x, name)

    def pow(self, x, exponent: float, name=None):
        return self._unary("pow", x, name, scalar=exponent)

    def identity(self, x, name=None):
        return self._unary("identity", x, name)

    def scalar_add(self, x, scalar: float, name=None):
        return self._unary("scalar_add", x, name, scalar=scalar)

    def scalar_sub(self, x, scalar: float, name=None):
        return self._unary("scalar_sub", x, name, scalar=scalar)

    def scalar_multiply(self, x, scalar: float, name=None):
        return self._unary("scalar_multiply", x, name, scalar=scalar)

    def scalar_true_divide(self, x, scalar: float, name=None):
        return self._unary("scalar_truediv", x, name, scalar=scalar)

    # ---- shape ----

    def reshape(self, input: Tensor, shape: Sequence[int],
                name=None) -> Tensor:
        return self._one(OpType.RESHAPE, A.ReshapeAttrs(tuple(shape)),
                         [input], name or "reshape")

    def flat(self, input: Tensor, name=None) -> Tensor:
        return self._one(OpType.FLAT, A.FlatAttrs(), [input], name or "flat")

    def transpose(self, input: Tensor, perm: Sequence[int],
                  name=None) -> Tensor:
        return self._one(OpType.TRANSPOSE, A.TransposeAttrs(tuple(perm)),
                         [input], name or "transpose")

    def reverse(self, input: Tensor, axis: int, name=None) -> Tensor:
        return self._one(OpType.REVERSE, A.ReverseAttrs(axis), [input],
                         name or "reverse")

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name=None) -> Tensor:
        # normalised, as the reference does, so -1 and ndim - 1 give
        # equal attrs
        axis = axis % len(tensors[0].shape)
        return self._one(OpType.CONCAT, A.ConcatAttrs(axis), list(tensors),
                         name or "concat")

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]],
              axis: int, name=None) -> List[Tensor]:
        """Pieces of `input` along `axis`: `sizes` a list of lengths, or
        the number of equal pieces."""
        axis = axis % len(input.shape)
        if isinstance(sizes, int):
            sizes = [input.shape[axis] // sizes] * sizes
        node = self._add(OpType.SPLIT, A.SplitAttrs(tuple(sizes), axis),
                         [input], name or "split")
        return [Tensor(node, i) for i in range(len(sizes))]

    def cast(self, input: Tensor, dtype: DataType, name=None) -> Tensor:
        return self._one(OpType.CAST, A.CastAttrs(dtype), [input],
                         name or "cast")

    def layer_norm(self, input: Tensor, axes: Sequence[int] = (-1,),
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name=None) -> Tensor:
        return self._one(
            OpType.LAYER_NORM,
            A.LayerNormAttrs(tuple(axes), elementwise_affine, eps),
            [input], name or "layer_norm")

    def rms_norm(self, input: Tensor, eps: float = 1e-6, name=None) -> Tensor:
        return self._one(OpType.RMS_NORM, A.RMSNormAttrs(eps), [input],
                         name or "rms_norm")

    def softmax(self, input: Tensor, axis: int = -1, name=None) -> Tensor:
        return self._one(OpType.SOFTMAX, A.SoftmaxAttrs(axis), [input],
                         name or "softmax")

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name=None) -> Tensor:
        """BatchNorm over NCHW's channels; its running statistics are
        non-trainable weights the train step moves."""
        return self._one(OpType.BATCH_NORM, A.BatchNormAttrs(relu), [input],
                         name or "batch_norm")

    def dropout(self, input: Tensor, rate: float, seed: int = 0,
                name=None) -> Tensor:
        """Dropout in training (the node's own random stream; `seed` is
        kept in the attrs as the reference keeps it); identity in eval
        and predict."""
        return self._one(OpType.DROPOUT, A.DropoutAttrs(rate, seed), [input],
                         name or "dropout")

    # ---- gather / reduce ----

    def gather(self, input: Tensor, index: Tensor, axis: int,
               name=None) -> Tensor:
        return self._one(OpType.GATHER, A.GatherAttrs(axis), [input, index],
                         name or "gather")

    def reduce_sum(self, input: Tensor, axes: Sequence[int],
                   keepdims: bool = False, name=None) -> Tensor:
        return self._one(OpType.REDUCE_SUM,
                         A.ReduceAttrs("sum", tuple(axes), keepdims),
                         [input], name or "reduce_sum")

    def mean(self, input: Tensor, axes: Sequence[int],
             keepdims: bool = False, name=None) -> Tensor:
        return self._one(OpType.MEAN,
                         A.ReduceAttrs("mean", tuple(axes), keepdims),
                         [input], name or "mean")

    # ---- recurrent ----

    def lstm(self, input: Tensor, hidden: int,
             initial_state: Optional[Tuple[Tensor, Tensor]] = None,
             use_bias: bool = True, reverse: bool = False,
             name=None) -> Tuple[Tensor, Tensor, Tensor]:
        """One LSTM layer over a (batch, seq, dim) sequence -> (outputs,
        h_n, c_n); `initial_state` (h0, c0) wires a decoder to an
        encoder's final state."""
        ins = [input] + (list(initial_state) if initial_state else [])
        node = self._add(OpType.LSTM, A.LSTMAttrs(hidden, use_bias, reverse),
                         ins, name or "lstm")
        return Tensor(node, 0), Tensor(node, 1), Tensor(node, 2)

    def top_k(self, input: Tensor, k: int, sorted: bool = True,
              name=None) -> Tuple[Tensor, Tensor]:
        """(values, int32 indices) of the k largest entries of the last
        dim; on ties the lower index first."""
        node = self._add(OpType.TOPK, A.TopKAttrs(k, sorted), [input],
                         name or "topk")
        return Tensor(node, 0), Tensor(node, 1)

    # ---- MoE ----

    def group_by(self, input: Tensor, assign: Tensor, n: int, alpha: float,
                 name=None) -> List[Tensor]:
        node = self._add(OpType.GROUP_BY, A.GroupByAttrs(n, alpha),
                         [input, assign], name or "group_by")
        return [Tensor(node, i) for i in range(n)]

    def aggregate(self, inputs: Sequence[Tensor], n: int,
                  lambda_bal: float = 0.0, name=None) -> Tensor:
        return self._one(OpType.AGGREGATE, A.AggregateAttrs(n, lambda_bal),
                         list(inputs), name or "aggregate")

    def aggregate_spec(self, inputs: Sequence[Tensor], n: int,
                       lambda_bal: float = 0.0, name=None) -> Tensor:
        return self._one(OpType.AGGREGATE_SPEC,
                         A.AggregateSpecAttrs(n, lambda_bal), list(inputs),
                         name or "aggregate_spec")

    def experts(self, input: Tensor, gate: Tensor, n_experts: int, k: int,
                hidden_dim: int, out_dim: int, alpha: float = 1.0,
                activation: ActiMode = ActiMode.GELU,
                lambda_bal: float = 1e-2, dispatch: str = "sort",
                name=None) -> Tensor:
        """The fused MoE FFN bank over gate logits `gate` (ops/torch_ops.py
        _experts)."""
        return self._one(
            OpType.EXPERTS,
            A.ExpertsAttrs(n_experts, k, hidden_dim, out_dim, alpha,
                           ActiMode.coerce(activation), lambda_bal,
                           dispatch=dispatch),
            [input, gate], name or "experts")

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.04, name=None) -> Tensor:
        """Composite MoE layer: gate dense -> softmax -> top-k -> group_by
        -> a ReLU dense per expert -> aggregate."""
        base = name or "moe"
        gate_preds = self.dense(input, num_exp, name=f"{base}_gate")
        gate_sm = self.softmax(gate_preds, name=f"{base}_gate_sm")
        topk_values, topk_assign = self.top_k(gate_sm, num_select)
        grouped = self.group_by(input, topk_assign, num_exp, alpha)
        expert_outs = [self.dense(g, expert_hidden_size, ActiMode.RELU,
                                  name=f"{base}_expert{i}")
                       for i, g in enumerate(grouped)]
        return self.aggregate(
            [topk_values, topk_assign, topk_assign, gate_sm] + expert_outs,
            num_exp, lambda_bal, name=name)

    # ---- composites and the activation cache ----

    def pipeline(self, input: Tensor, layers: int, heads: int, kv_heads: int,
                 hidden: int, n_microbatches: int = 4, causal: bool = True,
                 rope_theta: float = 500000.0, norm_eps: float = 1e-5,
                 name=None) -> Tensor:
        """`layers` Llama decoder blocks as one composite, weights stacked
        on a leading layer dim (ops/torch_ops.py _pipeline: the blocks in
        turn on one device; `n_microbatches` belongs to the GPipe
        schedule, which needs a `pipe` mesh axis)."""
        return self._one(
            OpType.PIPELINE,
            A.PipelineAttrs(layers, heads, kv_heads, hidden, n_microbatches,
                            causal, rope_theta, norm_eps),
            [input], name or "pipeline")

    def cache(self, input: Tensor, score_func=None, name=None) -> Tensor:
        """Activation cache: every training step stores its input in a
        non-trainable buffer, which eval and predict return in its place;
        `score_func(old, new) -> float` is run on the host by
        cache_score(name)."""
        name = name or "cache"
        t = self._one(OpType.CACHE, A.CacheAttrs(), [input], name)
        if score_func is not None:
            self._cache_scores[t.node.name] = score_func
        return t

    def cache_score(self, name: str) -> float:
        """The cache's score function on (previous snapshot, current
        buffer), as numpy on the host; the current buffer becomes the
        next call's snapshot. 1.0 on the first call (nothing to compare);
        without a score function, the cosine similarity of the two."""
        node = next(n for n in self.graph.nodes if n.name == name)
        cur = self.get_weight(name, "cached")
        prev = self._cache_snapshots.get(name)
        self._cache_snapshots[name] = cur
        if prev is None:
            return 1.0
        fn = self._cache_scores.get(node.name)
        if fn is None:
            denom = float((prev * prev).sum() ** 0.5
                          * (cur * cur).sum() ** 0.5)
            return float((prev * cur).sum()) / max(denom, 1e-30)
        return float(fn(prev, cur))

    def position_table_rows(self) -> Optional[int]:
        """Rows of the smallest learned-position table in the graph, or
        None. The servers keep prompt + new tokens within it."""
        rows = None
        for n in self.graph.nodes:
            if getattr(n.attrs, "position_table", False):
                ins = self.graph.input_shapes(n)
                if len(ins) > 1:
                    r = ins[1].dims[0].size
                    rows = r if rows is None else min(rows, r)
        return rows

    # ------------------------------------------------------------------
    # compile / serve

    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: LossType = LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[MetricsType] = (), params=None,
                strategy: Optional[Dict[str, ShardingView]] = None):
        """Infer shapes, pick a strategy, build the executor on the
        configured device and draw the parameters there from
        `config.seed` — or, when `params` is given, take those
        (trainable, nontrainable) trees instead, moved to the device
        (e.g. runtime.weights.params_from_numpy's, or another FFModel's
        `_params`; copied when compiled to train).

        The strategy is `strategy` (node name -> ShardingView), else
        config.import_strategy_file's (checked against this graph and
        mesh by analysis/consistency.py), else, with config.search_budget
        > 0, the strategy search's (search/api.py): MCMC over views at a
        budget up to 5, the Unity substitution search above, which may
        rewrite the graph. With config.validate_top_k > 1 the top
        candidates' real train steps are timed on the device and the
        fastest is kept (`strategy_validation`). `params` is keyed by the
        graph as built: the weights of a linear the search merged with
        others (merge_parallel_linears) are theirs concatenated
        (carry_params). In one process every view computes whole
        tensors; on a mesh over several processes (data x model = the
        world size) each rank holds its shards: rank 0 searches and
        every rank takes its graph and strategy, and the given or drawn
        whole trees are cut to the rank's pieces.

        With an `optimizer` the model is compiled to train: every
        floating trainable leaf is an fp32 master (the reference's
        init_params) and the optimizer state is drawn now. Without one
        the weights keep their use-site dtypes, as serving needs, and
        `fit` trains with SGDOptimizer() (the reference's default),
        turning the trainable leaves into fp32 masters at its first
        step."""
        cfg = self.config
        device = cfg.torch_device()
        self._optimizer = optimizer or SGDOptimizer()
        self._loss_type = loss_type
        self._metrics = list(metrics)
        self.graph.infer_shapes()
        built = self.graph
        if cfg.perform_fusion:
            # reference --fusion / apply_fusion (model.cc:2965): fold
            # linear + activation pairs into one node before the search
            from flexflow_tpu_torch.search.substitution import (
                make_fuse_linear_activation,
            )

            xf = make_fuse_linear_activation()
            while cands := xf.apply_all(self.graph):
                self.graph = cands[0]
        # the reference's default mesh is {"data": devices}: one process
        # per card, so the world size
        from flexflow_tpu_torch.runtime import distributed as dist

        mesh_axes = dict(cfg.mesh_shape or {"data": dist.process_count()})
        if (cfg.enable_submesh and "data_sub" not in mesh_axes
                and mesh_axes.get("data", 1) >= 4
                and mesh_axes["data"] % 2 == 0):
            mesh_axes["data_sub"] = 2
            mesh_axes["data"] //= 2
        self._mesh = make_mesh(mesh_axes)
        axis_sizes = self._mesh.axes
        self._pmesh = None
        if process_count(axis_sizes) > 1:
            from flexflow_tpu_torch.parallel.spmd import ProcessMesh

            self._pmesh = ProcessMesh(axis_sizes)
        if strategy is None and cfg.import_strategy_file:
            strategy = self._import_strategy(cfg.import_strategy_file,
                                             axis_sizes)
        candidates: List = []
        self.search_stats = {}
        if (strategy is None and not cfg.only_data_parallel
                and cfg.search_budget > 0):
            from flexflow_tpu_torch.search import api

            collect = candidates if cfg.validate_top_k > 1 else None
            # several processes: rank 0 searches and every rank takes its
            # graph, strategy, statistics and playoff pool, so all ranks
            # run one program (the reference's GraphOptimalViewSerialized)
            if dist.process_index() == 0:
                if cfg.search_budget > 5:
                    self.graph, strategy = api.graph_optimize(
                        self.graph, axis_sizes, cfg, candidates_out=collect,
                        stats_out=self.search_stats)
                else:
                    strategy = api.search_strategy(
                        self.graph, axis_sizes, cfg, candidates_out=collect)
            if dist.is_multi_host():
                if cfg.search_budget > 5:
                    self.graph, strategy = dist.broadcast_graph(self.graph,
                                                                strategy)
                    self.search_stats = dist.broadcast_stats(
                        self.search_stats)
                else:
                    strategy = dist.broadcast_strategy(strategy)
                if collect is not None:
                    candidates[:] = dist.broadcast_candidates(candidates)
        # the full modeled pool (top-k + best-per-structural-class + the
        # unrewritten baseline) stays inspectable after compile
        self.searched_candidates = list(candidates)
        if len(candidates) > 1:
            from flexflow_tpu_torch.search.substitution import (
                structural_class,
            )

            # the timed pool: the top validate_top_k by modeled cost plus
            # every structural candidate past the cutoff
            picked = list(candidates[:cfg.validate_top_k])
            have = {id(g) for _, g, _ in picked}
            for cand in candidates[cfg.validate_top_k:]:
                if structural_class(cand[1]) and id(cand[1]) not in have:
                    picked.append(cand)
                    have.add(id(cand[1]))
            self.graph, strategy = self._validate_candidates(picked, device)
        self._apply_strategy(self.graph, strategy)
        self._executor = self._new_executor(device, optimizer)
        if params is None:
            tr, ntr = self._executor.init_params(self.config.seed,
                                                 self._init_overrides)
        else:
            if self.graph is not built:
                params = carry_params(params, built, self.graph)
            # training updates the weights in place: a model compiled to
            # train takes copies, so it never shares storage with the
            # trees it was given; on a process mesh each rank keeps its
            # pieces of the whole trees
            tr, ntr = self._executor.shard_params(*(
                {k: {n: t.to(device, copy=optimizer is not None)
                     for n, t in w.items()}
                 for k, w in tree.items()} for tree in params))
        self._opt_state = None
        if optimizer is not None:
            tr = self._executor.master_params(tr)
            self._opt_state = self._executor.init_opt_state(optimizer, tr)
        self._params = (tr, ntr)
        if cfg.export_strategy_file:
            self.export_strategy_file(cfg.export_strategy_file)
        if cfg.export_strategy_computation_graph_file:
            self._export_dot(cfg.export_strategy_computation_graph_file)
        return self

    def _import_strategy(self, path: str, axis_sizes: Dict[str, int]):
        """Read a strategy file (either package's export) and check it
        against this graph and mesh: an inconsistent file raises with
        each error by node; warnings are logged."""
        import json
        import logging

        from flexflow_tpu_torch.analysis.consistency import check_strategy
        from flexflow_tpu_torch.parallel.sharding import view_from_json

        with open(path) as f:
            strategy = {k: view_from_json(v) for k, v in json.load(f).items()}
        findings = check_strategy(self.graph, strategy, axis_sizes,
                                  subject=os.path.basename(path))
        errors = [f for f in findings if f.severity == "error"]
        if errors:
            detail = "\n".join(f"  [{f.code}] {f.where}: {f.message}"
                               for f in errors)
            raise ValueError(
                f"imported strategy file {path} is inconsistent with this "
                f"graph/mesh ({len(errors)} error(s)):\n{detail}")
        warned = [f.message for f in findings if f.severity == "warning"]
        if warned:
            logging.getLogger(__name__).warning(
                "imported strategy %s: %s", path, "; ".join(warned))
        return strategy

    def _apply_strategy(self, graph: Graph, strategy) -> None:
        """Attach the strategy's views to their nodes; an unnamed INPUT
        takes the batch-over-data view when the data axis exceeds 1 (never
        on one card), and where `seq` spans processes its dim 1 cut over
        `seq` too, so each rank is fed its block of the sequence."""
        from flexflow_tpu_torch.parallel.sharding import (
            data_batch_spec,
            group_degree,
        )

        axis_sizes = self._mesh.axes
        seq = (self._pmesh.live(("seq",)) if self._pmesh is not None
               else ())
        for n in graph.nodes:
            if strategy and n.name in strategy:
                n.sharding = strategy[n.name]
            elif n.op_type == OpType.INPUT:
                shape = n.outputs[0]
                spec = list(data_batch_spec(shape.ndim, shape.dims[0].size,
                                            axis_sizes))
                deg = group_degree(spec[0], axis_sizes)
                if deg <= 1 or shape.dims[0].size % deg:
                    spec[0] = ()
                if seq and shape.ndim >= 2 \
                        and shape.dims[1].size % axis_sizes["seq"] == 0:
                    spec[1] = seq
                if any(spec):
                    n.sharding = ShardingView((tuple(spec),))

    def _validate_candidates(self, candidates, device):
        """The timed playoff (the reference's _validate_candidates):
        each candidate's real train step runs on `device` from weights
        drawn at config.seed, on zero inputs and labels, once to warm up
        and three times timed (CUDA events on the card), and the fastest
        candidate wins. A candidate whose lowering refuses its shapes
        (ValueError, NotImplementedError) loses with a warning; any other
        failure, a kernel's build or launch among them, raises. Records
        the outcome in `strategy_validation`."""
        import time
        import warnings

        from flexflow_tpu_torch.runtime import distributed as dist

        results = []  # (seconds, modeled rank, graph, strategy)
        for rank, (modeled, graph, strategy) in enumerate(candidates):
            # candidates may share one Graph object: a private copy keeps
            # each candidate's node shardings to itself
            graph = graph.copy()
            self._apply_strategy(graph, strategy)
            ex = self._new_executor(device, self._optimizer, graph,
                                    donate=True)
            try:
                tr, ntr = ex.init_params(self.config.seed,
                                         self._init_overrides)
                tr = ex.master_params(tr)
                opt = ex.init_opt_state(self._optimizer, tr)
                inputs = [torch.zeros(
                    tuple(d.size for d in n.outputs[0].dims),
                    dtype=n.outputs[0].dtype.torch_dtype, device=device)
                    for n in ex.input_nodes]
                labels = torch.from_numpy(self._synth_labels(graph)).to(
                    device)
                if ex.pmesh is not None:
                    inputs = [ex.pmesh.shard(x, sp).contiguous() for x, sp
                              in zip(inputs, ex.input_specs())]
                    labels = ex.pmesh.shard(
                        labels, ex.label_spec(labels.ndim)).contiguous()
                tr, ntr, opt, m = ex.train_step(tr, ntr, opt, labels,
                                                *inputs)
                float(m["loss"])
                t0 = time.perf_counter()
                if device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                for _ in range(3):
                    tr, ntr, opt, m = ex.train_step(tr, ntr, opt, labels,
                                                    *inputs)
                if device.type == "cuda":
                    end.record()
                    end.synchronize()
                    dt = start.elapsed_time(end) / 1e3 / 3
                else:
                    float(m["loss"])
                    dt = (time.perf_counter() - t0) / 3
                results.append((dt, rank, graph, strategy))
            except (ValueError, NotImplementedError) as e:
                warnings.warn(f"strategy candidate failed validation: {e}")
            finally:
                tr = ntr = opt = m = inputs = None
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        if not results:
            _, g, s = candidates[0]
            return g, s
        results.sort(key=lambda r: r[0])
        win = results[0]
        if dist.is_multi_host():
            # the ranks' clocks may order the candidates differently; every
            # rank adopts rank 0's winner
            pick = dist.broadcast_winner_index(win[1])
            win = next(r for r in results if r[1] == pick)
        self.strategy_validation = {
            "timed_ms": [r[0] * 1e3 for r in results],
            # modeled rank (0 = the model's own pick) per timed entry
            "modeled_ranks": [r[1] for r in results],
            "modeled_ms": [candidates[r[1]][0] * 1e3 for r in results],
            "picked_modeled_rank": win[1],
            "picked_timed_index": results.index(win),
            "search": dict(self.search_stats),
        }
        if self.config.profiling:
            timed = ", ".join(f"{r[0] * 1e3:.2f}" for r in results)
            print(f"[search] top-{len(results)} validated (ms/step): "
                  f"{timed}")
        return win[2], win[3]

    def _synth_labels(self, graph: Graph) -> np.ndarray:
        """Zero labels for the timed playoff, shaped as fit passes them:
        the INPUT batch and the sink's middle dims."""
        sink = graph.sinks()[0]
        out = sink.outputs[0]
        first_input = next(n for n in graph.nodes
                           if n.op_type == OpType.INPUT)
        b = first_input.outputs[0].dims[0].size
        dims = (b,) + tuple(d.size for d in out.dims[1:])
        if self._loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
            return np.zeros(dims[:-1], np.int32)
        return np.zeros(dims, np.float32)

    def export_strategy_file(self, path: str) -> None:
        """Write the compiled strategy as JSON, node name -> view (the
        reference's --export-strategy format; either package imports the
        other's)."""
        import json

        from flexflow_tpu_torch.parallel.sharding import view_to_json

        with open(path, "w") as f:
            json.dump({n.name: view_to_json(n.sharding)
                       for n in self.graph.nodes if n.sharding is not None},
                      f, indent=1)

    def _export_dot(self, path: str) -> None:
        """The compiled graph as GraphViz (--compgraph); with
        include_costs_dot_graph each node carries its modeled per-shard
        time in ms."""
        costs = None
        if self.config.include_costs_dot_graph:
            from flexflow_tpu_torch.search.api import _cost_model

            cm = _cost_model(self._mesh.axes, self.config)
            costs = {n.guid: (cm.node_compute_time(self.graph, n, n.sharding)
                              + cm.node_comm_time(self.graph, n, n.sharding))
                     * 1e3 for n in self.graph.nodes}
        with open(path, "w") as f:
            f.write(self.graph.to_dot(costs=costs))

    def _new_executor(self, device, optimizer, graph: Optional[Graph] = None,
                      donate: Optional[bool] = None) -> Executor:
        return Executor(graph or self.graph, device,
                        loss_type=self._loss_type, metrics=self._metrics,
                        optimizer=optimizer, remat=self.config.remat,
                        mesh=self._mesh, seq_length=self.config.seq_length,
                        donate=(self.config.donate_buffers if donate is None
                                else donate),
                        pmesh=self._pmesh,
                        zero_sharded_opt=(self.config.param_sync
                                          == ParamSyncType.SHARDED))

    def _recompile(self):
        """A new Executor from the (altered) graph, with the settings,
        optimizer, weights and optimizer state of the current one
        (runtime/recompile.py)."""
        self.graph.infer_shapes()
        ex = self.executor
        self._executor = self._new_executor(ex.device, ex.optimizer)
        # the optimizer state kept is cut as the old executor cut it
        self._executor.zero_dims = ex.zero_dims

    @property
    def executor(self) -> Executor:
        if self._executor is None:
            raise RuntimeError("call compile() first")
        return self._executor

    @property
    def device(self):
        return self.executor.device

    @property
    def mesh(self) -> Optional[Mesh]:
        """The mesh compile() built from `config.mesh_shape`."""
        return self._mesh

    # ------------------------------------------------------------------
    # train / eval / predict on numpy batches

    @staticmethod
    def _batches(arrays: List[np.ndarray], batch_size: int):
        """Full batches only; the trailing partial batch is dropped (as
        the reference's dataloader, which sizes steps as n // batch)."""
        for i in range(arrays[0].shape[0] // batch_size):
            yield [a[i * batch_size:(i + 1) * batch_size] for a in arrays]

    def _to_device(self, arrays):
        """Host batches onto the device. On the card they go through
        pinned memory without blocking, so the step loop never waits for
        the card to drain."""
        dev = self.executor.device
        if dev.type != "cuda":
            return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        return [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                .to(dev, non_blocking=True) for a in arrays]

    def _prepare_training(self):
        """The executor's optimizer and its fp32 masters and state, made
        at the first training step of a model compiled without one."""
        ex = self.executor
        if ex.optimizer is None:
            ex.optimizer = self._optimizer
        if self._opt_state is None:
            tr, ntr = self._params
            tr = ex.master_params(tr)
            self._opt_state = ex.init_opt_state(ex.optimizer, tr)
            self._params = (tr, ntr)

    def create_data_loader(self, tensor: Optional[Tensor], full_array,
                           batch_size: Optional[int] = None,
                           shuffle: bool = False, seed: int = 0):
        """A loader of one graph input (or the labels) for
        fit(dataloaders=...): a numpy array gives the in-memory
        SingleDataLoader, a .npy file path the native FileDataLoader
        (runtime/dataloader.py)."""
        from flexflow_tpu_torch.runtime import dataloader

        if isinstance(full_array, (str, os.PathLike)):
            return dataloader.FileDataLoader(
                self, tensor, os.fspath(full_array), batch_size=batch_size,
                shuffle=shuffle, seed=seed)
        return dataloader.SingleDataLoader(self, tensor, full_array,
                                           batch_size=batch_size,
                                           shuffle=shuffle, seed=seed)

    def fit(self, x=None, y=None, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, verbose: bool = True,
            dataloaders=None, recompile_state=None) -> PerfMetrics:
        """Training loop: one train_step per full batch of numpy arrays
        `x` (one array or a list, one per graph input) and labels `y`, or
        of `dataloaders` = [input loaders..., label loader]
        (create_data_loader; batch t+1 is copied while step t runs; an
        explicit `batch_size` overrides the loaders'). Metrics add up on
        the device through the epoch and reach the host once per epoch,
        as the reference's do. After each step `recompile_state`'s trigger
        is checked (runtime/recompile.py), and with config.checkpoint_dir
        and checkpoint_every a checkpoint is written every
        checkpoint_every steps (runtime/checkpoint.periodic_save); both
        read the device on purpose, outside config.transfer_guard. With
        config.profiler_trace_dir the whole call runs under torch.profiler
        and writes a Chrome trace there (on top of the guard, as the
        reference stacks its capture and its guard)."""
        with contextlib.ExitStack() as stack:
            if self.config.profiler_trace_dir:
                stack.enter_context(self._profiler_capture(
                    self.config.profiler_trace_dir))
            return self._fit_impl(x, y, epochs, batch_size, verbose,
                                  dataloaders, recompile_state)

    def _profiler_capture(self, trace_dir: str):
        """torch.profiler over fit (the reference's jax.profiler.trace):
        CPU activity, and CUDA activity when the model runs on the card,
        written on exit as a Chrome trace under `trace_dir`
        (fit_<pid>_<n>.pt.trace.json)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.executor.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        self._profiler_traces += 1
        path = os.path.join(
            trace_dir,
            f"fit_{os.getpid()}_{self._profiler_traces}.pt.trace.json")
        return torch.profiler.profile(
            activities=acts,
            on_trace_ready=lambda prof: prof.export_chrome_trace(path))

    def _fit_impl(self, x, y, epochs, batch_size, verbose, dataloaders,
                  recompile_state) -> PerfMetrics:
        from flexflow_tpu_torch.runtime.checkpoint import periodic_save
        from flexflow_tpu_torch.runtime.dataloader import PrefetchLoader
        from flexflow_tpu_torch.runtime.recompile import (
            recompile_on_condition,
        )

        epochs = epochs or self.config.epochs
        explicit_bs = batch_size
        batch_size = batch_size or self.config.batch_size
        ckpt_dir = self.config.checkpoint_dir
        ckpt_every = self.config.checkpoint_every if ckpt_dir else 0
        self._prepare_training()
        ex = self.executor
        tr, ntr = self._params
        opt_state = self._opt_state
        # a fresh dropout stream per call (repeated fit calls, as a
        # per-epoch loop makes, do not replay the first call's masks);
        # step i of the call draws from (stream, i)
        stream = self.config.seed + 1 + self._fit_calls
        self._fit_calls += 1
        step = 0
        for epoch in range(epochs):
            self.current_metrics = PerfMetrics()
            if dataloaders is not None:
                if explicit_bs is not None:
                    for dl in dataloaders:
                        dl.batch_size = explicit_bs
                batches = iter(PrefetchLoader(self, dataloaders))
            else:
                xs = [x] if isinstance(x, np.ndarray) else list(x)
                batches = (self._to_device(ex.local_batch(b, labels=True))
                           for b in self._batches(xs + [y], batch_size))
            dev_sums = None
            n_samples = 0
            with self._transfer_guard():
                for batch in batches:
                    *bx, by = batch
                    tr, ntr, opt_state, m = ex.train_step(
                        tr, ntr, opt_state, by, *bx, rng=(stream, step))
                    step += 1
                    self._step_count += 1
                    # the metrics are the global batch's means (on a
                    # process mesh each rank holds its rows)
                    bsz = by.shape[0] * ex.batch_degree()
                    n_samples += bsz
                    scaled = {k: (v if k == "accuracy_correct" else v * bsz)
                              for k, v in m.items() if k != "loss"}
                    dev_sums = scaled if dev_sums is None else {
                        k: dev_sums[k] + v for k, v in scaled.items()}
                    if recompile_state is None and not (
                            ckpt_every and self._step_count % ckpt_every
                            == 0):
                        continue
                    self._params = (tr, ntr)
                    self._opt_state = opt_state
                    with self._sync_allowed():
                        if recompile_state is not None:
                            recompile_state.last_metrics = m
                            if recompile_on_condition(self,
                                                      recompile_state):
                                ex = self.executor
                                tr, ntr = self._params
                                opt_state = self._opt_state
                        if ckpt_every \
                                and self._step_count % ckpt_every == 0:
                            periodic_save(ckpt_dir, self)
            self.current_metrics.train_all = n_samples
            if dev_sums is not None:
                # the one device-to-host sync of the epoch
                host = {k: float(v) for k, v in dev_sums.items()}
                self.current_metrics.train_correct = int(
                    round(host.get("accuracy_correct", 0.0)))
                for k in LOSS_KEYS:
                    if k in host:
                        setattr(self.current_metrics, k, host[k])
            if verbose:
                print(f"epoch {epoch}: "
                      f"{self.current_metrics.report(self._metrics)}")
        self._params = (tr, ntr)
        self._opt_state = opt_state
        return self.current_metrics

    def _transfer_guard(self):
        """fit's step loop under config.transfer_guard: on the card,
        torch.cuda.set_sync_debug_mode at the guard's level, so a host
        sync inside a step warns ("log") or raises ("disallow"); nothing
        on the CPU, where no transfer exists."""
        level = self.config.transfer_guard
        return self._sync_debug(TRANSFER_GUARDS[level] if level else None)

    def _sync_allowed(self):
        """A deliberate read of the device inside fit's step loop (a
        recompile trigger, a checkpoint), exempt from
        config.transfer_guard as the reference exempts it."""
        return self._sync_debug("default")

    @contextlib.contextmanager
    def _sync_debug(self, mode):
        if self.config.transfer_guard is None or mode is None \
                or self.executor.device.type != "cuda":
            yield
            return
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(before)

    def eval(self, x: Union[np.ndarray, Sequence[np.ndarray]], y: np.ndarray,
             batch_size: Optional[int] = None,
             verbose: bool = True) -> PerfMetrics:
        xs = [x] if isinstance(x, np.ndarray) else list(x)
        batch_size = batch_size or self.config.batch_size
        tr, ntr = self._params
        pm = PerfMetrics()
        for batch in self._batches(xs + [y], batch_size):
            *bx, by = self._to_device(
                self.executor.local_batch(batch, labels=True))
            m = self.executor.eval_step(tr, ntr, by, *bx)
            pm.update({k: float(v) for k, v in m.items() if k != "loss"},
                      batch_size)
        if verbose:
            print(f"eval: {pm.report(self._metrics)}")
        return pm

    def predict(self, x: Union[np.ndarray, Sequence[np.ndarray]],
                batch_size: Optional[int] = None) -> np.ndarray:
        """The sink output for every row of `x` (the last batch padded,
        unlike fit/eval), as fp32 numpy; on a process mesh every rank
        feeds its piece of each batch and gets the whole output."""
        xs = [x] if isinstance(x, np.ndarray) else list(x)
        batch_size = batch_size or self.config.batch_size
        tr, ntr = self._params
        n = xs[0].shape[0]
        pad = (-n) % batch_size
        if pad:
            xs = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                  for a in xs]
        ex = self.executor
        outs = [ex.forward(tr, ntr, *self._to_device(ex.local_batch(batch)))
                .float().cpu().numpy()
                for batch in self._batches(xs, batch_size)]
        return np.concatenate(outs, axis=0)[:n]

    # ------------------------------------------------------------------
    # weight access (the reference's get_weight / set_weight)

    def get_weight(self, tensor_or_name: Union[Tensor, str],
                   weight_name: str = "kernel") -> np.ndarray:
        """The weight `weight_name` of a node (its Tensor or its name) as
        a numpy array on the host (a bfloat16 leaf, which numpy lacks, as
        float32). On a process mesh the whole leaf, gathered from every
        rank's piece: every rank calls it."""
        key = self._resolve_param_key(tensor_or_name)
        leaf = self._param_tree(key, weight_name)[key][weight_name]
        if self._pmesh is not None:
            leaf = self.executor.gather_params(
                {key: {weight_name: leaf}})[key][weight_name]
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()

    def set_weight(self, tensor_or_name: Union[Tensor, str],
                   value: Union[np.ndarray, torch.Tensor],
                   weight_name: str = "kernel"):
        """Replace the weight `weight_name` of a node by `value` (numpy, or
        a torch tensor on any device, copied without a trip through
        numpy), cast to the stored leaf's dtype and placed on its device,
        as the reference casts to the old leaf's dtype and sharding (on a
        process mesh `value` is the whole leaf; each rank keeps its
        piece)."""
        key = self._resolve_param_key(tensor_or_name)
        tree = self._param_tree(key, weight_name)
        old = tree[key][weight_name]
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, copy=True))
        if self._pmesh is not None:
            value = self._pmesh.shard(
                value, self.executor.param_specs()[key][weight_name])
        if tuple(value.shape) != tuple(old.shape):
            raise ValueError(f"{key}/{weight_name} has shape "
                             f"{tuple(old.shape)}, got "
                             f"{tuple(value.shape)}")
        new = torch.empty(old.shape, dtype=old.dtype, device=old.device)
        tree[key][weight_name] = new.copy_(value.detach())

    def _param_tree(self, key: str, weight_name: str):
        """The parameter tree (trainable first) holding key/weight_name."""
        if self._params is None:
            raise RuntimeError("call compile() first")
        tr, ntr = self._params
        return tr if weight_name in tr.get(key, {}) else ntr

    def _resolve_param_key(self, tensor_or_name) -> str:
        if isinstance(tensor_or_name, Tensor):
            return tensor_or_name.node.stable_key()
        for n in self.graph.nodes:
            if n.name == tensor_or_name:
                return n.stable_key()
        raise KeyError(tensor_or_name)

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """Autoregressive generation with a dense KV cache (counterpart of
        the reference's generate): one prefill pass writes the (batch,
        s) prompt's K/V into per-layer caches of s + max_new_tokens rows,
        then single-token steps extend them (Executor.decode_fn).
        temperature=0 is greedy and gives the JAX package's tokens;
        temperature > 0 samples with pick_tokens from a torch.Generator
        seeded with `seed`, which matches the reference's jax.random
        draws in distribution only. The tokens stay on the device until
        the end. Returns (batch, max_new_tokens) int32 tokens. On a
        process mesh every rank passes the whole prompt and gets every
        token: each decodes its rows over caches of its kv heads,
        replicated over `seq` (Executor.init_kv_cache, decode_fn); the
        paged and batch servers stay refused there."""
        from flexflow_tpu_torch.serving import pick_tokens

        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        ex = self.executor
        prompt_ids = np.asarray(prompt_ids, np.int32)
        b, s = prompt_ids.shape
        # learned-position models: decode must not run past the table
        rows = self.position_table_rows()
        if rows is not None and s + max_new_tokens > rows:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the learned position table ({rows} rows); "
                "rebuild the model with a longer seq_len")
        if s < 1:
            raise ValueError("prompt must contain at least one token")
        dev = ex.device
        caches = ex.init_kv_cache(b, s + max_new_tokens)
        tr, ntr = self._params
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        temps = torch.full((b,), float(temperature), dtype=torch.float32,
                           device=dev)
        probs, caches = ex.decode_fn(tr, ntr, caches, 0,
                                     torch.from_numpy(prompt_ids).to(dev))
        tok = pick_tokens(probs[:, -1, :], temps, gen)
        out = [tok]
        for pos in range(s, s + max_new_tokens - 1):
            probs, caches = ex.decode_fn(tr, ntr, caches, pos, tok[:, None])
            tok = pick_tokens(probs[:, -1, :], temps, gen)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()

    def serve_generation(self, slots: int = 4, max_len: int = 512,
                         eos_id=None, seed: int = 0, paged: bool = False,
                         page_size: int = 64, num_pages=None,
                         preemption: bool = True,
                         prefix_cache: bool = True,
                         prefill_chunk: int = 64, speculate=None,
                         ragged_pack: bool = True, megastep_ticks: int = 1,
                         megastep_mixed: bool = False,
                         overlap_dispatch: bool = False,
                         kv_dtype: str = "auto",
                         request_record_limit=None, serve_strategy=None,
                         search_budget=None, traffic="smoke",
                         reqlog_capacity=None, slo=None, slo_dump_dir=None,
                         kv_quant_canary=None, defer_start: bool = False,
                         host_tier=None):
        """Continuous-batching generation (serving.serve_generation) with
        the reference's defaults: the dense GenerationServer, or with
        `paged=True` the block-paged KV cache (prefix cache and
        preemption on) and its kv_dtype pools ("auto", "int8", "bf16",
        "fp16", "fp32"). `speculate=SpecConfig(...)` serves through the
        speculative server (draft trees verified in one ragged step, the
        accepted path committed in place); `megastep_ticks=N` runs up to
        N pure-decode ticks per host round trip; `megastep_mixed=True`
        fuses chunk rows and device-drafted chains into the megastep,
        `overlap_dispatch=True` admits while it runs; `ragged_pack=False`
        launches the unpacked prefill. `request_record_limit` bounds the
        per-request records of metrics(), `reqlog_capacity` sizes the
        request log (0 disables it), `slo=SLOTarget(...)` arms the SLO
        monitor with breach dumps under `slo_dump_dir`. `host_tier`
        spills evicted prefix pages to host memory (a page capacity, or
        a disagg.HostTier shared with another server) and
        `kv_quant_canary=N` shadows every Nth admission's launches in
        fp32. `search_budget=N` searches the serving knobs against the
        `traffic` profile (search/servesearch.py, priced on the H100
        machine model) and serves the winner (on the card it can lose to
        the default strategy: see serving.serve_generation);
        `serve_strategy` serves a known ServeStrategy or its JSON
        dict."""
        from flexflow_tpu_torch.serving import serve_generation as _sg

        self._refuse_mesh_serving("serve_generation")
        return _sg(self, slots=slots, max_len=max_len, eos_id=eos_id,
                   seed=seed, paged=paged, page_size=page_size,
                   num_pages=num_pages, preemption=preemption,
                   prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
                   speculate=speculate, ragged_pack=ragged_pack,
                   megastep_ticks=megastep_ticks,
                   megastep_mixed=megastep_mixed,
                   overlap_dispatch=overlap_dispatch, kv_dtype=kv_dtype,
                   request_record_limit=request_record_limit,
                   serve_strategy=serve_strategy,
                   search_budget=search_budget, traffic=traffic,
                   reqlog_capacity=reqlog_capacity, slo=slo,
                   slo_dump_dir=slo_dump_dir,
                   kv_quant_canary=kv_quant_canary, host_tier=host_tier,
                   defer_start=defer_start)

    def _refuse_mesh_serving(self, what: str):
        if self._pmesh is not None:
            raise NotImplementedError(
                f"{what} on a mesh of {dict(self._pmesh.sizes)} (serving on "
                "a mesh above 1) is not ported yet: compile the model on one "
                "process to serve it (ROADMAP.md, queue 1 item 12)")

    def serve(self, batch_sizes=(1, 8), max_delay_ms: float = 2.0,
              warmup: bool = True):
        """A batch-serving endpoint over this compiled model: the dynamic
        batcher of serving.Server (serving.serve)."""
        from flexflow_tpu_torch.serving import serve as _serve

        self._refuse_mesh_serving("serve")
        return _serve(self, batch_sizes=batch_sizes,
                      max_delay_ms=max_delay_ms, warmup=warmup)
