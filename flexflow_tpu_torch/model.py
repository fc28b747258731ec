"""FFModel — the central user-facing model object (counterpart of
flexflow_tpu/model.py).

Layer-building methods record a lazy PCG exactly as the JAX package's do
(same node names, guids and attrs); `compile()` infers shapes, builds the
eager Executor on the configured device and draws the parameters there;
`serve_generation(paged=True)` starts the paged continuous-batching
server. Training is not ported yet: `fit` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import (
    ActiMode,
    AggrMode,
    DataType,
    LossType,
    OpType,
)
from flexflow_tpu_torch.ops import attrs as A
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.pcg.tensor import TensorShape
from flexflow_tpu_torch.runtime.executor import Executor

_TRAINING_NOT_PORTED = (
    "training is not ported to PyTorch yet: the training step and its "
    "flash-attention kernels are the next slice (ROADMAP.md, queue 1 "
    "item 2 and queue 2)")


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


class FFModel:
    """Build a layer graph, compile it for one device, serve it."""

    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.graph = Graph()
        self._executor: Optional[Executor] = None
        self._params = None  # (trainable, nontrainable)
        self._used_names: set = set()

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

    # ------------------------------------------------------------------
    # layers (the subset build_llama calls)

    def create_tensor(self, dims: Sequence[int],
                      dtype: DataType = DataType.FLOAT,
                      name: Optional[str] = None) -> Tensor:
        shape = TensorShape(tuple(dims), dtype)
        return self._one(OpType.INPUT, A.InputAttrs(shape), [],
                         name or "input")

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.NONE, use_bias: bool = True,
              name: Optional[str] = None) -> Tensor:
        return self._one(
            OpType.LINEAR,
            A.LinearAttrs(out_dim, use_bias, ActiMode.coerce(activation)),
            [input], name or "dense")

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.NONE,
                  dtype: DataType = DataType.FLOAT,
                  name: Optional[str] = None) -> Tensor:
        return self._one(
            OpType.EMBEDDING,
            A.EmbeddingAttrs(num_entries, out_dim, AggrMode.coerce(aggr),
                             dtype),
            [input], name or "embedding")

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0,
                            bias: bool = True, causal: bool = False,
                            kv_heads: Optional[int] = None,
                            rope: bool = False, rope_theta: float = 10000.0,
                            name: Optional[str] = None) -> Tensor:
        return self._one(
            OpType.MULTIHEAD_ATTENTION,
            A.MultiHeadAttentionAttrs(
                embed_dim, num_heads, kv_heads,
                kdim // num_heads if kdim else None, causal, bias, dropout,
                rope, rope_theta),
            [query, key, value], name or "attention")

    def _binary(self, kind: str, x: Tensor, y: Tensor, name) -> Tensor:
        return self._one(OpType.ELEMENT_BINARY, A.ElementBinaryAttrs(kind),
                         [x, y], name or kind)

    def add(self, x, y, name=None):
        return self._binary("add", x, y, name)

    def multiply(self, x, y, name=None):
        return self._binary("multiply", x, y, name)

    def silu(self, x, name=None):
        return self._one(OpType.ELEMENT_UNARY, A.ElementUnaryAttrs("silu"),
                         [x], name or "silu")

    def rms_norm(self, input: Tensor, eps: float = 1e-6, name=None) -> Tensor:
        return self._one(OpType.RMS_NORM, A.RMSNormAttrs(eps), [input],
                         name or "rms_norm")

    def softmax(self, input: Tensor, axis: int = -1, name=None) -> Tensor:
        return self._one(OpType.SOFTMAX, A.SoftmaxAttrs(axis), [input],
                         name or "softmax")

    # ------------------------------------------------------------------
    # compile / serve

    def compile(self, optimizer=None, loss_type: Optional[LossType] = None,
                params=None):
        """Infer shapes, build the executor on the configured device and
        draw the parameters there from `config.seed` — or, when `params`
        is given, take those (trainable, nontrainable) trees instead,
        moved to the device (e.g. runtime.weights.params_from_numpy's, or
        another FFModel's `_params`). Inference only: an optimizer raises;
        `loss_type` is accepted as the reference's callers pass it, and
        unused."""
        if optimizer is not None:
            raise NotImplementedError(_TRAINING_NOT_PORTED)
        device = self.config.torch_device()
        self.graph.infer_shapes()
        self._executor = Executor(self.graph, device)
        if params is None:
            self._params = self._executor.init_params(self.config.seed)
        else:
            self._params = tuple(
                {k: {n: t.to(device) for n, t in w.items()}
                 for k, w in tree.items()} for tree in params)
        return self

    @property
    def executor(self) -> Executor:
        if self._executor is None:
            raise RuntimeError("call compile() first")
        return self._executor

    @property
    def device(self):
        return self.executor.device

    def fit(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING_NOT_PORTED)

    def serve_generation(self, slots: int = 4, max_len: int = 512,
                         eos_id=None, seed: int = 0, paged: bool = False,
                         page_size: int = 64, num_pages=None,
                         preemption: bool = False,
                         prefix_cache: bool = False,
                         prefill_chunk: int = 64, speculate=None,
                         ragged_pack: bool = True, megastep_ticks: int = 1,
                         megastep_mixed: bool = False,
                         overlap_dispatch: bool = False,
                         kv_dtype: str = "auto", host_tier=None):
        """Continuous-batching generation over the block-paged KV cache
        (serving.serve_generation). The port serves the paged path with
        prefix caching, preemption, megasteps, speculation, quantized
        pools and the host tier off; asking for any of them raises
        NotImplementedError rather than serving a different
        configuration."""
        from flexflow_tpu_torch.serving import serve_generation as _sg

        return _sg(self, slots=slots, max_len=max_len, eos_id=eos_id,
                   seed=seed, paged=paged, page_size=page_size,
                   num_pages=num_pages, preemption=preemption,
                   prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
                   speculate=speculate, ragged_pack=ragged_pack,
                   megastep_ticks=megastep_ticks,
                   megastep_mixed=megastep_mixed,
                   overlap_dispatch=overlap_dispatch, kv_dtype=kv_dtype,
                   host_tier=host_tier)
