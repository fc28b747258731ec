"""FFModel — the central user-facing model object (counterpart of
flexflow_tpu/model.py).

Layer-building methods record a lazy PCG exactly as the JAX package's do
(same node names, guids and attrs); `compile()` infers shapes, builds the
eager Executor on the configured device and draws the parameters there;
`fit`, `eval` and `predict` train and run the model on numpy batches;
`serve_generation(paged=True)` starts the paged continuous-batching
server.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import (
    ActiMode,
    AggrMode,
    DataType,
    LossType,
    MetricsType,
    OpType,
)
from flexflow_tpu_torch.ops import attrs as A
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


class FFModel:
    """Build a layer graph, compile it for one device, train or serve
    it."""

    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.graph = Graph()
        self._executor: Optional[Executor] = None
        self._params = None  # (trainable, nontrainable)
        self._opt_state = None
        self._optimizer: Optional[Optimizer] = None
        self._loss_type = LossType.SPARSE_CATEGORICAL_CROSSENTROPY
        self._metrics: List[MetricsType] = []
        self._step_count = 0
        self.current_metrics: Optional[PerfMetrics] = None
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

    def compile(self, optimizer: Optional[Optimizer] = None,
                loss_type: LossType = LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[MetricsType] = (), params=None):
        """Infer shapes, build the executor on the configured device and
        draw the parameters there from `config.seed` — or, when `params`
        is given, take those (trainable, nontrainable) trees instead,
        moved to the device (e.g. runtime.weights.params_from_numpy's, or
        another FFModel's `_params`; copied when compiled to train).

        With an `optimizer` the model is compiled to train: every
        floating trainable leaf is an fp32 master (the reference's
        init_params) and the optimizer state is drawn now. Without one
        the weights keep their use-site dtypes, as serving needs, and
        `fit` trains with SGDOptimizer() (the reference's default),
        turning the trainable leaves into fp32 masters at its first
        step."""
        device = self.config.torch_device()
        self._optimizer = optimizer or SGDOptimizer()
        self._loss_type = loss_type
        self._metrics = list(metrics)
        self.graph.infer_shapes()
        self._executor = Executor(self.graph, device, loss_type=loss_type,
                                  metrics=self._metrics, optimizer=optimizer,
                                  remat=self.config.remat)
        if params is None:
            tr, ntr = self._executor.init_params(self.config.seed)
        else:
            # training updates the weights in place: a model compiled to
            # train takes copies, so it never shares storage with the
            # trees it was given
            tr, ntr = tuple(
                {k: {n: t.to(device, copy=optimizer is not None)
                     for n, t in w.items()}
                 for k, w in tree.items()} for tree in params)
        self._opt_state = None
        if optimizer is not None:
            tr = self._executor.master_params(tr)
            self._opt_state = self._executor.init_opt_state(optimizer, tr)
        self._params = (tr, ntr)
        return self

    @property
    def executor(self) -> Executor:
        if self._executor is None:
            raise RuntimeError("call compile() first")
        return self._executor

    @property
    def device(self):
        return self.executor.device

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

    def fit(self, x=None, y=None, epochs: Optional[int] = None,
            batch_size: Optional[int] = None, verbose: bool = True,
            dataloaders=None, recompile_state=None) -> PerfMetrics:
        """Training loop over numpy arrays `x` (one array or a list, one
        per graph input) and labels `y`: one train_step per full batch.
        Metrics add up on the device through the epoch and reach the
        host once per epoch, as the reference's do. Data loaders and
        recompilation are not ported yet and raise."""
        if dataloaders is not None:
            raise NotImplementedError(
                "fit(dataloaders=...) is not ported yet (ROADMAP.md, queue "
                "1 item 10); pass numpy arrays x, y")
        if recompile_state is not None:
            raise NotImplementedError(
                "fit(recompile_state=...) is not ported yet (ROADMAP.md, "
                "queue 1 item 10)")
        epochs = epochs or self.config.epochs
        batch_size = batch_size or self.config.batch_size
        xs = [x] if isinstance(x, np.ndarray) else list(x)
        self._prepare_training()
        ex = self.executor
        tr, ntr = self._params
        opt_state = self._opt_state
        for epoch in range(epochs):
            self.current_metrics = PerfMetrics()
            dev_sums = None
            n_samples = 0
            for batch in self._batches(xs + [y], batch_size):
                *bx, by = self._to_device(batch)
                tr, ntr, opt_state, m = ex.train_step(tr, ntr, opt_state,
                                                      by, *bx)
                self._step_count += 1
                bsz = by.shape[0]
                n_samples += bsz
                scaled = {k: (v if k == "accuracy_correct" else v * bsz)
                          for k, v in m.items() if k != "loss"}
                dev_sums = scaled if dev_sums is None else {
                    k: dev_sums[k] + v for k, v in scaled.items()}
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

    def eval(self, x: Union[np.ndarray, Sequence[np.ndarray]], y: np.ndarray,
             batch_size: Optional[int] = None,
             verbose: bool = True) -> PerfMetrics:
        xs = [x] if isinstance(x, np.ndarray) else list(x)
        batch_size = batch_size or self.config.batch_size
        tr, ntr = self._params
        pm = PerfMetrics()
        for batch in self._batches(xs + [y], batch_size):
            *bx, by = self._to_device(batch)
            m = self.executor.eval_step(tr, ntr, by, *bx)
            pm.update({k: float(v) for k, v in m.items() if k != "loss"},
                      batch_size)
        if verbose:
            print(f"eval: {pm.report(self._metrics)}")
        return pm

    def predict(self, x: Union[np.ndarray, Sequence[np.ndarray]],
                batch_size: Optional[int] = None) -> np.ndarray:
        """The sink output for every row of `x` (the last batch padded,
        unlike fit/eval), as fp32 numpy."""
        xs = [x] if isinstance(x, np.ndarray) else list(x)
        batch_size = batch_size or self.config.batch_size
        tr, ntr = self._params
        n = xs[0].shape[0]
        pad = (-n) % batch_size
        if pad:
            xs = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                  for a in xs]
        outs = [self.executor.forward(tr, ntr, *self._to_device(batch))
                .float().cpu().numpy()
                for batch in self._batches(xs, batch_size)]
        return np.concatenate(outs, axis=0)[:n]

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
