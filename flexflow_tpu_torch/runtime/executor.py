"""Executor: runs a PCG eagerly on one device (counterpart of
flexflow_tpu/runtime/executor.py).

Where the JAX package traces the topo-order walk into one jitted XLA
program, the port walks the same order eagerly, calling each node's
PyTorch lowering (ops/torch_ops.py). It draws the parameters, runs the
forward pass for inference and training, the training step (loss,
autograd backward through the hand-written attention kernels, optimizer
update) and the evaluation step, and owns the paged KV pools and the one
ragged serving step. Where the reference returns a jitted step function
(`train_step()`, `ragged_step_fn()`), the port's method is the step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from flexflow_tpu_torch.ffconst import LossType, MetricsType, OpType
from flexflow_tpu_torch.ops.registry import LowerCtx, get_lowering
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.runtime import initializer as init_mod
from flexflow_tpu_torch.runtime.loss import compute_loss
from flexflow_tpu_torch.runtime.metrics import compute_step_metrics

# weights stored fp32 whatever their declared dtype, so their values are
# the reference's fp32 masters: the norm scales and biases (their
# lowerings compute in fp32) and WEIGHT's table (its lowering hands the
# master on as it is, and jnp-style promotion follows from its dtype)
_FP32_USE = {(OpType.RMS_NORM, "scale"), (OpType.LAYER_NORM, "scale"),
             (OpType.LAYER_NORM, "bias"), (OpType.WEIGHT, "weight")}
_ATTENTION_OPS = (OpType.MULTIHEAD_ATTENTION, OpType.RING_ATTENTION)


def node_key(node: Node) -> str:
    return node.stable_key()


class Executor:
    """Owns the eager step functions for one compiled PCG on `device`."""

    def __init__(self, graph: Graph, device: torch.device, *,
                 loss_type: Optional[LossType] = None,
                 metrics: Sequence[MetricsType] = (), optimizer=None,
                 remat: str = "attention", mesh=None):
        self.graph = graph
        self.device = torch.device(device)
        self.mesh = mesh
        self.loss_type = loss_type
        self.metrics = list(metrics)
        self.optimizer = optimizer
        self.remat = remat
        self.topo = graph.topo_order()
        self.input_nodes = [n for n in self.topo if n.op_type == OpType.INPUT]
        sinks = graph.sinks()
        if len(sinks) != 1:
            raise ValueError(f"PCG must have exactly one sink, got {sinks}")
        self.sink = sinks[0]
        self.last_op_is_softmax = self.sink.op_type == OpType.SOFTMAX
        # a graph ending in Softmax under a cross-entropy loss skips the
        # final softmax in train/eval and fuses it into the loss as a
        # log-softmax; predict still runs the real softmax
        self.fuse_loss_softmax = self.last_op_is_softmax and loss_type in (
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
            LossType.CATEGORICAL_CROSSENTROPY,
        )

    # ------------------------------------------------------------------
    # parameters

    def weight_specs(self) -> Dict[str, Dict[str, Any]]:
        """(node_key -> weight name -> WeightSpec) for all ops with weights."""
        out = {}
        for n in self.topo:
            if n.attrs is None or n.op_type == OpType.INPUT:
                continue
            ws = n.attrs.weights(*self.graph.input_shapes(n))
            if ws:
                out[node_key(n)] = ws
        return out

    def storage_dtype(self, node: Node, weight_name: str, spec) -> torch.dtype:
        """The dtype a weight is stored in. The reference keeps fp32
        masters and casts each to its use-site dtype inside the lowering
        (the activation dtype, or fp32 for the norm scales; WEIGHT hands
        its master on uncast, so its table is stored fp32 always). A model
        compiled to train does the same: every floating trainable leaf is
        an fp32 master. A model compiled for inference stores the
        use-site dtype directly, the same values with half the memory of
        fp32 masters for a bf16 model."""
        dt = spec.shape.dtype.torch_dtype
        if (node.op_type, weight_name) in _FP32_USE and dt.is_floating_point:
            return torch.float32
        if self.optimizer is not None and spec.trainable \
                and dt.is_floating_point:
            return torch.float32
        return dt

    def init_params(self, seed: int):
        """Draw (trainable, nontrainable) parameter trees on the device.
        Leaf i (in sorted (node key, weight name) order) draws from its own
        torch.Generator on the device, seeded from (seed, i), so the
        values do not depend on which other leaves exist or in which
        order they are drawn. Each leaf is drawn in fp32 and stored at
        its storage dtype."""
        specs = self.weight_specs()
        by_key = {node_key(n): n for n in self.topo}
        index = {}
        for nk, ws in sorted(specs.items()):
            for wn in sorted(ws):
                index[(nk, wn)] = len(index)
        tr, ntr = {}, {}
        for nk, ws in specs.items():
            for wn, spec in ws.items():
                ini = init_mod.resolve(spec.initializer)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed * 1_000_003 + index[(nk, wn)])
                arr = ini(gen, spec.shape.dims, torch.float32, self.device)
                arr = arr.to(self.storage_dtype(by_key[nk], wn, spec))
                (tr if spec.trainable else ntr).setdefault(nk, {})[wn] = arr
        return tr, ntr

    @staticmethod
    def master_params(trainable):
        """The trainable tree with every floating leaf in fp32 (the
        masters the optimizer updates); leaves already fp32 are kept, not
        copied."""
        return {nk: {wn: (p.float() if p.is_floating_point() else p)
                     for wn, p in ws.items()}
                for nk, ws in trainable.items()}

    def init_opt_state(self, optimizer, params):
        """The optimizer's state for `params`, on the params' device."""
        return optimizer.init_state(params)

    # ------------------------------------------------------------------
    # forward

    def run_forward(self, trainable, nontrainable, inputs: Sequence, *,
                    training: bool = False, skip_sink_softmax: bool = False,
                    kv_caches=None, cache_position=None, cache_out=None,
                    page_tables=None, ragged=None):
        """Topo-order evaluation; returns the sink output. With
        `skip_sink_softmax` a final Softmax node passes its input (the raw
        logits) through, for a loss that fuses the softmax. With
        `training` and remat="attention" each attention lowering runs
        under torch.utils.checkpoint (non-reentrant): its intermediates
        are recomputed in the backward pass instead of saved, as the
        reference's jax.checkpoint does. With `kv_caches` + `page_tables`
        attention nodes run the PAGED step: kv_caches are per-node
        {"k", "v"} page pools (plus "k_scale"/"v_scale" for an int8
        pool), updated in place and reported in `cache_out`, and
        `ragged` = (q_lens, depths, anc) is the per-entry work descriptor
        (causal-chain default when None)."""
        values: Dict[Tuple[int, int], Any] = {}
        if len(inputs) != len(self.input_nodes):
            raise ValueError(f"expected {len(self.input_nodes)} inputs, "
                             f"got {len(inputs)}")
        for n, x in zip(self.input_nodes, inputs):
            values[(n.guid, 0)] = x
        if page_tables is not None and ragged is None:
            from flexflow_tpu_torch.paged.attention import chain_descriptor

            ragged = chain_descriptor(inputs[0].shape[0], inputs[0].shape[1],
                                      device=inputs[0].device)
        q_lens, depths, anc = ragged if ragged is not None else (None,) * 3
        for n in self.topo:
            if n.op_type == OpType.INPUT:
                continue
            key = node_key(n)
            ins = [values[(e.src, e.src_idx)] for e in self.graph.in_edges(n)]
            params = {**trainable.get(key, {}), **nontrainable.get(key, {})}
            if skip_sink_softmax and n.guid == self.sink.guid \
                    and n.op_type == OpType.SOFTMAX:
                values[(n.guid, 0)] = ins[0]
                continue
            ctx = LowerCtx(
                device=self.device, mesh=self.mesh, training=training,
                node_guid=n.guid,
                kv_cache=(kv_caches.get(key) if kv_caches is not None
                          else None),
                cache_position=cache_position, page_tables=page_tables,
                ragged_q_lens=q_lens, ragged_depths=depths, ragged_anc=anc)
            lowering = get_lowering(n.op_type)
            if training and self.remat == "attention" \
                    and n.op_type in _ATTENTION_OPS:
                outs = checkpoint(
                    lambda *xs, _n=n, _p=params, _c=ctx, _l=lowering:
                    _l(_n.attrs, list(xs), _p, _c), *ins,
                    use_reentrant=False)
            else:
                outs = lowering(n.attrs, ins, params, ctx)
            for i, o in enumerate(outs):
                values[(n.guid, i)] = o
            if ctx.cache_updates and cache_out is not None:
                cache_out[key] = dict(ctx.cache_updates)
        return values[(self.sink.guid, 0)]

    # ------------------------------------------------------------------
    # training and evaluation steps

    def loss_and_grads(self, trainable, nontrainable, labels, *inputs):
        """The loss of one batch (forward with training=True, the sink
        softmax fused into the loss) and its gradient with respect to
        every trainable leaf. Returns (loss, logits, grads): loss and
        logits detached, grads a tree shaped like `trainable`."""
        leaves = [p for ws in trainable.values() for p in ws.values()]
        for p in leaves:
            p.requires_grad_(True)
        try:
            logits = self.run_forward(
                trainable, nontrainable, inputs, training=True,
                skip_sink_softmax=self.fuse_loss_softmax)
            loss = compute_loss(self.loss_type, logits, labels,
                                self._sink_is_softmax())
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        grad_tree = {nk: {wn: next(it) for wn in ws}
                     for nk, ws in trainable.items()}
        return loss.detach(), logits.detach(), grad_tree

    def _sink_is_softmax(self) -> bool:
        """The logits still end in the sink softmax (not fused into the
        loss)."""
        return self.last_op_is_softmax and not self.fuse_loss_softmax

    def train_step(self, trainable, nontrainable, opt_state, labels,
                   *inputs):
        """One training step: the loss and gradients of `loss_and_grads`,
        then the optimizer's update of the fp32 masters and the state, in
        place. Returns (trainable, nontrainable, opt_state, metrics);
        metrics (the compiled metrics and "loss") are 0-d tensors on the
        device, so the step never waits for the card."""
        for ws in trainable.values():
            for p in ws.values():
                if p.dtype != torch.float32:
                    raise ValueError(
                        "train_step updates fp32 master weights; pass "
                        "Executor.master_params(trainable)")
        loss, logits, grad_tree = self.loss_and_grads(
            trainable, nontrainable, labels, *inputs)
        metrics = compute_step_metrics(self.metrics, self.loss_type, logits,
                                       labels, self._sink_is_softmax())
        metrics["loss"] = loss
        del logits
        trainable, opt_state = self.optimizer.update(grad_tree, trainable,
                                                     opt_state)
        return trainable, nontrainable, opt_state, metrics

    @torch.no_grad()
    def eval_step(self, trainable, nontrainable, labels, *inputs):
        """The loss and the compiled metrics of one batch, as 0-d tensors
        on the device."""
        logits = self.run_forward(trainable, nontrainable, inputs,
                                  skip_sink_softmax=self.fuse_loss_softmax)
        sink_is_sm = self._sink_is_softmax()
        m = compute_step_metrics(self.metrics, self.loss_type, logits,
                                 labels, sink_is_sm)
        m["loss"] = compute_loss(self.loss_type, logits, labels, sink_is_sm)
        return m

    @torch.no_grad()
    def forward(self, trainable, nontrainable, *inputs):
        """The sink output (the real softmax included) for one batch
        (the reference's forward_fn())."""
        return self.run_forward(trainable, nontrainable, inputs)

    # ------------------------------------------------------------------
    # paged KV pools + the ragged step

    def paged_kv_cache_specs(self, num_pages: int, page_size: int,
                             dtype: Optional[torch.dtype] = None
                             ) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype]]]:
        """{node key: {"k"/"v": (shape, dtype)}} of the paged K/V pools:
        (num_pages, page_size, Hkv, D) per attention node, at the
        attention's activation dtype unless `dtype` is given. An int8
        pool adds its (num_pages, Hkv) fp32 "k_scale"/"v_scale" sidecar
        (paged/quant.py) to the same per-node dict."""
        specs = {}
        for n in self.topo:
            if n.op_type == OpType.PIPELINE:
                raise ValueError("paged decode does not support PIPELINE "
                                 "composite graphs")
            if n.op_type not in (OpType.MULTIHEAD_ATTENTION,
                                 OpType.RING_ATTENTION):
                continue
            ins = self.graph.input_shapes(n)
            dt = dtype or (ins[0].dtype.torch_dtype if ins
                           else torch.bfloat16)
            shape = (num_pages, page_size, n.attrs.num_kv, n.attrs.kdim)
            specs[node_key(n)] = {"k": (shape, dt), "v": (shape, dt)}
            if dt == torch.int8:
                scales = ((num_pages, n.attrs.num_kv), torch.float32)
                specs[node_key(n)].update(k_scale=scales, v_scale=scales)
        if not specs:
            raise ValueError("paged decode needs attention nodes "
                             "(MULTIHEAD_ATTENTION or RING_ATTENTION)")
        return specs

    def init_paged_kv_cache(self, num_pages: int, page_size: int,
                            dtype: Optional[torch.dtype] = None):
        """Per-attention-node zeroed K/V page pools (and, for an int8
        pool, zeroed scale sidecars) on the device."""
        return {key: {name: torch.zeros(shape, dtype=dt, device=self.device)
                      for name, (shape, dt) in bufs.items()}
                for key, bufs in self.paged_kv_cache_specs(
                    num_pages, page_size, dtype).items()}

    @torch.inference_mode()
    def ragged_step_fn(self, trainable, nontrainable, caches, page_tables,
                       pos, q_lens, depths, anc, ids):
        """(params, pools, page_tables, pos, q_lens, depths, anc, ids) ->
        (probs, pools): ONE ragged paged step over a packed batch of work
        items — decode rows and prefill chunk pieces in the same call.
        Entry b carries q_lens[b] live rows of the (B, S) ids window,
        writing K/V at pos[b]..pos[b]+q_lens[b]-1 through its table row;
        entries padded to the launch shape pass q_len 0 and do no work.
        The pools are updated in place and returned. (The reference's
        ragged_step_fn() returns a jitted step; here the method is the
        step.)"""
        cache_out: Dict[str, Dict[str, torch.Tensor]] = {}
        out = self.run_forward(
            trainable, nontrainable, [ids], kv_caches=caches,
            cache_position=pos, cache_out=cache_out,
            page_tables=page_tables, ragged=(q_lens, depths, anc))
        return out, cache_out
