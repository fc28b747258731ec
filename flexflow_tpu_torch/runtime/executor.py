"""Executor: runs a PCG eagerly on its device (counterpart of
flexflow_tpu/runtime/executor.py).

Where the JAX package traces the topo-order walk into one jitted XLA
program, the port walks the same order eagerly, calling each node's
PyTorch lowering (ops/torch_ops.py). It draws the parameters, runs the
forward pass for inference and training, the training step (loss,
autograd backward through the hand-written attention kernels, optimizer
update) and the evaluation step, and owns the dense KV caches and their
decode step (FFModel.generate, the dense server), the paged KV pools, the
one ragged serving step, and what serving builds on it: the speculative
tree-verify step and accepted-path commit, the decode megastep and the
universal (mixed) megastep. Where the reference returns a jitted step
function (`train_step()`, `ragged_step_fn()`), the port's method is the
step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from flexflow_tpu_torch import obs
from flexflow_tpu_torch.ffconst import ActiMode, LossType, MetricsType, OpType
from flexflow_tpu_torch.ops.registry import LowerCtx, get_lowering, node_seed
from flexflow_tpu_torch.parallel import shard_rules, spmd
from flexflow_tpu_torch.parallel.shard_rules import GRAD_AXES, SEQ
from flexflow_tpu_torch.parallel.sharding import prune_spec
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.runtime import initializer as init_mod
from flexflow_tpu_torch.runtime.loss import compute_loss, sharded_loss
from flexflow_tpu_torch.runtime.metrics import (
    VOCAB_SHARDED_METRICS,
    compute_step_metrics,
    vocab_sharded_step_metrics,
)

# weights stored fp32 whatever their declared dtype, so their values are
# the reference's fp32 masters: the norm scales and biases and
# BatchNorm's running statistics (their lowerings compute in fp32) and
# WEIGHT's table (its lowering hands the master on as it is, and
# jnp-style promotion follows from its dtype)
_FP32_USE = {(OpType.RMS_NORM, "scale"), (OpType.LAYER_NORM, "scale"),
             (OpType.LAYER_NORM, "bias"), (OpType.WEIGHT, "weight"),
             (OpType.BATCH_NORM, "scale"), (OpType.BATCH_NORM, "bias"),
             (OpType.BATCH_NORM, "running_mean"),
             (OpType.BATCH_NORM, "running_var"),
             (OpType.PIPELINE, "ln1"), (OpType.PIPELINE, "ln2")}
_ATTENTION_OPS = (OpType.MULTIHEAD_ATTENTION, OpType.RING_ATTENTION)


# init_params(weight_dtype=...)'s float names; "int8" is quantize_leaf
_WEIGHT_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp16": torch.float16, "float16": torch.float16,
    "fp8": torch.float8_e4m3fn, "float8_e4m3fn": torch.float8_e4m3fn,
}


def node_key(node: Node) -> str:
    return node.stable_key()


def cast_weight_leaf(arr: torch.Tensor, weight_dtype: str) -> torch.Tensor:
    """The storage cast of one drawn leaf (init_params(weight_dtype=...)):
    a float name is a plain cast; "int8" snaps the leaf to its symmetric
    int8 grid and stores it bf16 (paged.quant.quantize_leaf), since no
    matmul of the executor takes int8 operands."""
    if weight_dtype == "int8":
        from flexflow_tpu_torch.paged.quant import quantize_leaf

        return quantize_leaf(arr)
    dt = _WEIGHT_DTYPES.get(weight_dtype)
    if dt is None:
        raise ValueError(
            f"unknown weight_dtype {weight_dtype!r}; expected one of "
            f"{sorted(set(_WEIGHT_DTYPES))} or 'int8'")
    return arr.to(dt)


def merge_state(nontrainable, updates):
    """A new non-trainable tree: `nontrainable`'s leaves with `updates`
    (node key -> weight name -> tensor) in place of theirs; the tree
    passed in is not changed."""
    if not updates:
        return nontrainable
    new = {k: dict(v) for k, v in nontrainable.items()}
    for nk, ws in updates.items():
        new.setdefault(nk, {}).update(ws)
    return new


class Executor:
    """Owns the eager step functions for one compiled PCG on `device`."""

    def __init__(self, graph: Graph, device: torch.device, *,
                 loss_type: Optional[LossType] = None,
                 metrics: Sequence[MetricsType] = (), optimizer=None,
                 remat: str = "attention", mesh=None,
                 seq_length: Optional[int] = None, donate: bool = True,
                 pmesh=None, zero_sharded_opt: bool = False):
        self.graph = graph
        self.device = torch.device(device)
        self.mesh = mesh
        # the process mesh (parallel/spmd.ProcessMesh) when the data, seq
        # or model axis spans several processes, else None
        self.pmesh = pmesh
        # ZeRO-1: the optimizer state cut over `data` and `seq`
        # (ParamSyncType.SHARDED); {node key: {weight: cut dim or None}}
        # once drawn
        self.zero_sharded_opt = zero_sharded_opt
        self.zero_dims = None
        self.loss_type = loss_type
        self.metrics = list(metrics)
        self.optimizer = optimizer
        self.remat = remat
        self.seq_length = seq_length
        self.donate = donate
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
        # AGGREGATE_SPEC emits one row per (sample, choice) slot, so the
        # loss sees each label that many times (np.repeat order): the
        # ratio of the sink's batch to the first input's
        self.label_repeats = 1
        if any(n.op_type == OpType.AGGREGATE_SPEC for n in self.topo):
            in_b = self.input_nodes[0].outputs[0].dims[0].size
            out_b = self.sink.outputs[0].dims[0].size
            if in_b > 0 and out_b % in_b == 0 and out_b // in_b > 1:
                self.label_repeats = out_b // in_b
        # remat="hidden": the MLP groups recomputed in backward
        self.remat_groups = (self._find_hidden_groups()
                             if remat == "hidden" else {})
        self._remat_member_of = {
            g.guid: entry for entry, (members, _, _) in
            self.remat_groups.items() for g in members}

    def _find_hidden_groups(self):
        """The MLP-hidden groups remat="hidden" recomputes, found as the
        reference's Executor._find_hidden_groups finds them, node for
        node: {entry guid: (members in topo order, (guid, idx) of the
        group's one output, external (src guid, src idx) inputs in first-
        use order)}. Patterns, every inner node with one consumer:
          A: MUL(UNARY(LINEAR_g(x)), LINEAR_u(x)), the SwiGLU diamond
             (the unary on the product's first input);
          B: expanding LINEAR(activation) -> LINEAR;
          C: expanding LINEAR -> UNARY -> LINEAR;
        each swallowing its trailing contracting LINEAR when that is the
        last member's only consumer, so the group outputs the model-width
        tensor and the hidden one is recomputed, not saved."""
        consumers: Dict[int, list] = {}
        for n in self.topo:
            for e in self.graph.out_edges(n):
                consumers.setdefault(n.guid, []).append(e)
        by_guid = {n.guid: n for n in self.topo}
        topo_pos = {n.guid: i for i, n in enumerate(self.topo)}

        def single_consumer(guid):
            es = consumers.get(guid, [])
            return by_guid[es[0].dst] if len(es) == 1 else None

        def is_expanding(n):
            ins = self.graph.input_shapes(n)
            return bool(ins) and (n.outputs[0].dims[-1].size
                                  > ins[0].dims[-1].size)

        def sources(n):
            return {(e.src, e.src_idx) for e in self.graph.in_edges(n)}

        groups, claimed = {}, set()
        for m in self.topo:
            if m.guid in claimed:
                continue
            members = None
            if m.op_type == OpType.ELEMENT_BINARY and getattr(
                    m.attrs, "kind", None) in ("mul", "multiply"):
                ins = list(self.graph.in_edges(m))
                if len(ins) == 2:
                    s, u = by_guid[ins[0].src], by_guid[ins[1].src]
                    g_edges = list(self.graph.in_edges(s))
                    if (s.op_type == OpType.ELEMENT_UNARY
                            and u.op_type == OpType.LINEAR
                            and single_consumer(s.guid) is m
                            and single_consumer(u.guid) is m and g_edges):
                        g = by_guid[g_edges[0].src]
                        if (g.op_type == OpType.LINEAR
                                and single_consumer(g.guid) is s
                                and is_expanding(g) and is_expanding(u)
                                and sources(g) == sources(u)):
                            members = [g, u, s, m]
            elif (m.op_type == OpType.LINEAR and is_expanding(m)
                  and m.attrs.activation is not ActiMode.NONE):
                nxt = single_consumer(m.guid)
                if nxt is not None and nxt.op_type == OpType.LINEAR:
                    members = [m]
            elif m.op_type == OpType.LINEAR and is_expanding(m):
                nxt = single_consumer(m.guid)
                if nxt is not None and nxt.op_type == OpType.ELEMENT_UNARY:
                    nxt2 = single_consumer(nxt.guid)
                    if nxt2 is not None and nxt2.op_type == OpType.LINEAR:
                        members = [m, nxt]
            if members:
                tail = single_consumer(members[-1].guid)
                if (tail is not None and tail.op_type == OpType.LINEAR
                        and not is_expanding(tail)
                        and tail.guid not in claimed):
                    members.append(tail)
            if not members or any(n.guid in claimed for n in members):
                continue
            members.sort(key=lambda n: topo_pos[n.guid])
            member_set = {n.guid for n in members}
            # every external input must be computed before the entry
            ext = []
            for gn in members:
                for e in self.graph.in_edges(gn):
                    if e.src not in member_set \
                            and (e.src, e.src_idx) not in ext:
                        ext.append((e.src, e.src_idx))
            if any(topo_pos[src] > topo_pos[members[0].guid]
                   for src, _ in ext):
                continue
            groups[members[0].guid] = (members, (members[-1].guid, 0),
                                       tuple(ext))
            claimed.update(member_set)
        return groups

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

    def init_params(self, seed: int, overrides: Optional[Dict] = None,
                    weight_dtype: Optional[str] = None):
        """Draw (trainable, nontrainable) parameter trees on the device.
        Leaf i (in sorted (node key, weight name) order) draws from its own
        torch.Generator on the device, seeded from (seed, i), so the
        values do not depend on which other leaves exist or in which
        order they are drawn. `overrides` maps node key -> weight name ->
        Initializer (the layer methods' kernel_initializer and
        bias_initializer, create_weight's initializer), drawn from the
        same generator in place of the weight's default. Each leaf is
        drawn in fp32 and stored at its storage dtype, or with
        `weight_dtype` cast to that instead (cast_weight_leaf: "fp32",
        "bf16", "fp16", "fp8" or "int8")."""
        overrides = overrides or {}
        specs = self.weight_specs()
        by_key = {node_key(n): n for n in self.topo}
        index = {}
        for nk, ws in sorted(specs.items()):
            for wn in sorted(ws):
                index[(nk, wn)] = len(index)
        tr, ntr = {}, {}
        for nk, ws in specs.items():
            for wn, spec in ws.items():
                ini = init_mod.resolve(overrides.get(nk, {}).get(wn)
                                       or spec.initializer)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed * 1_000_003 + index[(nk, wn)])
                arr = ini(gen, spec.shape.dims, torch.float32, self.device)
                if weight_dtype is not None:
                    arr = cast_weight_leaf(arr, weight_dtype)
                else:
                    arr = arr.to(self.storage_dtype(by_key[nk], wn, spec))
                if self.pmesh is not None:
                    # every rank draws the whole leaf, as one card does,
                    # and keeps its piece
                    arr = self.pmesh.shard(
                        arr, self.param_specs()[nk][wn]).clone()
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
        """The optimizer's state for `params`, on the params' device. Under
        ZeRO-1 over data x seq above 1 (the axes a gradient is reduced
        over) each leaf's state covers this rank's slice of the leaf's
        largest dim that is not cut already and that their degree divides
        (the reference's opt_state_shardings, over `data`); a leaf with no
        such dim keeps it whole."""
        pm = self.pmesh
        if not self.zero_sharded_opt or pm is None \
                or not pm.live(GRAD_AXES):
            return optimizer.init_state(params)
        d = pm.degree(pm.live(GRAD_AXES))
        specs = self.param_specs()
        self.zero_dims = {}
        for nk, ws in params.items():
            for wn, p in ws.items():
                spec = specs[nk][wn]
                best, best_size = None, 0
                for i, size in enumerate(p.shape):
                    if not spec[i] and size % d == 0 and size > best_size:
                        best, best_size = i, size
                self.zero_dims.setdefault(nk, {})[wn] = best
        return optimizer.init_state(self._zero_slices(params))

    def _zero_slices(self, tree):
        """Views of this rank's ZeRO-1 slice of every leaf (the leaf
        itself where it has no cut dim)."""
        pm = self.pmesh
        out = {}
        for nk, ws in tree.items():
            out[nk] = {}
            for wn, p in ws.items():
                dim = self.zero_dims[nk][wn]
                out[nk][wn] = p if dim is None else pm.shard(
                    p, tuple(pm.live(GRAD_AXES) if i == dim else ()
                             for i in range(p.ndim)))
        return out

    def opt_state_specs(self, opt_state):
        """{state key: {node key: {weight: Spec}}} of the state trees that
        mirror the parameters: the parameter's spec, plus the ZeRO-1 axes
        on their dim (checkpoint gathers them)."""
        specs = self.param_specs()
        out = {}
        for k, v in opt_state.items():
            if not isinstance(v, dict):
                continue
            out[k] = {}
            for nk, ws in v.items():
                out[k][nk] = {}
                for wn in ws:
                    spec = list(specs[nk][wn])
                    dim = (self.zero_dims or {}).get(nk, {}).get(wn)
                    if dim is not None:
                        spec[dim] = self.pmesh.live(GRAD_AXES)
                    out[k][nk][wn] = tuple(spec)
        return out

    # ------------------------------------------------------------------
    # one process per card: the layouts of the parameters and the batch

    def _prune(self, spec, shape) -> Tuple:
        """A view's spec as this mesh can cut `shape` (prune_spec), one
        entry a dim."""
        shape = tuple(shape)
        spec = prune_spec(spec, shape, self.mesh) if spec else None
        spec = tuple(spec or ())[:len(shape)]
        return tuple(tuple(a) for a in spec) + tuple(
            () for _ in range(len(shape) - len(spec)))

    def param_specs(self) -> Dict[str, Dict[str, Tuple]]:
        """{node key: {weight: Spec}}: how each leaf is cut over the
        process mesh (its view's weight spec, pruned; whole without)."""
        if getattr(self, "_param_specs", None) is None:
            out = {}
            for n in self.topo:
                if n.attrs is None or n.op_type == OpType.INPUT:
                    continue
                ws = n.attrs.weights(*self.graph.input_shapes(n))
                view = n.sharding
                for wn, spec in ws.items():
                    decl = (view.weight_specs.get(wn)
                            if view is not None else None)
                    out.setdefault(node_key(n), {})[wn] = self._prune(
                        decl, spec.shape.dims)
            self._param_specs = out
        return self._param_specs

    def input_specs(self):
        """The Spec of each graph input (its view's, pruned)."""
        out = []
        for n in self.input_nodes:
            shape = tuple(d.size for d in n.outputs[0].dims)
            v = n.sharding
            out.append(self._prune(v.output_spec(0) if v else None, shape))
        return out

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The axes the batch (dim 0 of the first input) is cut over."""
        specs = self.input_specs()
        return tuple(specs[0][0]) if specs and specs[0] else ()

    def batch_degree(self) -> int:
        """Into how many pieces the batch is cut (1 on one process)."""
        if self.pmesh is None:
            return 1
        return self.pmesh.degree(self.pmesh.keep(self.batch_axes))

    @property
    def seq_axes(self) -> Tuple[str, ...]:
        """The axes the labels' dim 1 is cut over: the first input's dim
        1 cut (`seq` across processes: model._apply_strategy) when the
        sink keeps the sequence as its dim 1, a per-token loss."""
        specs = self.input_specs()
        out = self.sink.outputs[0].dims
        first = self.input_nodes[0].outputs[0].dims
        if not specs or len(specs[0]) < 2 or len(out) < 3 \
                or out[1].size != first[1].size:
            return ()
        return tuple(specs[0][1])

    def label_spec(self, ndim: int):
        seq = (self.seq_axes,) if ndim >= 2 else ()
        return (self.batch_axes,) + seq + tuple(
            () for _ in range(ndim - 1 - len(seq)))

    def local_batch(self, arrays, labels: bool = False):
        """This rank's piece of each global input array (and of the
        labels, last, with `labels`): its rows, and its sequence block
        where `seq` spans processes."""
        from flexflow_tpu_torch.runtime.distributed import host_local_batch

        if self.pmesh is None:
            return list(arrays)
        specs = self.input_specs()[:len(arrays) - int(labels)]
        if labels:
            specs.append(self.label_spec(np.ndim(arrays[-1])))
        return host_local_batch(arrays, specs, self.pmesh)

    def shard_params(self, trainable, nontrainable):
        """Whole (trainable, nontrainable) trees -> this rank's pieces."""
        if self.pmesh is None:
            return trainable, nontrainable
        specs = self.param_specs()
        return tuple(
            {nk: {wn: self.pmesh.shard(t, specs[nk][wn]).clone()
                  for wn, t in ws.items()} for nk, ws in tree.items()}
            for tree in (trainable, nontrainable))

    def gather_params(self, tree):
        """Every rank's pieces -> the whole leaves, on every rank (a
        collective: every rank calls it)."""
        if self.pmesh is None:
            return tree
        specs = self.param_specs()
        return {nk: {wn: self.pmesh.gather(t, specs[nk][wn])
                     for wn, t in ws.items()} for nk, ws in tree.items()}

    # ------------------------------------------------------------------
    # forward

    def run_forward(self, trainable, nontrainable, inputs: Sequence, *,
                    training: bool = False, skip_sink_softmax: bool = False,
                    kv_caches=None, cache_position=None, cache_out=None,
                    page_tables=None, ragged=None, return_aux=False,
                    rng: Optional[Tuple[int, int]] = None,
                    state_out: Optional[dict] = None):
        """Topo-order evaluation; returns the sink output, or with
        `return_aux` (output, aux): the sum of the load-balance terms the
        MoE lowerings wrote (None when none did). With
        `skip_sink_softmax` a final Softmax node passes its input (the raw
        logits) through, for a loss that fuses the softmax. With
        `training` and remat="attention" each attention lowering runs
        under torch.utils.checkpoint (non-reentrant): its intermediates
        are recomputed in the backward pass instead of saved, as the
        reference's jax.checkpoint does; with remat="hidden" each of
        `remat_groups` does (_run_remat_group). With `kv_caches` alone
        attention nodes run the DENSE-cache step at `cache_position`
        (decode_fn).
        With `kv_caches` + `page_tables` attention nodes run the PAGED step: kv_caches are per-node
        {"k", "v"} page pools (plus "k_scale"/"v_scale" for an int8
        pool), updated in place and reported in `cache_out`, and
        `ragged` = (q_lens, depths, anc) is the per-entry work descriptor
        (causal-chain default when None).

        In training each node's draws come from its own stream,
        `node_seed((fit stream, step), guid)` with `rng` = (fit stream,
        step) ((0, 0) when None); outside training nothing draws. With
        `state_out` the non-trainable weights a node moves (BatchNorm's
        running statistics) land in state_out[node key]."""
        if self.pmesh is not None:
            if page_tables is not None:
                raise NotImplementedError(
                    "paged decoding on a mesh of several processes (serving "
                    "on a mesh above 1) is not ported yet (ROADMAP.md, "
                    "queue 1 item 12)")
            out, aux, _ = self._run_forward_spmd(
                trainable, nontrainable, inputs, training=training,
                skip_sink_softmax=skip_sink_softmax, rng=rng,
                state_out=state_out, kv_caches=kv_caches,
                cache_position=cache_position, cache_out=cache_out)
            return (out, aux) if return_aux else out
        values: Dict[Tuple[int, int], Any] = {}
        if training and rng is None:
            rng = (0, 0)
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
        groups = self.remat_groups if training else {}
        aux = None
        for n in self.topo:
            if n.op_type == OpType.INPUT:
                continue
            if groups and n.guid in self._remat_member_of:
                entry = self._remat_member_of[n.guid]
                if n.guid == entry:  # the other members run inside it
                    self._run_remat_group(
                        groups[entry], values, rng,
                        lambda gn, ins, _, ctx: _lower_node(
                            gn, ins, trainable, nontrainable, ctx))
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
                seq_length=self.seq_length, node_guid=n.guid,
                rng_seed=node_seed(rng, n.guid) if training else None,
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
            if ctx.aux_loss is not None:
                aux = ctx.aux_loss if aux is None else aux + ctx.aux_loss
            if ctx.cache_updates and cache_out is not None:
                cache_out[key] = dict(ctx.cache_updates)
            if ctx.state_updates and state_out is not None:
                state_out[key] = dict(ctx.state_updates)
        out = values[(self.sink.guid, 0)]
        return (out, aux) if return_aux else out

    def _run_forward_spmd(self, trainable, nontrainable, inputs, *,
                          training: bool, skip_sink_softmax: bool, rng,
                          state_out, kv_caches=None, cache_position=None,
                          cache_out=None):
        """run_forward on this rank's pieces: (sink piece, aux, its
        layout). With `kv_caches` (a dense-cache decode step) every rank
        runs on its rows and its heads with the sequence whole: the
        process mesh without `seq` (decode_mesh)."""
        pm = self.pmesh if kv_caches is None else self.decode_mesh()
        if training and rng is None:
            rng = (0, 0)
        if len(inputs) != len(self.input_nodes):
            raise ValueError(f"expected {len(self.input_nodes)} inputs, "
                             f"got {len(inputs)}")
        values: Dict[Tuple[int, int], Any] = {}
        layouts: Dict[Tuple[int, int], Tuple] = {}
        for n, x, spec in zip(self.input_nodes, inputs, self.input_specs()):
            values[(n.guid, 0)] = x
            layouts[(n.guid, 0)] = spec
        groups = self.remat_groups if training else {}
        aux = None
        for n in self.topo:
            if n.op_type == OpType.INPUT:
                continue
            if groups and n.guid in self._remat_member_of:
                entry = self._remat_member_of[n.guid]
                if n.guid == entry:
                    self._run_remat_group(
                        groups[entry], values, rng,
                        lambda gn, ins, lays, ctx: self._run_node_spmd(
                            gn, ins, lays, trainable, nontrainable, ctx,
                            remat=False, pm=pm),
                        layouts)
                continue
            srcs = [(e.src, e.src_idx) for e in self.graph.in_edges(n)]
            if skip_sink_softmax and n.guid == self.sink.guid \
                    and n.op_type == OpType.SOFTMAX:
                values[(n.guid, 0)] = values[srcs[0]]
                layouts[(n.guid, 0)] = layouts[srcs[0]]
                continue
            key = node_key(n)
            ctx = LowerCtx(
                device=self.device, mesh=self.mesh, pmesh=pm,
                training=training, seq_length=self.seq_length,
                node_guid=n.guid,
                rng_seed=node_seed(rng, n.guid) if training else None,
                kv_cache=(kv_caches.get(key) if kv_caches is not None
                          else None),
                cache_position=cache_position)
            outs, lays = self._run_node_spmd(
                n, [values[k] for k in srcs], [layouts[k] for k in srcs],
                trainable, nontrainable, ctx,
                remat=training and self.remat == "attention", pm=pm)
            for i, (o, lay) in enumerate(zip(outs, lays)):
                values[(n.guid, i)] = o
                layouts[(n.guid, i)] = lay
            if ctx.aux_loss is not None:
                aux = ctx.aux_loss if aux is None else aux + ctx.aux_loss
            if ctx.state_updates and state_out is not None:
                state_out[key] = dict(ctx.state_updates)
            if ctx.cache_updates and cache_out is not None:
                cache_out[key] = dict(ctx.cache_updates)
        key = (self.sink.guid, 0)
        return values[key], aux, layouts[key]

    def decode_mesh(self):
        """The process mesh a decode step runs on: without `seq`, so every
        layout that cuts the sequence reads as whole (decode is
        sequential; the reference decodes RING_ATTENTION through the MHA
        cache path) and the `seq` ranks compute alike."""
        return self.pmesh.without((SEQ,))

    def _run_node_spmd(self, n, ins, in_layouts, trainable, nontrainable,
                       ctx, remat: bool, pm):
        """One node on this rank's pieces (shard_rules.run_node) on the
        process mesh `pm`, its outputs laid out as its view says."""
        key = node_key(n)
        params = {**trainable.get(key, {}), **nontrainable.get(key, {})}
        w_layouts = self.param_specs().get(key, {})
        w_shapes = {wn: tuple(spec.shape.dims) for wn, spec in
                    n.attrs.weights(*self.graph.input_shapes(n)).items()}
        in_shapes = [tuple(d.size for d in s.dims)
                     for s in self.graph.input_shapes(n)]
        outs, lays = shard_rules.run_node(
            n, ins, in_layouts, in_shapes, params, w_layouts, w_shapes,
            pm, ctx, remat, self._prune)
        outs, lays = list(outs), list(lays)
        view = n.sharding
        for i in range(len(outs)):
            spec = view.output_spec(i) if view is not None else None
            if spec is None:
                continue
            target = self._prune(spec, [d.size for d in n.outputs[i].dims])
            outs[i] = spmd.redistribute(outs[i], pm, lays[i], target)
            lays[i] = target
        return outs, lays

    def _run_remat_group(self, group, values, rng, run_node, layouts=None):
        """One remat="hidden" group under torch.utils.checkpoint
        (non-reentrant): only its external inputs are saved for backward,
        the hidden activations inside are recomputed. `run_node(node,
        ins, in_layouts, ctx)` runs one member and returns (outputs, their
        layouts): the one-card lowering (layouts None), or _run_node_spmd
        on a rank's pieces, where `layouts` holds every value's layout.
        The group's output goes into `values` (its layout into
        `layouts`)."""
        members, out_key, ext = group
        out_layout = {}

        def group_fn(*xs):
            local = dict(zip(ext, xs))
            lays = {k: None if layouts is None else layouts[k] for k in ext}
            for gn in members:
                srcs = [(e.src, e.src_idx) for e in self.graph.in_edges(gn)]
                ctx = LowerCtx(device=self.device, mesh=self.mesh,
                               pmesh=self.pmesh if layouts is not None
                               else None,
                               training=True, seq_length=self.seq_length,
                               node_guid=gn.guid,
                               rng_seed=node_seed(rng, gn.guid))
                outs, ls = run_node(gn, [local[k] for k in srcs],
                                    [lays[k] for k in srcs], ctx)
                for i, (o, lay) in enumerate(zip(outs, ls)):
                    local[(gn.guid, i)] = o
                    lays[(gn.guid, i)] = lay
            out_layout["spec"] = lays[out_key]
            return local[out_key]

        values[out_key] = checkpoint(group_fn, *[values[k] for k in ext],
                                     use_reentrant=False)
        if layouts is not None:
            layouts[out_key] = out_layout["spec"]

    # ------------------------------------------------------------------
    # training and evaluation steps

    def loss_and_grads(self, trainable, nontrainable, labels, *inputs,
                       rng: Optional[Tuple[int, int]] = None,
                       state_out: Optional[dict] = None):
        """The loss of one batch (forward with training=True, the sink
        softmax fused into the loss, draws from the stream `rng` = (fit
        stream, step)) and the gradient of the loss plus the graph's MoE
        load-balance terms with respect to every trainable leaf. Returns
        (loss, logits, grads): the loss without those terms, as the
        reference reports it, loss and logits detached, grads a tree
        shaped like `trainable`; the running statistics the forward moved
        go to `state_out` (run_forward's)."""
        loss, logits, grads, _ = self._loss_and_grads(
            trainable, nontrainable, labels, *inputs, rng=rng,
            state_out=state_out)
        return loss, logits, grads

    def _loss_and_grads(self, trainable, nontrainable, labels, *inputs,
                        rng=None, state_out=None):
        """loss_and_grads, plus the layout of the logits it returns (None
        on one process). On a process mesh the gradients are this rank's
        pieces, a parameter's still partial over `data` (the train step
        reduces them)."""
        labels = self._maybe_repeat_labels(labels)
        leaves = [p for ws in trainable.values() for p in ws.values()]
        for p in leaves:
            p.requires_grad_(True)
        layout = None
        try:
            if self.pmesh is None:
                logits, aux = self.run_forward(
                    trainable, nontrainable, inputs, training=True,
                    skip_sink_softmax=self.fuse_loss_softmax,
                    return_aux=True, rng=rng, state_out=state_out)
                loss = compute_loss(self.loss_type, logits, labels,
                                    self._sink_is_softmax())
            else:
                logits, aux, layout = self._run_forward_spmd(
                    trainable, nontrainable, inputs, training=True,
                    skip_sink_softmax=self.fuse_loss_softmax, rng=rng,
                    state_out=state_out)
                loss, logits, layout = sharded_loss(
                    self.loss_type, logits, layout, labels,
                    self._sink_is_softmax(), self.pmesh, self.batch_axes,
                    self.seq_axes)
            # the gradient is the loss's plus the MoE load-balance
            # terms'; the loss reported is the loss alone
            grads = torch.autograd.grad(
                loss if aux is None else loss + aux, leaves,
                allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # a leaf the loss does not reach (AGGREGATE_SPEC reads only the
        # shape of its gate values) has a zero gradient, as jax.grad's
        it = iter(torch.zeros_like(p) if g is None else g
                  for g, p in zip(grads, leaves))
        grad_tree = {nk: {wn: next(it) for wn in ws}
                     for nk, ws in trainable.items()}
        return loss.detach(), logits.detach(), grad_tree, layout

    def _step_metrics(self, logits, layout, labels, loss):
        """compute_step_metrics; on a process mesh over the global batch:
        the means averaged over the batch's and the sequence's axes, the
        correct counts (a mean over each sample's tokens, times its rows)
        summed over the batch's and averaged over the sequence's. Logits
        cut on the vocabulary (those of the fused sparse
        cross-entropy `loss`) stay cut for accuracy and that
        cross-entropy (vocab_sharded_step_metrics); another metric
        gathers the vocabulary on the rank's rows."""
        labels = self._maybe_repeat_labels(labels)
        if self.pmesh is None or not self.metrics:
            return self._rescale_correct(compute_step_metrics(
                self.metrics, self.loss_type, logits, labels,
                self._sink_is_softmax()))
        pm = self.pmesh
        v_axes = pm.keep(layout[-1]) if logits.ndim >= 2 else ()
        with torch.no_grad():
            if v_axes and set(self.metrics) <= VOCAB_SHARDED_METRICS:
                m = vocab_sharded_step_metrics(self.metrics, logits, labels,
                                               loss, pm, v_axes)
            else:
                whole = spmd.redistribute(logits, pm, layout,
                                          tuple(layout[:-1]) + ((),))
                m = compute_step_metrics(self.metrics, self.loss_type,
                                         whole, labels,
                                         self._sink_is_softmax())
            m = self._rescale_correct(m)
            keys = sorted(m)
            deg_b = pm.degree(pm.keep(self.batch_axes))
            deg_s = pm.degree(pm.keep(self.seq_axes))
            vec = torch.stack([m[k].float() / (
                deg_s if k == "accuracy_correct" else deg_b * deg_s)
                for k in keys])
            axes = pm.live(self.batch_axes + self.seq_axes)
            vec = pm.all_reduce(vec, axes, inplace=True)
        return dict(zip(keys, vec.unbind()))

    def _maybe_repeat_labels(self, labels):
        """AGGREGATE_SPEC's k rows per sample need each label k times."""
        if self.label_repeats > 1:
            return torch.repeat_interleave(labels, self.label_repeats, dim=0)
        return labels

    def _rescale_correct(self, step_metrics):
        """The correct count averaged over the slots, so it stays on the
        per-sample scale fit and eval sum."""
        if self.label_repeats > 1 and "accuracy_correct" in step_metrics:
            step_metrics["accuracy_correct"] = (
                step_metrics["accuracy_correct"] / self.label_repeats)
        return step_metrics

    def _sink_is_softmax(self) -> bool:
        """The logits still end in the sink softmax (not fused into the
        loss)."""
        return self.last_op_is_softmax and not self.fuse_loss_softmax

    def train_step(self, trainable, nontrainable, opt_state, labels,
                   *inputs, rng: Optional[Tuple[int, int]] = None):
        """One training step (_train_step), inside an obs span named
        "train_step", so under obs.enable() train steps land on the host
        trace beside the serving ticks."""
        with obs.span("train_step"):
            return self._train_step(trainable, nontrainable, opt_state,
                                    labels, *inputs, rng=rng)

    def _train_step(self, trainable, nontrainable, opt_state, labels,
                    *inputs, rng: Optional[Tuple[int, int]] = None):
        """One training step: the loss and gradients of `loss_and_grads`
        (dropout drawn from the stream `rng` = (fit stream, step), (0, 0)
        when None), then the optimizer's update of the fp32 masters and
        the state, in place. Returns (trainable, nontrainable, opt_state,
        metrics); the non-trainable tree returned is a new one holding the
        running statistics the step moved (the reference's state_updates
        merged in); metrics (the compiled metrics and "loss") are 0-d
        tensors on the device, so the step never waits for the card. With
        donate=False (FFConfig.donate_buffers) the trees passed in are
        left intact and the step updates copies."""
        for ws in trainable.values():
            for p in ws.values():
                if p.dtype != torch.float32:
                    raise ValueError(
                        "train_step updates fp32 master weights; pass "
                        "Executor.master_params(trainable)")
        if not self.donate:
            trainable, opt_state = _clone_tree(trainable), _clone_tree(
                opt_state)
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        loss, logits, grad_tree, layout = self._loss_and_grads(
            trainable, nontrainable, labels, *inputs, rng=rng,
            state_out=state)
        metrics = self._step_metrics(logits, layout, labels, loss)
        metrics["loss"] = loss
        del logits
        if self.pmesh is None:
            trainable, opt_state = self.optimizer.update(
                grad_tree, trainable, opt_state)
        else:
            opt_state = self._update_sharded(grad_tree, trainable, opt_state)
        return (trainable, merge_state(nontrainable, state), opt_state,
                metrics)

    def _update_sharded(self, grad_tree, trainable, opt_state):
        """The optimizer's step on a process mesh: each gradient summed
        over `data` and `seq` (a parameter replicated over them holds its
        rank's rows' and tokens' part), then the update of this rank's
        pieces; under ZeRO-1 the sum is a reduce-scatter onto the rank's
        slice, the update runs on the slice, and the new slices are
        all-gathered into the parameter."""
        pm = self.pmesh
        dax = pm.live(GRAD_AXES)
        seen = set()

        def reduced(g):
            # the sum in place: the step owns its gradients, but autograd
            # may hand two leaves one buffer, which is then copied first
            key = g.untyped_storage().data_ptr()
            if key in seen:
                g = g.clone()
            seen.add(key)
            return pm.all_reduce(g, dax, inplace=True)

        if self.zero_dims is None or not dax:
            grads = {nk: {wn: reduced(g) for wn, g in ws.items()}
                     for nk, ws in grad_tree.items()}
            self.optimizer.update(grads, trainable, opt_state)
            return opt_state
        grads = {}
        for nk, ws in grad_tree.items():
            grads[nk] = {}
            for wn, g in ws.items():
                dim = self.zero_dims[nk][wn]
                grads[nk][wn] = (reduced(g) if dim is None
                                 else pm.reduce_scatter(g, dim, dax))
        slices = self._zero_slices(trainable)
        self.optimizer.update(grads, slices, opt_state)
        for nk, ws in trainable.items():
            for wn, p in ws.items():
                dim = self.zero_dims[nk][wn]
                if dim is not None:
                    p.copy_(pm.all_gather(slices[nk][wn], dim, dax))
        return opt_state

    def eval_step(self, trainable, nontrainable, labels, *inputs):
        """The loss and the compiled metrics of one batch, as 0-d tensors
        on the device (inside an obs span named "eval_step" under
        obs.enable())."""
        with obs.span("eval_step"):
            return self._eval_step(trainable, nontrainable, labels, *inputs)

    @torch.no_grad()
    def _eval_step(self, trainable, nontrainable, labels, *inputs):
        sink_is_sm = self._sink_is_softmax()
        if self.pmesh is not None:
            logits, _, layout = self._run_forward_spmd(
                trainable, nontrainable, inputs, training=False,
                skip_sink_softmax=self.fuse_loss_softmax, rng=None,
                state_out=None)
            loss, logits, layout = sharded_loss(
                self.loss_type, logits, layout,
                self._maybe_repeat_labels(labels), sink_is_sm, self.pmesh,
                self.batch_axes, self.seq_axes)
            m = self._step_metrics(logits, layout, labels, loss)
            m["loss"] = loss
            return m
        labels = self._maybe_repeat_labels(labels)
        logits = self.run_forward(trainable, nontrainable, inputs,
                                  skip_sink_softmax=self.fuse_loss_softmax)
        m = self._rescale_correct(compute_step_metrics(
            self.metrics, self.loss_type, logits, labels, sink_is_sm))
        m["loss"] = compute_loss(self.loss_type, logits, labels, sink_is_sm)
        return m

    @torch.no_grad()
    def forward(self, trainable, nontrainable, *inputs):
        """The sink output (the real softmax included) for one batch
        (the reference's forward_fn()); on a process mesh the whole
        output on every rank, from each rank's piece of the batch."""
        if self.pmesh is not None:
            out, _, layout = self._run_forward_spmd(
                trainable, nontrainable, inputs, training=False,
                skip_sink_softmax=False, rng=None, state_out=None)
            return self.pmesh.gather(out, layout)
        return self.run_forward(trainable, nontrainable, inputs)

    # ------------------------------------------------------------------
    # dense KV caches + their decode step

    def init_kv_cache(self, batch: int, max_len: int,
                      dtype: Optional[torch.dtype] = None):
        """Per-attention-node zeroed (batch, max_len, Hkv, D) "k"/"v"
        buffers on the device for dense autoregressive decoding, at each
        attention's activation dtype unless `dtype` is given.
        RING_ATTENTION nodes decode through the same MHA cache branch (a
        decode step has no sequence to cut); a PIPELINE composite gets
        layer-stacked (layers, batch, max_len, Hkv, D) buffers, which its
        lowering threads through the blocks a layer slice each. On a
        process mesh each rank's buffers hold its rows (`batch` cut as the
        batch is) and its kv heads (cut as wk is), the same on every
        `seq` rank."""
        caches = {}
        rows, specs = batch, None
        if self.pmesh is not None:
            pm = self.decode_mesh()
            deg = pm.degree(pm.keep(self.batch_axes))
            if batch % deg:
                raise ValueError(f"a batch of {batch} rows does not split "
                                 f"over {self.batch_axes} of degree {deg}")
            rows, specs = batch // deg, self.param_specs()
        for n in self.topo:
            ins = self.graph.input_shapes(n)
            dt = dtype or (ins[0].dtype.torch_dtype if ins
                           else torch.bfloat16)
            if n.op_type in _ATTENTION_OPS:
                kv = n.attrs.num_kv
                if specs is not None:
                    kv //= pm.degree(pm.keep(specs[node_key(n)]["wk"][1]))
                shape = (rows, max_len, kv, n.attrs.kdim)
            elif n.op_type == OpType.PIPELINE:
                a = n.attrs
                shape = (a.layers, rows, max_len, a.kv_heads,
                         ins[0].dims[-1].size // a.heads)
            else:
                continue
            caches[node_key(n)] = {
                name: torch.zeros(shape, dtype=dt, device=self.device)
                for name in ("k", "v")}
        if not caches:
            raise ValueError(
                "generate() needs attention nodes (MULTIHEAD_ATTENTION, "
                "RING_ATTENTION, or a PIPELINE composite)")
        return caches

    @torch.inference_mode()
    def decode_fn(self, trainable, nontrainable, caches, pos, *inputs):
        """(params, caches, pos, ids) -> (probs, caches): one prefill or
        decode step through the dense-cache attention (ops/torch_ops.py
        cached_attention). `pos` is a Python int (every row at the same
        position: generate, the dense admission's prefill) or a (B,)
        tensor of per-row positions (the dense server's decode). The
        caches are written in place and returned. (The reference's
        decode_fn() returns a jitted step; here the method is the
        step.) On a process mesh `inputs` are the whole batch: each rank
        runs its rows over its caches (init_kv_cache) and every rank gets
        the whole output."""
        cache_out: Dict[str, Dict[str, torch.Tensor]] = {}
        if self.pmesh is None:
            out = self.run_forward(trainable, nontrainable, inputs,
                                   kv_caches=caches, cache_position=pos,
                                   cache_out=cache_out)
            return out, cache_out
        pm = self.decode_mesh()
        inputs = [pm.shard(x, sp).contiguous()
                  for x, sp in zip(inputs, self.input_specs())]
        out, _, layout = self._run_forward_spmd(
            trainable, nontrainable, inputs, training=False,
            skip_sink_softmax=False, rng=None, state_out=None,
            kv_caches=caches, cache_position=pos, cache_out=cache_out)
        return pm.gather(out, layout), cache_out

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
                raise ValueError(
                    "paged decode does not support PIPELINE composite "
                    "graphs (their KV cache is threaded through the layer "
                    "scan); serve with paged=False")
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

    def can_paged_decode(self) -> bool:
        """True when this graph has the shape paged decode serves: token
        inputs, a token-level (b, s, vocab) sink, attention nodes, and no
        PIPELINE composite (whose cache is threaded through the layer
        stack). A pooled-classification graph (BERT's (b, classes) head)
        has attention but nothing to decode."""
        has_attn = any(n.op_type in _ATTENTION_OPS for n in self.topo)
        no_pipe = all(n.op_type != OpType.PIPELINE for n in self.topo)
        token_in = (len(self.input_nodes) == 1
                    and self.input_nodes[0].outputs[0].ndim == 2
                    and not self.input_nodes[0].outputs[0].dtype.torch_dtype
                    .is_floating_point)
        token_out = self.sink.outputs[0].ndim >= 3
        return has_attn and no_pipe and token_in and token_out

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

    @torch.inference_mode()
    def verify_fn(self, trainable, nontrainable, caches, page_tables, pos,
                  depths, tree_mask, ids):
        """(params, pools, page_tables, pos, depths, tree_mask, ids) ->
        (probs, pools): one speculative TREE-VERIFY step (spec/). `ids` is
        (B, max_nodes), each entry's flattened draft tree with node 0 the
        last sampled token; `depths` the (B, max_nodes) node depths and
        `tree_mask` the (B, max_nodes, max_nodes) ancestor relation. Node
        j's K/V row is written at cache row pos + j, and probs[:, j] is the
        next-token distribution after the path root..j. It is the ragged
        step with every window row live: a padding node sees only itself
        and nothing sees it, by the mask, not by q_len."""
        B, S = ids.shape
        q_lens = torch.full((B,), S, dtype=torch.int32, device=ids.device)
        return self.ragged_step_fn(trainable, nontrainable, caches,
                                   page_tables, pos, q_lens, depths,
                                   tree_mask, ids)

    @torch.inference_mode()
    def paged_commit_fn(self, caches, page_tables, src, dst):
        """(pools, page_tables, src, dst) -> pools: copy the accepted tree
        path's K/V rows onto the contiguous committed positions
        (speculative rollback, spec/), in place. src/dst are (B, C) int32
        cache-row positions resolved through each entry's page table;
        unused entries point a row at itself, so one call shape serves
        every acceptance outcome. Rejected rows are not touched: they sit
        past the advanced write head, where the position mask hides them.

        An fp pool gathers every source row, then scatters them once. An
        int8 pool (scale sidecar, paged/quant.py) copies scale-aware, in
        the reference's order: the destination pages' scales grow by a
        scatter-max of the source pages' scales; the destination pages'
        rows are re-quantized at old / new; then the source rows are read
        (from the pages as re-quantized) and each is dequantized at its
        source page's new scale and re-quantized at the destination's.
        Every duplicate destination receives identical values (self-copy
        entries at ratio 1), so the winner among duplicates does not
        matter."""
        bidx = torch.arange(src.shape[0], device=src.device)[:, None]
        tables = page_tables.long()
        src, dst = src.long(), dst.long()
        for bufs in caches.values():
            P = bufs["k"].shape[1]
            sp, so = tables[bidx, src // P], src % P
            dp, do = tables[bidx, dst // P], dst % P
            for n in ("k", "v"):
                if n + "_scale" in bufs:
                    _commit_rows_quant(bufs[n], bufs[n + "_scale"], sp, so,
                                       dp, do)
                else:
                    bufs[n][dp, do] = bufs[n][sp, so]
        return caches

    @torch.inference_mode()
    def paged_megastep_fn(self, trainable, nontrainable, caches,
                          page_tables, pos, toks, temps, remaining,
                          cap_rows, active, gen, *, max_ticks: int,
                          ticks: Optional[int] = None, eos_id=None):
        """A decode MEGASTEP: up to `max_ticks` single-token decode ticks
        from device-resident state, with no read back to the host (the
        reference's `lax.while_loop`, executor.py paged_megastep_fn).

        (params, pools, page_tables, pos, toks, temps, remaining,
         cap_rows, active, gen) ->
            (pools, out_tokens, done, ticks_run, gen_states)

        Per-slot inputs are (slots,) device tensors: `pos` the next write
        row, `toks` the last sampled token, `remaining` the tokens the
        request may still emit, `cap_rows` the rows its allocated pages
        cover, `active` which slots decode. `ticks` (default max_ticks)
        ticks are enqueued, each the window-1 ragged step and one
        pick_tokens draw on `gen`. A tick runs only where the reference's
        loop would run it: no active slot has finished yet (remaining
        spent, or `eos_id` sampled) and every active slot's next write row
        lies inside its pages. A tick that does not run is predicated off
        on the device: its q_lens are 0 (no attention work, K/V writes to
        the null page), its tokens -1, and the tick counter stands still.
        A caller that knows pos, cap_rows and remaining on the host
        enqueues exactly the ticks that can run, so only an eos sampled
        mid-megastep leaves ticks predicated off.

        Returns the pools (updated in place), the (max_ticks, slots) int32
        token buffer (-1 on inactive rows and unrun ticks), the done flags,
        the 0-d count of ticks run, and the generator's state before each
        enqueued tick and after the last: `gen.set_state(gen_states[n])`
        after reading n back puts the generator where n one-tick decodes
        would have left it."""
        from flexflow_tpu_torch.serving import pick_tokens

        N = int(max_ticks)
        n = N if ticks is None else int(ticks)
        if not 0 <= n <= N:
            raise ValueError(f"ticks must lie in [0, {N}], got {ticks}")
        slots = pos.shape[0]
        dev = pos.device
        depths = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        anc = torch.ones((slots, 1, 1), dtype=torch.bool, device=dev)
        out = torch.full((N, slots), -1, dtype=torch.int32, device=dev)
        done = torch.zeros_like(active)
        halted = torch.zeros((), dtype=torch.bool, device=dev)
        ran = torch.zeros((), dtype=torch.int32, device=dev)
        p, tk, rem = pos, toks, remaining
        states = []
        for t in range(n):
            room = torch.all(~active | (p + 1 <= cap_rows))
            go = room & ~halted
            run = active & go
            probs, caches = self.ragged_step_fn(
                trainable, nontrainable, caches, page_tables, p,
                run.to(torch.int32), depths, anc, tk[:, None])
            states.append(gen.get_state())
            nxt = pick_tokens(probs[:, -1, :], temps, gen)
            out[t] = torch.where(run, nxt, -1)
            tk = torch.where(run, nxt, tk)
            p = torch.where(run, p + 1, p)
            rem = torch.where(run, rem - 1, rem)
            fin = run & (rem <= 0)
            if eos_id is not None:
                fin = fin | (run & (nxt == int(eos_id)))
            done = done | fin
            ran = ran + go.to(torch.int32)
            halted = halted | ~room | torch.any(fin)
        states.append(gen.get_state())
        return caches, out, done, ran, states

    @torch.inference_mode()
    def paged_mixed_megastep_fn(self, trainable, nontrainable, caches,
                                page_tables, seq, pos, pf_pos, pf_target,
                                temps, remaining, cap_rows, dec_active,
                                pf_active, spec_mask, gen, *,
                                max_ticks: int, window: int = 1,
                                depth: int = 0,
                                ticks: Optional[int] = None, eos_id=None):
        """The UNIVERSAL megastep: up to `max_ticks` fused ticks that carry
        decode rows, mid-prefill chunk rows and on-device drafted
        speculative chains in one dispatch, with no read back to the host
        (the reference's mixed `lax.while_loop`, executor.py
        paged_mixed_megastep_fn).

        (params, pools, page_tables, seq, pos, pf_pos, pf_target, temps,
         remaining, cap_rows, dec_active, pf_active, spec_mask, gen) ->
            (pools, seq, out_tokens, out_counts, done, pf_fin, ticks_run,
             gen_states)

        `seq` is the (slots, Lbuf + 1) int32 ledger of committed tokens
        (a mid-prefill slot's row holds its whole prompt; column Lbuf is
        the trash column of masked scatters). Every tick is ONE ragged
        step of window Wl = max(window, depth + 1): a live prefill row
        feeds seq[pf_pos .. pf_pos + take - 1] (take = min(window,
        pf_target - pf_pos)), a plain decode row seq[pos], and a greedy
        `spec_mask` row (with depth > 0) its width-1 unigram chain:
        seq[pos] and the `depth` tokens after the most recent earlier
        occurrence of seq[pos] (zeros where there is none). Acceptance is
        the device argmax walk over the chain; a drafting row emits the
        accepted prefix and the verifier's next token, a decode row and a
        completing prefill one pick_tokens draw of the tick's (slots, V)
        draw. Emitted tokens scatter back into `seq`. The chain is
        written at rows pos .. pos + depth, so the accepted prefix needs
        no commit; rejected rows sit past the advanced write head, and the
        next tick's depth + 1 writes start at the first of them, before
        its attention reads.

        `ticks` (default max_ticks) ticks are enqueued. A tick runs only
        where the reference's loop runs it: no slot finished and no
        prefill chunk completed on an earlier tick, and every decoding
        slot's next rows (pos + depth + 1 drafting, pos + 1 decoding) lie
        inside `cap_rows`. A tick that must not run is predicated off on
        the device: its q_lens are 0 (no attention work, K/V writes to the
        null page), nothing is scattered into `seq` but the trash column,
        its tokens are -1 and the tick counter stands still. The host
        knows every stop but an eos and a drafting row's advance, so it
        enqueues the ticks that may run counting a drafting row at one
        token a tick; the rest are predicated off.

        Returns the pools and `seq` (both updated in place), the
        (max_ticks, slots, depth + 1) int32 tokens (-1 padded), the
        (max_ticks, slots) emission counts, the done and prefill-finished
        flags, the 0-d count of ticks run, and the generator's state
        before each enqueued tick and after the last (set_state(
        gen_states[n]) after reading n back puts the generator where n
        unfused ticks would have left it)."""
        from flexflow_tpu_torch.serving import pick_tokens

        N = int(max_ticks)
        n = N if ticks is None else int(ticks)
        if not 0 <= n <= N:
            raise ValueError(f"ticks must lie in [0, {N}], got {ticks}")
        W = max(int(window), 1)
        D = max(int(depth), 0)
        Wl = max(W, D + 1)
        E = D + 1  # emission capacity a slot a tick
        slots = pos.shape[0]
        dev = pos.device
        Lb = seq.shape[1] - 1
        i32 = torch.int32
        win = torch.arange(Wl, dtype=torch.int64, device=dev)
        ej = torch.arange(E, dtype=torch.int64, device=dev)
        idxs = torch.arange(seq.shape[1], dtype=torch.int64, device=dev)
        depths = win.to(i32).expand(slots, Wl).contiguous()
        anc = torch.tril(torch.ones((Wl, Wl), dtype=torch.bool, device=dev)
                         ).expand(slots, Wl, Wl).contiguous()
        spec_on = (dec_active & spec_mask if D > 0
                   else torch.zeros_like(dec_active))
        out = torch.full((N, slots, E), -1, dtype=i32, device=dev)
        cnts = torch.zeros((N, slots), dtype=i32, device=dev)
        done = torch.zeros_like(dec_active)
        pf_fin = torch.zeros_like(pf_active)
        halted = torch.zeros((), dtype=torch.bool, device=dev)
        ran = torch.zeros((), dtype=i32, device=dev)
        p, pfp, rem = pos, pf_pos, remaining
        states = []
        for t in range(n):
            need = torch.where(spec_on, p + D + 1, p + 1)
            room = torch.all(~dec_active | (need <= cap_rows))
            go = room & ~halted
            pf_live = pf_active & (pfp < pf_target) & go
            take = torch.where(pf_live, torch.clamp(pf_target - pfp, max=W),
                               0)
            q_lens = torch.where(pf_live, take, torch.where(
                spec_on, D + 1, dec_active.to(i32))) * go.to(i32)
            base = torch.where(pf_live, pfp, p)
            cols = (base.long()[:, None] + win[None, :]).clamp(0, Lb)
            ids = torch.gather(seq, 1, cols)
            if D > 0:
                last = torch.gather(seq, 1, p.long().clamp(0, Lb)[:, None])
                hit = (seq == last) & (idxs[None, :] < p.long()[:, None])
                j = torch.where(hit, idxs[None, :], -1).amax(dim=1)
                dcols = j[:, None] + 1 + ej[None, :D]
                dvalid = (j[:, None] >= 0) & (dcols <= p.long()[:, None])
                draft = torch.where(dvalid, torch.gather(
                    seq, 1, dcols.clamp(0, Lb)), 0)
                chain = torch.cat([last, draft, seq.new_zeros(
                    (slots, Wl - E))], dim=1)
                ids = torch.where(spec_on[:, None], chain, ids)
            probs, caches = self.ragged_step_fn(
                trainable, nontrainable, caches, page_tables, base.to(i32),
                q_lens.to(i32), depths, anc, ids)
            lastrow = (q_lens.long() - 1).clamp(0, Wl - 1)
            probs_last = torch.gather(
                probs, 1, lastrow[:, None, None].expand(
                    -1, 1, probs.shape[-1]))[:, 0, :]
            states.append(gen.get_state())
            picked = pick_tokens(probs_last, temps, gen)
            completing = pf_live & (pfp + take >= pf_target)
            emitting = (dec_active & go) | completing
            if D > 0:
                preds = torch.argmax(probs[:, :E, :], dim=-1).to(i32)
                match = (draft == preds[:, :D]) & spec_on[:, None]
                acc = torch.cumprod(match.to(i32), dim=1).sum(dim=1)
                base_cnt = torch.where(spec_on, acc + 1, 1)
                emit = torch.where(spec_on[:, None], preds, torch.where(
                    ej[None, :] == 0, picked[:, None], -1))
            else:
                base_cnt = torch.ones_like(rem)
                emit = picked[:, None]
            cnt = torch.where(emitting, torch.minimum(
                base_cnt, rem.clamp(min=0)), 0).to(i32)
            valid = ej[None, :] < cnt[:, None]
            if eos_id is not None:
                is_eos = valid & (emit == int(eos_id))
                first = torch.where(is_eos, ej[None, :], E).amin(dim=1)
                cnt = torch.where(first < E, torch.minimum(
                    cnt, (first + 1).to(i32)), cnt)
                valid = ej[None, :] < cnt[:, None]
            oldc = torch.where(completing, pf_target, p + 1)
            scols = torch.where(valid, (oldc.long()[:, None] + ej[None, :])
                                .clamp(0, Lb), Lb)
            seq.scatter_(1, scols, emit.to(seq.dtype))
            p = torch.where(cnt > 0, oldc + cnt - 1, p)
            pfp = torch.where(pf_live, pfp + take, pfp)
            rem = torch.where(emitting, rem - cnt, rem)
            fin = emitting & (cnt > 0) & (rem <= 0)
            if eos_id is not None:
                fin = fin | (first < E)
            out[t] = torch.where(valid, emit, -1)
            cnts[t] = cnt
            done = done | fin
            pf_fin = pf_fin | completing
            ran = ran + go.to(i32)
            halted = halted | ~room | torch.any(fin) | torch.any(completing)
        states.append(gen.get_state())
        return caches, seq, out, cnts, done, pf_fin, ran, states


def _lower_node(n, ins, trainable, nontrainable, ctx):
    """One node through its one-card lowering: (outputs, no layouts)."""
    key = node_key(n)
    params = {**trainable.get(key, {}), **nontrainable.get(key, {})}
    outs = get_lowering(n.op_type)(n.attrs, ins, params, ctx)
    return outs, [None] * len(outs)


def _clone_tree(tree):
    """A copy of a nested dict of tensors (other leaves kept)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _commit_rows_quant(buf, sc, sp, so, dp, do):
    """The int8 half of Executor.paged_commit_fn for one of K or V, in
    place: buf (N, P, Hkv, D) int8, sc (N, Hkv) fp32, sp/so and dp/do the
    (B, C) source and destination pages and offsets."""
    from flexflow_tpu_torch.paged.quant import QMAX, SCALE_EPS

    Hkv = sc.shape[1]
    sc2 = sc.clone()
    sc2.scatter_reduce_(0, dp.reshape(-1, 1).expand(-1, Hkv),
                        sc[sp].reshape(-1, Hkv), "amax", include_self=True)
    old_d, new_d = sc[dp], sc2[dp]                          # (B, C, Hkv)
    ratio = torch.where(new_d > 0, old_d / new_d.clamp_min(SCALE_EPS),
                        torch.zeros_like(old_d))
    blk = buf[dp].float() * ratio[:, :, None, :, None]
    buf[dp] = torch.round(blk).clamp_(-QMAX, QMAX).to(buf.dtype)
    den = torch.where(new_d > 0, new_d, torch.ones_like(new_d))[..., None]
    row = buf[sp, so].float() * sc2[sp][..., None] / den
    buf[dp, do] = torch.round(row).clamp_(-QMAX, QMAX).to(buf.dtype)
    sc.copy_(sc2)
