"""Per-op and per-edge cost model
(counterpart of flexflow_tpu/search/cost_model.py, the same logic).

Reference analog: Simulator::measure_operator_cost (simulator.cc:537) +
estimate_xfer_cost (graph.cc:1438). The reference MEASURES each op's kernels
with CUDA events and caches by (op params, machine view); on TPU per-op
measurement is less faithful (XLA fuses across ops, and each sharding change
recompiles), so the default is an analytic roofline against the
TPUMachineModel; `flexflow_tpu_torch.search.measured.MeasuredCostModel` is the
measured path — it times jitted single ops on the local chip, caches by
(attrs, shard shapes, dtype) exactly like strict_hash_to_operator_cost,
and can calibrate this model's efficiency knobs (enable with
FFConfig.measure_costs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

from flexflow_tpu_torch.ffconst import OpType, PARALLEL_OP_TYPES
from flexflow_tpu_torch.parallel.sharding import ShardingView, Spec
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.search.machine_model import TPUMachineModel


def _in_shapes(graph, node):
    """Input shapes via edges, falling back to the cache stamped by
    infer_shapes() (subgraphs from search splits drop producer nodes)."""
    ins = graph.input_shapes(node)
    if node.in_shapes and len(ins) < len(node.in_shapes):
        return list(node.in_shapes)
    return ins


def is_pipe_sharded(node: Node, view: Optional[ShardingView]) -> bool:
    """True when a PIPELINE composite's assigned view pipe-shards the
    stacked weights (probe shared by the cost/traffic models — the view
    shape's source of truth is parallel.sharding.pipeline_pipe_view)."""
    if node.op_type != OpType.PIPELINE or view is None:
        return False
    ln1 = view.weight_specs.get("ln1")
    return bool(ln1 and ln1[0] and "pipe" in ln1[0])


def pipeline_compute_factor(node: Node, view: Optional[ShardingView],
                            axis_sizes: Dict[str, int]) -> float:
    """GPipe bubble multiplier for a pipe-sharded PIPELINE composite:
    (M+P-1)/M — every stage idles for P-1 of the M+P-1 schedule ticks.
    1.0 for anything else. Shared by the analytic and measured cost models
    so measured cache hits pay the bubble too."""
    if not is_pipe_sharded(node, view):
        return 1.0
    p = axis_sizes.get("pipe", 1)
    m = max(getattr(node.attrs, "n_microbatches", 1), 1)
    return (m + p - 1) / m if p > 1 else 1.0


def spec_degree(spec: Optional[Spec], axis_sizes: Dict[str, int],
                ndim: Optional[int] = None) -> int:
    """Total sharding degree implied by a spec."""
    if spec is None:
        return 1
    d = 1
    for axes in spec:
        for a in axes:
            d *= axis_sizes.get(a, 1)
    return d


def dim_degree(spec: Optional[Spec], dim: int, axis_sizes: Dict[str, int]) -> int:
    if spec is None or dim >= len(spec):
        return 1
    d = 1
    for a in spec[dim]:
        d *= axis_sizes.get(a, 1)
    return d


@dataclasses.dataclass
class CostModel:
    machine: TPUMachineModel
    axis_sizes: Dict[str, int]
    # backward ~2x forward FLOPs (two GEMMs per forward GEMM)
    backward_factor: float = 2.0
    # SOAP dimension gates (reference --enable-parameter-parallel /
    # --enable-attribute-parallel, model.cc:3613-3617): restrict the view
    # space the search may enumerate. TPU-native default is all-on.
    param_parallel: bool = True
    attr_parallel: bool = True

    # ------------------------------------------------------------------

    def node_compute_time(self, graph: Graph, node: Node, view: Optional[ShardingView],
                          training: bool = True) -> float:
        """Fwd (+bwd) time of one op's shard under `view`."""
        if node.op_type in PARALLEL_OP_TYPES or node.attrs is None:
            return 0.0
        ins = _in_shapes(graph, node)
        outs = list(node.outputs)
        flops = node.attrs.flops(ins, outs)
        byts = node.attrs.bytes_accessed(ins, outs)
        degree = 1
        if view is not None:
            degree = max(
                spec_degree(view.output_spec(0), self.axis_sizes),
                max(
                    (spec_degree(s, self.axis_sizes) for s in view.weight_specs.values()),
                    default=1,
                ),
            )
        degree = max(degree, 1)
        # a pipe-sharded PIPELINE composes DISJOINT axes: batch over data
        # (output spec) x layers over pipe (weight spec) — the degrees
        # multiply, where max() would undercount by the data factor
        if (node.op_type == OpType.PIPELINE
                and pipeline_compute_factor(node, view, self.axis_sizes) > 1.0):
            out_deg = spec_degree(view.output_spec(0), self.axis_sizes)
            degree = max(out_deg, 1) * self.axis_sizes.get("pipe", 1)
        factor = (1.0 + self.backward_factor) if training else 1.0
        t = self.machine.compute_time(flops * factor / degree, byts * factor / degree)
        return t * pipeline_compute_factor(node, view, self.axis_sizes)

    def node_comm_time(self, graph: Graph, node: Node,
                       view: Optional[ShardingView],
                       training: bool = True) -> float:
        """Collective cost attributable to the node itself (sum of
        node_comm_events)."""
        return sum(t for _, t in
                   self.node_comm_events(graph, node, view, training))

    def node_comm_events(self, graph: Graph, node: Node,
                         view: Optional[ShardingView],
                         training: bool = True):
        """Collective cost attributable to the node itself, as a list of
        (mesh_axes, seconds) events — the per-axis breakdown the per-device
        event simulator schedules onto ICI channels (the reference expands
        comm into routed per-link SimTasks, simulator.h:810; summing the
        events gives node_comm_time):
        - parallel ops (Reduction/Combine/Repartition/AllToAll) price the
          collective GSPMD will emit for them;
        - a linear/conv whose contraction dim is sharded produces a partial
          sum -> all-reduce of the output (the row-TP allreduce)."""
        ins = _in_shapes(graph, node)

        def axes_degree(axes) -> int:
            from flexflow_tpu_torch.parallel.comm_spec import (
                axes_degree as _shared,
            )

            return _shared(axes, self.axis_sizes)

        if node.op_type == OpType.REDUCTION and ins:
            axes = getattr(node.attrs, "axes", ()) or ("model",)
            return [(tuple(axes), self.machine.all_reduce_time(
                ins[0].global_bytes(), axes_degree(axes), axes=tuple(axes)
            ))]
        if node.op_type == OpType.COMBINE and ins:
            axes = getattr(node.attrs, "axes", ()) or ("model",)
            deg = max(axes_degree(axes), 2)
            return [(tuple(axes), self.machine.all_gather_time(
                ins[0].global_bytes(), deg, axes=tuple(axes)
            ))]
        if node.op_type == OpType.ALL_TO_ALL and ins:
            axes = getattr(node.attrs, "axes", ())
            deg = max(axes_degree(axes), 2)
            return [(tuple(axes), self.machine.all_to_all_time(
                ins[0].global_bytes(), deg, axes=tuple(axes)
            ))]
        if node.op_type == OpType.FUSED_PARALLEL and ins:
            # fused chain: pay each step's bandwidth but ONE latency term
            # (the reference fuses the chain into a single task,
            # fused_parallel_op.cc)
            total, lat = 0.0, 0.0
            used_axes = []
            nbytes = ins[0].global_bytes()
            for kind, _dim, axes in node.attrs.steps:
                # same degrees AND axis names as the unfused node branches
                # above: reduction/combine default to ("model",) like the
                # REDUCTION/COMBINE branches; all_to_all keeps its raw axes
                # like the ALL_TO_ALL branch — so fusing never changes a
                # step's priced cost
                if kind == "all_to_all":
                    axes = tuple(axes or ())
                else:
                    axes = tuple(axes or ("model",))
                deg = axes_degree(axes)
                if kind == "reduction":
                    t = self.machine.all_reduce_time(nbytes, deg, axes=axes)
                elif kind in ("combine", "replicate"):
                    t = self.machine.all_gather_time(nbytes, max(deg, 2),
                                                     axes=axes)
                    deg = max(deg, 2)
                elif kind == "all_to_all":
                    t = self.machine.all_to_all_time(nbytes, max(deg, 2),
                                                     axes=axes)
                    deg = max(deg, 2)
                else:  # repartition: local slice
                    t = 0.0
                if deg <= 1:
                    continue
                used_axes.extend(a for a in axes if a not in used_axes)
                lat = max(lat, self.machine.ici_latency * deg)
                total += max(t - self.machine.ici_latency * deg, 0.0)
            if total + lat <= 0.0:
                return []
            return [(tuple(used_axes), total + lat)]
        if node.op_type in PARALLEL_OP_TYPES:
            return []
        # expert parallelism: an EXPERTS op whose weight stack is sharded
        # over the expert axis pays a token all-to-all INTO the experts
        # (dispatch) and a partial-sum all-reduce OUT (combine) — the
        # lowering's combine gathers every token's k expert rows and
        # psums the weighted partial outputs over the expert axis
        # (jax_ops._experts slot gather + sum(axis=0)); pricing a second
        # all-to-all here was the divergence the hloaudit pass caught
        # against the lowered HLO (the reference prices Group_by/Aggregate
        # data movement through Legion partitions)
        if node.op_type == OpType.EXPERTS and view is not None and ins:
            w1 = view.weight_specs.get("w1")
            if w1 and w1[0]:
                deg = axes_degree(w1[0])
                if deg > 1:
                    dispatch = self.machine.all_to_all_time(
                        ins[0].global_bytes(), deg, axes=tuple(w1[0])
                    )
                    combine = self.machine.all_reduce_time(
                        node.outputs[0].global_bytes(), deg,
                        axes=tuple(w1[0])
                    )
                    return [(tuple(w1[0]), dispatch),
                            (tuple(w1[0]), combine)]
        # sequence-parallel attention: the comm that makes ring attention
        # win. A plain MULTIHEAD_ATTENTION under a seq-sharded view is
        # executable (the shard_map flash wrapper keeps S local, so GSPMD
        # all-gathers q/k/v first) but pays that gather serially;
        # RING_ATTENTION instead ppermutes k/v blockwise, overlapping the
        # transfer with per-block attention compute — only the unhidden
        # remainder is charged (ulysses: two all-to-all exchange legs).
        # WHAT is moved comes from attention_comm_spec (shared with the
        # lowering via parallel.comm_spec and cross-checked by fflint);
        # this loop only converts declared steps into seconds. Training
        # doubles every seq-parallel leg: the backward of an all-gather is
        # a reduce-scatter of the same bytes, the backward of an
        # all-to-all is its mirror, and the ring's backward pass
        # re-permutes k/v AND accumulates dk/dv.
        if (node.op_type in (OpType.MULTIHEAD_ATTENTION,
                             OpType.RING_ATTENTION)
                and view is not None and node.outputs
                and node.outputs[0].ndim >= 3):
            attn_events = []
            bwd = 2.0 if training else 1.0
            for st in self.attention_comm_spec(graph, node, view):
                deg = axes_degree(st.axes)
                if st.kind == "all_reduce":
                    ar = self.machine.all_reduce_time(
                        st.nbytes, deg, axes=st.axes)
                    attn_events.append((st.axes, ar))
                    if training:
                        # bwd mirror: the head-sharded qkv projections are
                        # column-parallel, so dx at the attention entry is
                        # a partial sum over the same head axes (same
                        # (b,s,e) bytes as the wo psum) — the lowered-HLO
                        # audit caught this leg priced at zero
                        attn_events.append((st.axes, ar))
                elif st.kind == "all_gather":
                    gather = self.machine.all_gather_time(
                        st.nbytes, deg, axes=st.axes)
                    attn_events.append((st.axes, gather))  # fwd all-gather
                    if training:
                        # bwd: reduce-scatter of dq/dk/dv, same bytes
                        attn_events.append((st.axes, (bwd - 1.0) * gather))
                elif st.kind == "all_to_all":
                    leg = self.machine.all_to_all_time(
                        st.nbytes, deg, axes=st.axes)
                    attn_events.append((st.axes, leg))
                    if training:  # backward mirrors the exchange
                        attn_events.append((st.axes, (bwd - 1.0) * leg))
                elif st.kind == "ppermute":
                    # ring: per-direction unhidden remainder. Forward
                    # ppermutes k/v behind the forward blocks; backward
                    # ppermutes k/v + accumulating dk/dv (2x bytes) behind
                    # the backward blocks (backward_factor x forward
                    # compute) — each leg is latency-bound unless the
                    # transfer outruns its own phase's compute.
                    transfer = self.machine.all_gather_time(
                        st.nbytes, deg, axes=st.axes)
                    compute = self.node_compute_time(graph, node, view,
                                                     training=training)
                    lat_floor = (deg - 1) * self.machine.ici_latency
                    if training:
                        fwd_c = compute / (1.0 + self.backward_factor)
                        bwd_c = compute - fwd_c
                        attn_events.append(
                            (st.axes, max(lat_floor, transfer - fwd_c)))
                        attn_events.append(
                            (st.axes,
                             max(lat_floor, 2.0 * transfer - bwd_c)))
                    else:
                        attn_events.append(
                            (st.axes, max(lat_floor, transfer - compute)))
            attn_events = [(ax, t) for ax, t in attn_events if t > 0.0]
            if attn_events:
                return attn_events
        # pipeline: each of the (M+P-1) schedule ticks ppermutes one
        # microbatch activation to the next stage (one ICI hop)
        if is_pipe_sharded(node, view) and ins:
            p = self.axis_sizes.get("pipe", 1)
            m = max(getattr(node.attrs, "n_microbatches", 1), 1)
            if p > 1:
                # each ppermute moves the per-DATA-SHARD microbatch
                out_deg = max(
                    spec_degree(view.output_spec(0), self.axis_sizes), 1
                )
                micro_bytes = ins[0].global_bytes() / m / out_deg
                per_hop = (
                    micro_bytes / self.machine._axis_bw(2, ("pipe",))
                    + self.machine.ici_latency
                )
                return [(("pipe",), (m + p - 1) * per_hop)]
        # contraction-dim sharding => partial-sum all-reduce of the output
        # (row-TP); output-dim sharding => the BACKWARD dx is a partial
        # sum over the same axes (column-TP pays its all-reduce in the
        # backward — a leg the lowered-HLO audit found priced at zero)
        if view is not None and node.outputs:
            contraction_specs = {
                OpType.LINEAR: ("kernel", 0, 1),
                OpType.CONV2D: ("kernel", 1, 0),
            }
            if node.op_type in contraction_specs:
                wname, cdim, odim = contraction_specs[node.op_type]
                wspec = view.weight_specs.get(wname)
                events = []
                if wspec is not None and cdim < len(wspec) and wspec[cdim]:
                    deg = axes_degree(wspec[cdim])
                    if deg > 1:
                        events.append((tuple(wspec[cdim]),
                                       self.machine.all_reduce_time(
                            node.outputs[0].global_bytes(), deg,
                            axes=tuple(wspec[cdim]),
                        )))
                if (training and wspec is not None and ins
                        and odim < len(wspec) and wspec[odim]):
                    deg = axes_degree(wspec[odim])
                    if deg > 1:
                        events.append((tuple(wspec[odim]),
                                       self.machine.all_reduce_time(
                            ins[0].global_bytes(), deg,
                            axes=tuple(wspec[odim]),
                        )))
                if events:
                    return events
        return []

    def attention_comm_spec(self, graph: Graph, node: Node,
                            view: Optional[ShardingView]):
        """Declarative collectives this model PRICES for an attention node
        under `view`: a list of parallel.comm_spec.CommStep (kind, mesh
        axes, global forward bytes). This is the comparison surface
        fflint's consistency pass checks against the LOWERING's declared
        spec (parallel.comm_spec.attention_lowered_comm_spec) — the
        machine check for the round-5 ulysses-h_deg / ring-GQA pricing
        divergences. The exchange-shape decisions (GQA repeat, ulysses
        ring-fallback) come from the same `ulysses_plan`/`ring_repeats_kv`
        helpers the lowering itself calls; h_deg comes from the MESH head
        axis exactly as the lowering reads it (_mesh_axis_size(mesh,
        "model")), NOT from the view's wo sharding (ADVICE r5)."""
        from flexflow_tpu_torch.parallel.comm_spec import (
            CommStep,
            ring_repeats_kv,
            ulysses_plan,
        )
        from flexflow_tpu_torch.parallel.comm_spec import (
            axes_degree as _axes_degree,
        )

        steps = []
        if (node.op_type not in (OpType.MULTIHEAD_ATTENTION,
                                 OpType.RING_ATTENTION)
                or view is None or not node.outputs
                or node.outputs[0].ndim < 3):
            return steps

        def axes_degree(axes) -> int:
            return _axes_degree(axes, self.axis_sizes)

        # head-sharded wo is a CONTRACTION over heads: each shard produces
        # a partial sum of the output projection and GSPMD emits an
        # all-reduce — priced like row-TP linears. ADDITIVE with the
        # seq-parallel exchange below: a head+seq view pays both.
        wo = view.weight_specs.get("wo")
        if wo and len(wo) >= 1 and wo[0]:
            if axes_degree(wo[0]) > 1:
                steps.append(CommStep("all_reduce", tuple(wo[0]),
                                      node.outputs[0].global_bytes()))
        spec = view.output_spec(0)
        seq_axes = tuple(spec[1]) if spec and len(spec) > 1 and spec[1] else ()
        deg = axes_degree(seq_axes)
        if deg > 1:
            a = node.attrs
            b = node.outputs[0].dims[0].size
            s = node.outputs[0].dims[1].size
            dt = node.outputs[0].dtype.size_bytes
            hd = a.kdim
            q_bytes = b * s * a.num_heads * hd * dt
            h_deg = self.axis_sizes.get("model", 1)
            if node.op_type == OpType.MULTIHEAD_ATTENTION:
                # GSPMD gathers q/k/v before the shard_map flash wrapper;
                # GQA kv travels unrepeated
                kv_bytes = 2 * b * s * a.num_kv * hd * dt
                steps.append(CommStep("all_gather", seq_axes,
                                      q_bytes + kv_bytes))
                return steps
            plan = (ulysses_plan(a.num_heads, a.num_kv, h_deg, deg)
                    if getattr(a, "seq_mode", "ring") == "ulysses" else None)
            if plan is not None and not plan.fallback_to_ring:
                # leg 1 moves q + kv (unrepeated GQA when the lowering can
                # keep it so); leg 2 moves the attention output (q-sized)
                kv_ex = 2 * b * s * plan.kv_heads_exchanged * hd * dt
                steps.append(CommStep("all_to_all", seq_axes,
                                      q_bytes + kv_ex))
                steps.append(CommStep("all_to_all", seq_axes, q_bytes))
            else:
                # ring path — either seq_mode="ring" or the ulysses
                # lowering's silent fallback when local heads don't split
                # the seq degree. A head-TP degree that does not divide
                # the GQA kv heads repeats kv up front, so the ppermute
                # moves full-head blocks.
                kv_heads = (a.num_heads
                            if ring_repeats_kv(a.num_heads, a.num_kv, h_deg)
                            else a.num_kv)
                steps.append(CommStep("ppermute", seq_axes,
                                      2 * b * s * kv_heads * hd * dt))
        return steps

    def weight_sync_time(self, graph: Graph, node: Node,
                         view: Optional[ShardingView]) -> float:
        """Gradient all-reduce over the replicated (data) axes of each weight
        (reference: NCCL allreduce in the optimizer, optimizer_kernel.cu:88)."""
        return sum(t for _, t in self.weight_sync_events(graph, node, view))

    def weight_sync_events(self, graph: Graph, node: Node,
                           view: Optional[ShardingView]):
        """Per-weight gradient-sync collectives as (mesh_axes, seconds)
        events (sum = weight_sync_time)."""
        if node.attrs is None:
            return []
        events = []
        ws = node.attrs.weights(*_in_shapes(graph, node))
        for name, spec_decl in ws.items():
            if not spec_decl.trainable:
                continue
            nbytes = spec_decl.shape.size_bytes()
            shard_degree = 1
            used = set()
            wspec = view.weight_specs.get(name) if view is not None else None
            if wspec:
                shard_degree = spec_degree(wspec, self.axis_sizes)
                for axes in wspec:
                    used.update(axes)
            # the grad psum spans every mesh axis the weight is NOT sharded
            # over (it is replicated there): a fully replicated weight on a
            # data×model mesh syncs over data*model chips, a col-TP weight
            # only over data
            sync_degree = 1
            sync_axes = []
            for a, s in self.axis_sizes.items():
                if a not in used:
                    sync_degree *= s
                    if s > 1:
                        sync_axes.append(a)
            t = self.machine.all_reduce_time(
                nbytes / shard_degree, sync_degree, axes=tuple(sync_axes)
            )
            if t > 0.0:
                events.append((tuple(sync_axes), t))
        return events

    def event_seconds(self, kind: str, nbytes: float, deg: int,
                      axes: Tuple[str, ...] = ()) -> float:
        """Machine-model seconds for one collective in the
        parallel.comm_spec kind vocabulary ("psum" accepted as an
        all_reduce alias for the measured path's sample keys). Shared by
        the priced-events manifest and MeasuredCostModel's
        modeled_collective_time so both sides read the same formulas."""
        axes = tuple(axes)
        if deg <= 1:
            return 0.0
        if kind in ("all_reduce", "psum"):
            return self.machine.all_reduce_time(nbytes, deg, axes=axes)
        if kind == "all_gather":
            return self.machine.all_gather_time(nbytes, deg, axes=axes)
        if kind == "reduce_scatter":
            return self.machine.reduce_scatter_time(nbytes, deg, axes=axes)
        if kind == "all_to_all":
            return self.machine.all_to_all_time(nbytes, deg, axes=axes)
        # ppermute: one full hop of the per-chip shard
        return (nbytes / self.machine._axis_bw(deg, axes)
                + self.machine.ici_latency)

    def node_priced_events(self, graph: Graph, node: Node,
                           view: Optional[ShardingView],
                           training: bool = True):
        """Kind/byte-level view of every collective this model prices
        AGAINST this node (node_comm_events' branches plus weight sync),
        as PricedEvents keyed by the node's stable key — the per-node
        manifest half the lowered-HLO audit joins against HLO metadata.
        Bytes are forward-pass bytes in the machine-formula convention;
        the audit's tolerance bands absorb training-time multipliers."""
        key = node.stable_key()
        events = []

        def add(kind, axes, nbytes, source="node_comm"):
            events.append(PricedEvent(kind, tuple(axes), float(nbytes),
                                      source, key))

        def axes_degree(axes) -> int:
            from flexflow_tpu_torch.parallel.comm_spec import (
                axes_degree as _shared,
            )

            return _shared(axes, self.axis_sizes)

        ins = _in_shapes(graph, node)
        # parallel ops: same kind/byte decisions as node_comm_events
        if node.op_type == OpType.REDUCTION and ins:
            axes = getattr(node.attrs, "axes", ()) or ("model",)
            if axes_degree(axes) > 1:
                add("all_reduce", axes, ins[0].global_bytes())
        elif node.op_type == OpType.COMBINE and ins:
            axes = getattr(node.attrs, "axes", ()) or ("model",)
            add("all_gather", axes, ins[0].global_bytes())
        elif node.op_type == OpType.ALL_TO_ALL and ins:
            add("all_to_all", getattr(node.attrs, "axes", ()),
                ins[0].global_bytes())
        elif node.op_type == OpType.FUSED_PARALLEL and ins:
            nbytes = ins[0].global_bytes()
            for kind, _dim, axes in node.attrs.steps:
                axes = (tuple(axes or ()) if kind == "all_to_all"
                        else tuple(axes or ("model",)))
                # mirror node_comm_events' fused-chain degrees exactly:
                # combine/replicate/all_to_all force deg>=2 (always
                # priced), only a deg<=1 reduction drops out
                if kind == "repartition" or (
                        kind == "reduction" and axes_degree(axes) <= 1):
                    continue
                add({"reduction": "all_reduce", "combine": "all_gather",
                     "replicate": "all_gather"}.get(kind, "all_to_all"),
                    axes, nbytes)
        elif node.op_type in PARALLEL_OP_TYPES:
            pass
        elif (node.op_type == OpType.EXPERTS and view is not None
              and ins and view.weight_specs.get("w1")
              and view.weight_specs["w1"][0]
              and axes_degree(view.weight_specs["w1"][0]) > 1):
            # dispatch all-to-all in, combine psum out (matches the
            # slot-gather + weighted-sum combine the lowering emits)
            add("all_to_all", view.weight_specs["w1"][0],
                ins[0].global_bytes())
            if node.outputs:
                add("all_reduce", view.weight_specs["w1"][0],
                    node.outputs[0].global_bytes())
        elif (node.op_type in (OpType.MULTIHEAD_ATTENTION,
                               OpType.RING_ATTENTION)
              and node.outputs and node.outputs[0].ndim >= 3):
            for st in self.attention_comm_spec(graph, node, view):
                add(st.kind, st.axes, st.nbytes)
                if not training:
                    continue
                # backward legs, mirroring node_comm_events' attention
                # branch: dx psum for the wo all-reduce, reduce-scatter
                # as the transpose of the q/kv all-gather, a second
                # exchange for ulysses, and the ring ppermute moving
                # k/v + accumulating dk/dv (2x bytes)
                if st.kind == "ppermute":
                    add(st.kind, st.axes, 2.0 * st.nbytes)
                elif st.kind == "all_gather":
                    add("reduce_scatter", st.axes, st.nbytes)
                else:
                    add(st.kind, st.axes, st.nbytes)
        if not events and is_pipe_sharded(node, view) and ins:
            p = self.axis_sizes.get("pipe", 1)
            m = max(getattr(node.attrs, "n_microbatches", 1), 1)
            if p > 1:
                out_deg = max(
                    spec_degree(view.output_spec(0), self.axis_sizes), 1)
                add("ppermute", ("pipe",),
                    (m + p - 1) * ins[0].global_bytes() / m / out_deg)
        # contraction-dim sharding -> partial-sum all-reduce (row-TP);
        # output-dim sharding -> backward dx psum (column-TP)
        if (not events and view is not None and node.outputs
                and node.op_type in (OpType.LINEAR, OpType.CONV2D)):
            wname, cdim, odim = (("kernel", 0, 1)
                                 if node.op_type == OpType.LINEAR
                                 else ("kernel", 1, 0))
            wspec = view.weight_specs.get(wname)
            if (wspec is not None and cdim < len(wspec) and wspec[cdim]
                    and axes_degree(wspec[cdim]) > 1):
                add("all_reduce", wspec[cdim],
                    node.outputs[0].global_bytes())
            if (training and wspec is not None and ins
                    and odim < len(wspec) and wspec[odim]
                    and axes_degree(wspec[odim]) > 1):
                add("all_reduce", wspec[odim], ins[0].global_bytes())
        if training and node.attrs is not None:
            for name, decl in node.attrs.weights(*ins).items():
                if not decl.trainable:
                    continue
                shard_degree, used = 1, set()
                wspec = (view.weight_specs.get(name)
                         if view is not None else None)
                if wspec:
                    shard_degree = spec_degree(wspec, self.axis_sizes)
                    for axes in wspec:
                        used.update(axes)
                sync_axes = tuple(a for a, s in self.axis_sizes.items()
                                  if a not in used and s > 1)
                if sync_axes:
                    add("all_reduce", sync_axes,
                        decl.shape.size_bytes() / shard_degree,
                        source="weight_sync")
        return events

    def priced_comm_manifest(self, graph: Graph,
                             strategy: Optional[Dict] = None,
                             training: bool = True) -> Dict:
        """The full per-node priced-events manifest for one (graph,
        strategy): {"nodes": {stable_key: [PricedEvent]}, "edges":
        [{src, dst, kind, axes, nbytes}]} — keyed exactly like the HLO
        metadata op_names the executor stamps (jax.named_scope of each
        node's stable key), so analysis.hloaudit can attribute every
        lowered collective to the event that priced it or flag the node
        that priced nothing."""
        nodes: Dict[str, list] = {}
        edges = []
        for node in graph.topo_order():
            view = (strategy.get(node.name, node.sharding)
                    if strategy is not None else node.sharding)
            evs = self.node_priced_events(graph, node, view, training)
            if evs:
                nodes[node.stable_key()] = evs
            for e in graph.out_edges(node):
                dst = graph.node(e.dst)
                dst_view = (strategy.get(dst.name, dst.sharding)
                            if strategy is not None else dst.sharding)
                src_spec = view.output_spec(e.src_idx) if view else None
                dst_in = None
                if dst_view is not None:
                    dst_in = dst_view.input_spec(e.dst_idx)
                    if dst_in is None:
                        dst_in = dst_view.output_spec(0)
                step = self.edge_xfer_step(
                    node.outputs[e.src_idx], src_spec, dst_in)
                if step is not None:
                    kind, axes, nbytes, _parts = step
                    edges.append({"src": node.stable_key(),
                                  "dst": dst.stable_key(),
                                  "kind": kind, "axes": tuple(axes),
                                  "nbytes": float(nbytes)})
        return {"nodes": nodes, "edges": edges}

    def edge_xfer_time(self, shape, src_spec: Optional[Spec],
                       dst_spec: Optional[Spec]) -> float:
        return self.edge_xfer_event(shape, src_spec, dst_spec)[1]

    def edge_xfer_step(self, shape, src_spec: Optional[Spec],
                       dst_spec: Optional[Spec]):
        """The collective one resharding edge implies, as (kind, axes,
        nbytes, participants) — or None for a free reshard (identical
        specs, or partitioning replicated data). The single home of the
        kind decision, consumed by edge_xfer_event for pricing and by
        priced_comm_manifest for the lowered-HLO audit."""
        ndim = len(shape.dims)

        def norm(spec):
            out = []
            for i in range(ndim):
                axes = spec[i] if spec is not None and i < len(spec) else ()
                out.append(tuple(axes))
            while out and not out[-1]:
                out.pop()
            return tuple(out)

        src = norm(src_spec)
        dst = norm(dst_spec)
        if src == dst:
            return None
        nbytes = shape.global_bytes()
        src_deg = spec_degree(src or None, self.axis_sizes)
        dst_deg = spec_degree(dst or None, self.axis_sizes)
        if src_deg == dst_deg == 1:
            return None
        axes = tuple({a for spec in (src, dst) for entry in spec for a in entry})
        if src_deg > 1 and dst_deg > 1:
            return ("all_to_all", axes, nbytes, max(src_deg, dst_deg, 2))
        if src_deg > 1 and dst_deg == 1:
            return ("all_gather", axes, nbytes, src_deg)
        # partitioning replicated data is a local slice
        return None

    def edge_xfer_event(self, shape, src_spec: Optional[Spec],
                        dst_spec: Optional[Spec]):
        """Resharding cost between the producer's output spec and the
        consumer's *input* spec, as one (mesh_axes, seconds) event
        (reference estimate_xfer_cost graph.cc:1438). Specs are compared
        dim-by-dim on the dims of the edge tensor itself (trailing
        replicated entries trimmed), so a rank-changing consumer's own
        output spec is never misread as its input layout."""
        step = self.edge_xfer_step(shape, src_spec, dst_spec)
        if step is None:
            return ((), 0.0)
        kind, axes, nbytes, parts = step
        if kind == "all_to_all":
            return (axes, self.machine.all_to_all_time(nbytes, parts, axes=axes))
        return (axes, self.machine.all_gather_time(nbytes, parts, axes=axes))

    # ------------------------------------------------------------------

    def node_memory(self, graph: Graph, node: Node,
                    view: Optional[ShardingView], training: bool = True) -> float:
        """Per-chip bytes attributable to this node: weights (+grads+opt
        state when training) and activation output, under `view`."""
        if node.attrs is None:
            return 0.0
        total = 0.0
        ws = node.attrs.weights(*_in_shapes(graph, node))
        for name, spec_decl in ws.items():
            deg = 1
            if view is not None and name in view.weight_specs:
                deg = spec_degree(view.weight_specs[name], self.axis_sizes)
            factor = 4.0 if (training and spec_decl.trainable) else 1.0  # p+g+m+v
            total += spec_decl.shape.size_bytes() * factor / deg
        for i, out in enumerate(node.outputs):
            deg = 1
            if view is not None:
                deg = spec_degree(view.output_spec(i), self.axis_sizes)
            total += out.global_bytes() / deg
        return total


@dataclasses.dataclass(frozen=True)
class PricedEvent:
    """One collective the search PRICED, exported for the lowered-HLO
    audit (analysis.hloaudit): `kind` uses the parallel.comm_spec
    vocabulary (all_reduce / all_gather / reduce_scatter / all_to_all /
    ppermute),
    `nbytes` is in the convention the machine-model formula consumes,
    `source` says which pricing path emitted it (node_comm /
    weight_sync / edge_xfer), and `node` is the stable key the executor
    stamps into HLO metadata via jax.named_scope — the join key that
    lets the audit attribute a lowered collective back to the event
    that priced it (or prove none did)."""

    kind: str
    axes: Tuple[str, ...]
    nbytes: float
    source: str
    node: str

    def to_json(self) -> Dict:
        return {"kind": self.kind, "axes": list(self.axes),
                "nbytes": float(self.nbytes), "source": self.source,
                "node": self.node}


@dataclasses.dataclass
class GraphCost:
    """Composite result (reference GraphCostResultWithMemory)."""

    time: float
    memory_per_chip: float

    def multi_obj(self, run_time_cost_factor: float,
                  memory_scale: float = 1.0) -> float:
        """λ-blend used by the memory-aware search (graph.cc:1155).
        `memory_scale` converts bytes into time-comparable units (the λ
        binary search passes the λ=1 solution's time/memory ratio so the
        blend is scale-free)."""
        return self.time * run_time_cost_factor + self.memory_per_chip * (
            1.0 - run_time_cost_factor
        ) * memory_scale


def graph_cost(graph: Graph, strategy: Dict[str, ShardingView],
               cost: CostModel, training: bool = True,
               overlap: float = 0.0) -> GraphCost:
    """Whole-graph step-time estimate for a strategy: compute + resharding +
    gradient sync, with `overlap` ∈ [0,1] crediting comm/compute overlap
    (XLA async collectives). This is the SPMD analog of the reference's
    SimTask list-scheduling (simulator.cc:822): with one fused XLA program
    per step there is a single device timeline, so the schedule reduces to a
    sum with an overlap credit."""
    compute = 0.0
    comm = 0.0
    mem = 0.0
    for node in graph.topo_order():
        view = strategy.get(node.name, node.sharding)
        compute += cost.node_compute_time(graph, node, view, training)
        comm += cost.node_comm_time(graph, node, view, training)
        if training:
            comm += cost.weight_sync_time(graph, node, view)
        mem += cost.node_memory(graph, node, view, training)
        for e in graph.out_edges(node):
            dst = graph.node(e.dst)
            dst_view = strategy.get(dst.name, dst.sharding)
            src_spec = view.output_spec(e.src_idx) if view else None
            dst_in_spec = None
            if dst_view is not None:
                dst_in_spec = dst_view.input_spec(e.dst_idx)
                if dst_in_spec is None:
                    dst_in_spec = dst_view.output_spec(0)
            comm += cost.edge_xfer_time(
                node.outputs[e.src_idx], src_spec, dst_in_spec
            )
    time = compute + comm * (1.0 - overlap)
    return GraphCost(time, mem)


# ---------------------------------------------------------------------------
# Serving-tick pricing (search/servesearch.py). The training-side model
# above prices one train_step; serving strategies are judged on the
# DECODE TICK instead: how many live rows a launch carries, how much of
# the launch is padding, how many ticks fuse into one dispatch, and how
# often the host is paid. The per-token compute rate comes from the same
# graph pricing (eventsim.step_seconds over the compiled forward), so
# tick prices inherit every sharding/mesh decision the step price saw.

# Host-side cost of ONE dispatch: argument marshalling, the jitted-call
# bridge, and the device->host token readback the scheduler blocks on.
# This is the constant the decode megastep amortizes (N fused ticks pay
# it once); `fftrace calibrate` scale factors absorb the machine-specific
# truth on top of this default.
HOST_DISPATCH_SECONDS = 5e-5

# Fraction of the per-dispatch host cost that survives overlap_dispatch:
# the fence (device_get of the token buffer) and the bookkeeping replay
# stay on the critical path, only the admission/metrics work between
# dispatch and fence hides in the device's shadow.
OVERLAP_RESIDUAL = 0.35


@dataclasses.dataclass
class TickPricer:
    """Prices one serving-tick dispatch from a calibrated per-token rate.

    base_step_s / base_tokens: priced seconds and token count of ONE full
      forward step of the compiled graph (eventsim.step_seconds +
      obs.calibrate.graph_tokens) — their ratio is the marginal
      per-token-row compute rate every tick shape scales from.
    host_dispatch_s: per-dispatch host cost (see HOST_DISPATCH_SECONDS).
    pad_row_cost: relative cost of a padded launch row vs a live one.
      Padded rows skip attention reads (q_len 0) but still ride the
      dense projections, so they are discounted, not free.
    host_fetch_bytes_per_s: host<->device transfer rate for the
      disaggregation host tier (PCIe-ish ~8 GB/s by default — the
      realistic bound for a device_get/device_put of one KV page).
      fetch_seconds() prices moving one spilled page back, which is
      what lets the simulator weigh SPILLING a cold page (pay a fetch
      on the next hit) against PREEMPTING a request (pay its whole
      prefill again).
    tick_scale: optional (phase, batch, chunk, width) -> float hook,
      wired to MeasuredCostModel.tick_scale when an `fftrace calibrate`
      report is loaded — measured wall-time truth multiplies the
      analytic price per tick shape.
    """

    base_step_s: float
    base_tokens: int
    host_dispatch_s: float = HOST_DISPATCH_SECONDS
    pad_row_cost: float = 0.5
    tick_scale: Optional[Callable[[str, int, int, int], float]] = None
    host_fetch_bytes_per_s: float = 8e9

    @property
    def token_seconds(self) -> float:
        return self.base_step_s / max(int(self.base_tokens), 1)

    def _scale(self, phase: str, batch: float, chunk: int = 0,
               width: float = 1) -> float:
        if self.tick_scale is None:
            return 1.0
        return float(self.tick_scale(phase, max(int(round(batch)), 1),
                                     int(chunk), max(int(round(width)), 1)))

    def decode_dispatch(self, live_rows: float, padded_rows: float = 0.0,
                        megastep: float = 1.0) -> float:
        """Seconds for ONE decode dispatch fusing `megastep` ticks over a
        launch of live_rows + padded_rows. Compute scales with rows and
        fused ticks; the host is paid once per DISPATCH — which is the
        whole megastep story: N fused ticks amortize host_dispatch_s to
        host_dispatch_s / N per tick."""
        rows = max(live_rows, 0.0) + max(padded_rows, 0.0) * self.pad_row_cost
        comp = (self.token_seconds * max(rows, 1.0) * max(megastep, 1.0)
                * self._scale("decode", live_rows, width=megastep))
        return comp + self.host_dispatch_s

    def verify_dispatch(self, live_rows: float, tree_nodes: int,
                        padded_rows: float = 0.0) -> float:
        """Seconds for one speculative verify dispatch: every live slot
        scores its whole padded token tree (`tree_nodes` rows, the
        SpecConfig.max_nodes launch shape), idle slots pad at tree
        width."""
        nodes = max(int(tree_nodes), 1)
        rows = (max(live_rows, 0.0)
                + max(padded_rows, 0.0) * self.pad_row_cost) * nodes
        comp = (self.token_seconds * max(rows, 1.0)
                * self._scale("verify", live_rows, width=nodes))
        return comp + self.host_dispatch_s

    def prefill_tick(self, chunk_tokens: int, padded_rows: float = 0.0,
                     batch: int = 1) -> float:
        """Seconds for one chunked-prefill launch: `chunk_tokens` live
        rows plus the ceil-to-window padding the packed scheduler
        launches with (paged.scheduler.PREFILL_WINDOW_ROWS pieces, or
        the legacy pow2 bucket when ragged_pack=False)."""
        rows = max(int(chunk_tokens), 1) + max(padded_rows, 0.0) * self.pad_row_cost
        comp = (self.token_seconds * rows
                * self._scale("prefill", batch, chunk=int(chunk_tokens)))
        return comp + self.host_dispatch_s

    def mixed_dispatch(self, live_rows: float, chunk_tokens: int = 0,
                       tree_nodes: int = 0, padded_rows: float = 0.0,
                       megastep: float = 1.0,
                       overlap: bool = False) -> float:
        """Seconds for ONE universal-fused dispatch of `megastep` MIXED
        ticks: every fused tick launches the live decode rows (each
        `tree_nodes` wide when a drafted spec chain rides the row, else
        1), the in-flight prefill chunk's `chunk_tokens` rows, and the
        padding. The host is paid once per DISPATCH — the universal
        megastep's whole point is that mixed traffic amortizes it too —
        and `overlap` further discounts it to OVERLAP_RESIDUAL because
        the admission/metrics slice of the host work runs in the shadow
        of the in-flight device computation."""
        width = max(int(tree_nodes), 1)
        rows = (max(live_rows, 0.0) * width + max(int(chunk_tokens), 0)
                + max(padded_rows, 0.0) * self.pad_row_cost)
        comp = (self.token_seconds * max(rows, 1.0) * max(megastep, 1.0)
                * self._scale("decode", live_rows, chunk=int(chunk_tokens),
                              width=max(megastep, 1.0)))
        host = self.host_dispatch_s * (OVERLAP_RESIDUAL if overlap else 1.0)
        return comp + host

    def fetch_seconds(self, page_bytes: float, pages: int = 1) -> float:
        """Seconds to move `pages` spilled KV pages (each `page_bytes`
        on the wire, scale sidecar included) back from the host tier:
        transfer at host_fetch_bytes_per_s plus one host dispatch per
        page (each fetch is its own device_put + jitted scatter). The
        spill direction prices the same; ticksim charges it off the
        critical path (spills overlap decode, fetches gate admission)."""
        bw = max(self.host_fetch_bytes_per_s, 1.0)
        n = max(int(pages), 0)
        return n * (max(page_bytes, 0.0) / bw + self.host_dispatch_s)


def _kv_cache_node_rows(graph: Graph,
                        strategy: Optional[Dict[str, ShardingView]],
                        axis_sizes: Optional[Dict[str, int]]):
    """Yield (elems_per_token, kv_rows, model_dtype_bytes, head_degree)
    per cached-attention node: elems_per_token = 2 * num_kv * head_dim
    (x layers for stacked blocks), kv_rows = 2 * num_kv (x layers) — the
    per-page scale-sidecar entry count for a quantized pool."""
    for node in graph.nodes:
        attrs = node.attrs
        if node.op_type in (OpType.MULTIHEAD_ATTENTION,
                            OpType.RING_ATTENTION) \
                and attrs is not None and hasattr(attrs, "num_kv"):
            kv_rows = 2 * int(attrs.num_kv)
            elems = kv_rows * int(attrs.kdim)
        elif node.op_type == OpType.PIPELINE and attrs is not None \
                and hasattr(attrs, "kv_heads"):
            # stacked decoder blocks: `layers` caches behind one node
            embed = int(node.outputs[0].dims[-1])
            head_dim = embed // max(int(attrs.heads), 1)
            kv_rows = 2 * int(attrs.kv_heads) * int(attrs.layers)
            elems = kv_rows * head_dim
        else:
            continue
        deg = 1
        if strategy is not None and axis_sizes:
            view = strategy.get(node.name, node.sharding)
            if view is not None:
                deg = max(spec_degree(view.weight_specs.get("wk"),
                                      axis_sizes), 1)
        yield elems, kv_rows, node.outputs[0].dtype.size_bytes, deg


def kv_cache_elem_counts(graph: Graph,
                         strategy: Optional[Dict[str, ShardingView]] = None,
                         axis_sizes: Optional[Dict[str, int]] = None
                         ) -> Tuple[int, int]:
    """Per-chip (K/V elements one token row occupies, scale-sidecar
    entries one PAGE carries) across all attention layers — the
    dtype-independent counts the serving pricer multiplies by a
    kv_dtype's itemsize (paged.quant.KV_DTYPES) to price a quantized
    pool without re-walking the graph per candidate strategy."""
    elems_total = 0
    scale_total = 0
    for elems, kv_rows, _, deg in _kv_cache_node_rows(graph, strategy,
                                                      axis_sizes):
        elems_total += -(-elems // deg)
        scale_total += -(-kv_rows // deg)
    return elems_total, scale_total


def kv_cache_token_bytes(graph: Graph,
                         strategy: Optional[Dict[str, ShardingView]] = None,
                         axis_sizes: Optional[Dict[str, int]] = None,
                         kv_dtype: Optional[str] = None,
                         page_size: Optional[int] = None) -> int:
    """Per-chip K/V-cache bytes ONE token row occupies across all
    attention layers: 2 (K and V) x num_kv x head_dim x dtype bytes per
    layer, divided by the head-parallel degree the strategy shards wk/wv
    over. This is what prices the paged pool against the HBM budget in
    the serving-strategy search: pool_pages x page_size x this = resident
    cache bytes (the hlo-hbm-budget counterpart for serving state).

    `kv_dtype` (a ServeStrategy knob value, paged.quant.KV_DTYPES)
    overrides the model dtype the pool stores K/V at; a quantized dtype
    additionally bills the per-page scale sidecar amortized over
    `page_size` tokens (2 x num_kv float32 entries per page per layer) —
    mispricing int8 pages at fp32 would make every quantized strategy
    look 4x more expensive than the pool it actually allocates."""
    from flexflow_tpu_torch.paged.quant import SCALE_BYTES, kv_dtype_info

    info = kv_dtype_info(kv_dtype)
    total = 0
    for elems, kv_rows, dtype_bytes, deg in _kv_cache_node_rows(
            graph, strategy, axis_sizes):
        row = elems * (dtype_bytes if info is None else info[1])
        total += -(-row // deg)
        if info is not None and info[2]:
            if not page_size or page_size < 1:
                raise ValueError(
                    "kv_cache_token_bytes needs page_size to amortize the "
                    f"scale sidecar of quantized kv_dtype {kv_dtype!r}")
            scale_row = -(-(kv_rows * SCALE_BYTES) // deg)
            total += -(-scale_row // int(page_size))
    return total
