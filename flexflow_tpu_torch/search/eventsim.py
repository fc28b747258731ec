"""Per-device event simulation of one training step
(counterpart of flexflow_tpu/search/eventsim.py, the same logic).

Reference analog: Simulator::simulate_runtime (simulator.cc:822) builds a
per-device SimTask DAG — every op shard is a task on its device's queue,
collectives expand into routed per-link comm tasks (ring expansion
simulator.h:810, network routing network.cc:47,264) — and list-schedules it.

TPU-native mapping: a GSPMD program is one SPMD executable, but its
structural constructs have genuinely per-device timelines the serial op sum
cannot express — pipeline stages compute different microbatches at
different times, ring attention overlaps ppermute hops with block compute,
and concurrent collectives contend on the same mesh axis's ICI rings. The
expansion here lowers a (graph, strategy) into:

  * one serial channel per CHIP (compute) and one per ICI RING INSTANCE —
    a (mesh axis, coordinate-along-the-other-axes) pair. A lockstep SPMD
    collective occupies every instance of its axis concurrently (all rings
    carry the same traffic), so same-axis collectives still contend link
    for link; but constructs whose collectives are restricted to a device
    subset (per-stage gradient syncs of a pipe-sharded PIPELINE, per-group
    TP) occupy ONLY their own instances and overlap with their siblings —
    the routed-network fidelity the reference gets from per-link SimTasks
    (simulator.h:515-605);
  * a single shared DCN channel for slice-crossing collectives (the host
    NIC) when the machine model declares `chips_per_slice` — DCN traffic
    no longer falsely contends with ICI traffic;
  * lockstep ops: one compute task per chip + per-instance comm tasks for
    the node's collectives (CostModel.node_comm_events) and gradient syncs
    (weight_sync_events — dependents-free, so they overlap later compute
    exactly like XLA async collectives);
  * PIPELINE composites: stage x microbatch forward/backward wave tasks on
    the stage's chips, chained by ppermute hop tasks on the pipe axis —
    the GPipe bubble and hop/compute overlap emerge from the schedule
    instead of an analytic (M+P-1)/M factor;
  * RING_ATTENTION: per-step block tasks chained by k/v permute tasks on
    the seq axis.

The DAG ships to the native engine in one call (ffsim_tasksim_build) and
is list-scheduled there. Falls back to None (caller uses the serial sum)
when the native library is unavailable or the mesh/graph is too large —
the oversize fallback is LOUD: it logs a warning (once) and reports the
ranking mode through the `info` out-param so gate records can show which
ranking a search actually used.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, Iterable, List, Optional, Sequence

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.pcg.graph import Graph
from flexflow_tpu_torch.search.cost_model import (
    CostModel,
    graph_cost,
    is_pipe_sharded,
    pipeline_compute_factor,
    spec_degree,
)

logger = logging.getLogger(__name__)

# expansion size guard: beyond this many tasks the Python build loop costs
# more than the fidelity is worth inside a search — callers fall back to
# the serial sum (the playoff re-rank still uses the two-channel simulate)
MAX_TASKS = 200_000

# ring instances per axis before collapsing back to one shared channel —
# beyond this the instance enumeration itself dominates; collapsing is
# exact for lockstep SPMD collectives and only loses subset overlap
MAX_GROUP_CHANNELS = 64

_warned_oversize = False


class _DagBuilder:
    def __init__(self, n_channels: int):
        self.n_channels = n_channels
        self.channels: List[int] = []
        self.durations: List[float] = []
        self.dep_src: List[int] = []
        self.dep_dst: List[int] = []

    def new_channel(self) -> int:
        """Allocate a fresh serial channel (e.g. one pipeline stage
        boundary's links — distinct boundaries transfer in parallel)."""
        c = self.n_channels
        self.n_channels += 1
        return c

    def add(self, channel: int, duration: float, deps=()) -> int:
        tid = len(self.channels)
        self.channels.append(channel)
        self.durations.append(duration)
        for d in deps:
            self.dep_src.append(d)
            self.dep_dst.append(tid)
        return tid

    def run(self) -> Optional[float]:
        from flexflow_tpu_torch import native

        return native.run_task_dag(self.n_channels, self.channels,
                                   self.durations, self.dep_src,
                                   self.dep_dst)


class _IciChannels:
    """Ring-instance comm channels (simulator.h:515-605 per-link analog).

    A collective over mesh axes rides the PRIMARY axis's rings; the torus
    has one physical ring instance of that axis per coordinate of the
    other axes. `emit` schedules one task per instance a collective
    actually touches, grouping devices by their orthogonal coordinates —
    so a sync whose per-device deps come from disjoint stages lands on
    disjoint instances and overlaps, while two whole-mesh collectives on
    the same axis still contend on every instance.
    """

    def __init__(self, b: _DagBuilder, axis_names: Sequence[str],
                 shape: Sequence[int], coord_of, n_dev: int, machine):
        self.b = b
        self.axis_names = list(axis_names)
        self.shape = list(shape)
        self.coord_of = coord_of
        self.n_dev = n_dev
        self.machine = machine
        self._chan: Dict = {}
        self._dcn: Optional[int] = None

    def _channel(self, key) -> int:
        c = self._chan.get(key)
        if c is None:
            c = self.b.new_channel()
            self._chan[key] = c
        return c

    def _primary(self, axes) -> Optional[int]:
        for a in axes:
            if a in self.axis_names:
                i = self.axis_names.index(a)
                if self.shape[i] > 1:
                    return i
        return None

    def emit(self, axes, duration: float,
             deps_by_dev: Sequence[Iterable[int]],
             devices: Optional[Iterable[int]] = None) -> List[Optional[int]]:
        """Schedule one collective event over mesh `axes`.

        `deps_by_dev[d]` = tasks device d must finish before joining the
        collective; `devices` optionally restricts the participants (a
        device subset, e.g. one pipeline stage). Returns a per-device
        completion task id (None for non-participants).

        Synchronization and occupancy are separate concerns: devices form
        one independent SYNC GROUP per coordinate over the axes NOT in the
        collective (a multi-axis all-reduce couples every device that any
        of its axes spans — splitting it finer would let one column finish
        before the other's producers arrive); each group then OCCUPIES the
        primary axis's physical ring instance at every non-primary
        coordinate its members touch, so contention stays per link."""
        devs = list(devices) if devices is not None else list(range(self.n_dev))
        out: List[Optional[int]] = [None] * self.n_dev

        def broadcast(channel: int) -> List[Optional[int]]:
            tid = self.b.add(channel, duration,
                             {x for d in devs for x in deps_by_dev[d]})
            for d in devs:
                out[d] = tid
            return out

        primary = self._primary(axes)
        if primary is None:
            # no real participants (all named axes trivial): unconstrained
            return broadcast(-1)
        part = {self.axis_names.index(a) for a in axes
                if a in self.axis_names
                and self.shape[self.axis_names.index(a)] > 1}
        participants = math.prod(self.shape[i] for i in part)
        if (self.machine is not None
                and getattr(self.machine, "chips_per_slice", None) is not None
                and self.machine._crosses_dcn(participants, tuple(axes))):
            # slice-crossing traffic rides the host NIC, one shared channel
            return broadcast(self._dcn_channel())
        non_primary = [i for i in range(len(self.shape))
                       if i != primary and self.shape[i] > 1]
        n_inst = (math.prod(self.shape[i] for i in non_primary)
                  if non_primary else 1)
        if n_inst > MAX_GROUP_CHANNELS:
            # collapse to the old one-channel-per-axis model: exact for
            # lockstep SPMD, loses subset overlap on very large meshes
            return broadcast(self._channel((primary, "collapsed")))
        # channel identity = physical ring instance of the primary axis:
        # the device's coordinate along every other non-trivial axis
        nonpart = [i for i in non_primary if i not in part]
        groups: Dict[tuple, tuple] = {}
        for d in devs:
            gkey = tuple(self.coord_of(d, i) for i in nonpart)
            deps, members = groups.setdefault(gkey, (set(), []))
            deps.update(deps_by_dev[d])
            members.append(d)
        for gkey, (deps, members) in groups.items():
            insts = sorted({tuple(self.coord_of(d, i) for i in non_primary)
                            for d in members})
            tids = [self.b.add(self._channel((primary, inst)), duration,
                               deps) for inst in insts]
            # a group spanning several ring instances (secondary collective
            # axes) completes when ALL of them drain: join on a free task
            done_id = (tids[0] if len(tids) == 1
                       else self.b.add(-1, 0.0, tids))
            for d in members:
                out[d] = done_id
        return out

    def _dcn_channel(self) -> int:
        if self._dcn is None:
            self._dcn = self.b.new_channel()
        return self._dcn


def simulate_graph(graph: Graph, strategy: Dict, cost: CostModel,
                   training: bool = True,
                   info: Optional[Dict] = None) -> Optional[float]:
    """Makespan of one step of `graph` under `strategy` on the per-device
    task simulator, or None when unavailable/oversized. `info`, when
    given, receives {"mode": "eventsim"|"serial_fallback_oversized"|
    "unavailable", ...} so callers can record which ranking was used."""
    from flexflow_tpu_torch import native

    if not native.available():
        if info is not None:
            info["mode"] = "unavailable"
        return None
    axis_names = list(cost.axis_sizes)
    shape = [max(int(cost.axis_sizes[a]), 1) for a in axis_names]
    n_dev = math.prod(shape)
    nodes = list(graph.topo_order())
    # size guard counts the EXPANDED task multiplicity (pipeline waves are
    # ~2m tasks per device, ring attention ~2*deg), not just node count
    est = 0
    for n in nodes:
        v = strategy.get(n.name, n.sharding)
        if n.op_type == OpType.PIPELINE and is_pipe_sharded(n, v):
            est += 2 * max(getattr(n.attrs, "n_microbatches", 1), 1)
        elif (n.op_type == OpType.RING_ATTENTION and v is not None):
            est += 2 * _seq_degree(n, v, cost)
        else:
            est += 1
    if n_dev * max(est, 1) > MAX_TASKS:
        global _warned_oversize
        if not _warned_oversize:
            logger.warning(
                "eventsim: expanded task count %d (x%d devices) exceeds "
                "MAX_TASKS=%d; falling back to the serial op-sum for this "
                "and further oversized graphs — rankings lose overlap/"
                "contention awareness (warned once)",
                est, n_dev, MAX_TASKS)
            _warned_oversize = True
        if info is not None:
            info["mode"] = "serial_fallback_oversized"
            info["est_tasks"] = n_dev * est
        return None
    b = _DagBuilder(n_dev)

    # device index <-> mesh coords (row-major over axis_names order)
    strides = [0] * len(shape)
    acc = 1
    for i in range(len(shape) - 1, -1, -1):
        strides[i] = acc
        acc *= shape[i]

    def coord_of(dev: int, axis_idx: int) -> int:
        return (dev // strides[axis_idx]) % shape[axis_idx]

    ici = _IciChannels(b, axis_names, shape, coord_of, n_dev,
                       getattr(cost, "machine", None))

    # per node guid: completion task id per device
    done: Dict[int, List[int]] = {}

    for node in nodes:
        view = strategy.get(node.name, node.sharding)
        # dependencies arriving at each device: producers' completions,
        # routed through a resharding comm task when the edge moves bytes
        in_deps: List[List[int]] = [[] for _ in range(n_dev)]
        for e in graph.in_edges(node):
            src_node = graph.node(e.src)
            src_done = done.get(e.src)
            if src_done is None:
                continue
            src_view = strategy.get(src_node.name, src_node.sharding)
            src_spec = (src_view.output_spec(e.src_idx)
                        if src_view is not None else None)
            dst_spec = None
            if view is not None:
                dst_spec = view.input_spec(e.dst_idx)
                if dst_spec is None:
                    dst_spec = view.output_spec(0)
            axes, xt = cost.edge_xfer_event(
                src_node.outputs[e.src_idx], src_spec, dst_spec)
            if xt > 0.0:
                per_dev = ici.emit(axes, xt, [[t] for t in src_done])
                for d in range(n_dev):
                    in_deps[d].append(per_dev[d])
            else:
                for d in range(n_dev):
                    in_deps[d].append(src_done[d])

        if node.op_type == OpType.PIPELINE and is_pipe_sharded(node, view) \
                and "pipe" in axis_names \
                and cost.axis_sizes.get("pipe", 1) > 1:
            completion = _expand_pipeline(b, graph, node, view, cost,
                                          training, in_deps, n_dev,
                                          axis_names, coord_of)
        elif (node.op_type == OpType.RING_ATTENTION
              and getattr(node.attrs, "seq_mode", "ring") == "ring"
              and view is not None
              and _seq_degree(node, view, cost) > 1):
            completion = _expand_ring(b, graph, node, view, cost, training,
                                      in_deps, n_dev, ici)
        else:
            t = cost.node_compute_time(graph, node, view, training)
            ids = [b.add(d, t, in_deps[d]) for d in range(n_dev)]
            completion = ids
            # the node's own collectives serialize after its compute
            for axes, et in cost.node_comm_events(graph, node, view,
                                                  training):
                if et <= 0.0:
                    continue
                completion = ici.emit(axes, et,
                                      [[c] for c in completion])
        done[node.guid] = completion

        if training:
            # gradient syncs: scheduled after the node, no dependents —
            # they contend on their instances' channels and extend the
            # makespan only when they cannot hide behind later work. Deps
            # are PER DEVICE: a pipe-sharded weight's sync instance at
            # stage s starts when stage s finishes, so stage-local syncs
            # overlap each other and other stages' remaining backward
            for axes, st in cost.weight_sync_events(graph, node, view):
                if st > 0.0:
                    ici.emit(axes, st, [[c] for c in done[node.guid]])

    out = b.run()
    if info is not None:
        info["mode"] = "eventsim"
        info["tasks"] = len(b.channels)
        info["channels"] = b.n_channels
    return out


def step_seconds(graph: Graph, strategy: Dict, cost: CostModel,
                 training: bool = False,
                 info: Optional[Dict] = None) -> tuple:
    """Priced seconds of one step under `strategy`: the per-device event
    simulator when the native engine is available, the serial graph_cost
    sum otherwise. Returns (seconds, mode) so callers — the tick
    calibrator (obs/calibrate.py) and the serving-strategy search
    (search/servesearch.py) — can stamp which pricing path produced the
    number they are about to scale."""
    inf: Dict = {} if info is None else info
    t = simulate_graph(graph, strategy, cost, training=training, info=inf)
    mode = inf.get("mode", "eventsim")
    if t is None:
        t = graph_cost(graph, strategy, cost, training=training).time
        mode = f"graph_cost (eventsim: {mode})"
    if info is not None:
        info["mode_resolved"] = mode
    return float(t), mode


def _seq_degree(node, view, cost: CostModel) -> int:
    spec = view.output_spec(0)
    if not spec or len(spec) < 2 or not spec[1]:
        return 1
    deg = 1
    for a in spec[1]:
        deg *= cost.axis_sizes.get(a, 1)
    return deg


def _expand_ring(b: _DagBuilder, graph, node, view, cost: CostModel,
                 training: bool, in_deps, n_dev: int,
                 ici: _IciChannels) -> List[int]:
    """Ring attention as `deg` per-device block-compute steps with a
    CONCURRENT k/v ppermute chain on the seq axis: each hop forwards the
    block it just received (hop i depends on hop i-1, NOT on step i's
    compute), and step i+1 waits for hop i — so transfer hides behind
    block compute exactly like the real kernel, and the makespan is
    ~max(deg*block, (deg-1)*hop). The backward wave re-permutes k/v plus
    accumulating dk/dv (2x bytes). Non-seq collectives the cost model
    prices for this node (e.g. a head-TP wo all-reduce) are scheduled
    after the waves. Hops ride the seq axis's ring instances — disjoint
    data-group rings permute concurrently."""
    deg = _seq_degree(node, view, cost)
    total = cost.node_compute_time(graph, node, view, training)
    spec = view.output_spec(0)
    seq_axes = tuple(spec[1])
    a = node.attrs
    bsz = node.outputs[0].dims[0].size
    s = node.outputs[0].dims[1].size
    dt = node.outputs[0].dtype.size_bytes
    kv_bytes = 2 * bsz * s * a.num_kv * a.kdim * dt
    ring_total = cost.machine.all_gather_time(kv_bytes, deg, axes=seq_axes)
    per_step = ring_total / max(deg - 1, 1)
    if training:
        fwd_step = total / (1.0 + cost.backward_factor) / deg
        bwd_step = total * cost.backward_factor / (1.0 + cost.backward_factor) / deg
        waves = [(fwd_step, per_step), (bwd_step, 2.0 * per_step)]
    else:
        waves = [(total / deg, per_step)]
    cur = in_deps
    last = None
    for step_c, hop_c in waves:
        prev_hop: Optional[List[Optional[int]]] = None
        for i in range(deg):
            if i == 0:
                ids = [b.add(d, step_c, cur[d]) for d in range(n_dev)]
            else:
                ids = [b.add(d, step_c, [prev_hop[d]])
                       for d in range(n_dev)]
            last = ids
            if i < deg - 1:
                # forward the just-received block: chain on the previous
                # hop (and, for the first, on the input being ready)
                hop_deps = ([[prev_hop[d]] for d in range(n_dev)]
                            if prev_hop is not None else cur)
                prev_hop = ici.emit(seq_axes, hop_c, hop_deps)
        cur = [[last[d]] for d in range(n_dev)]
    completion = last
    # non-seq collectives (additive in node_comm_events, e.g. head-TP wo
    # all-reduce) serialize after the waves
    for axes, et in cost.node_comm_events(graph, node, view, training):
        if et <= 0.0 or tuple(axes) == seq_axes:
            continue  # seq legs are replaced by the explicit hop chain
        completion = ici.emit(axes, et, [[c] for c in completion])
    return completion


def _expand_pipeline(b: _DagBuilder, graph, node, view, cost: CostModel,
                     training: bool, in_deps, n_dev: int, axis_names,
                     coord_of) -> List[int]:
    """GPipe wave expansion: per (stage, microbatch) compute tasks on the
    stage's chips, ppermute hop tasks between consecutive stages, then the
    backward wave in reverse — the (M+P-1)/M bubble and any hop/compute
    overlap come out of the schedule, not an analytic factor."""
    from flexflow_tpu_torch.search.cost_model import _in_shapes

    p = cost.axis_sizes.get("pipe", 1)
    m = max(getattr(node.attrs, "n_microbatches", 1), 1)
    pipe_idx = axis_names.index("pipe")
    # per-device fwd+bwd work with the analytic bubble factor removed —
    # the schedule reproduces the bubble itself
    total = (cost.node_compute_time(graph, node, view, training)
             / pipeline_compute_factor(node, view, cost.axis_sizes))
    fwd_mb = total / (1.0 + (cost.backward_factor if training else 0.0)) / m
    bwd_mb = (total - fwd_mb * m) / m if training else 0.0
    ins = _in_shapes(graph, node)
    out_deg = max(spec_degree(view.output_spec(0), cost.axis_sizes), 1)
    micro_bytes = (ins[0].global_bytes() / m / out_deg) if ins else 0.0
    per_hop = (micro_bytes / cost.machine._axis_bw(2, ("pipe",))
               + cost.machine.ici_latency)
    # one channel per STAGE BOUNDARY: distinct boundaries are distinct
    # physical links and transfer concurrently (unlike an axis-wide
    # collective, a stage hop is point-to-point)
    boundary = [b.new_channel() for _ in range(max(p - 1, 1))]

    stage_devs = [[d for d in range(n_dev) if coord_of(d, pipe_idx) == s]
                  for s in range(p)]
    # fwd wave
    fwd_tasks: List[List[List[int]]] = []  # [stage][micro] -> task ids
    for s in range(p):
        fwd_tasks.append([])
        for j in range(m):
            if s == 0:
                deps = [in_deps[d] for d in stage_devs[0]]
                ids = [b.add(d, fwd_mb, dep)
                       for d, dep in zip(stage_devs[0], deps)]
            else:
                hop = b.add(boundary[s - 1], per_hop,
                            set(fwd_tasks[s - 1][j]))
                ids = [b.add(d, fwd_mb, [hop]) for d in stage_devs[s]]
            fwd_tasks[s].append(ids)
    completion_by_dev = {d: tid for d, tid in
                         zip(stage_devs[p - 1], fwd_tasks[p - 1][m - 1])}
    if training and bwd_mb > 0.0:
        # bwd wave, reverse stage order, reverse microbatch order
        bwd_prev: Dict[int, List[int]] = {}
        for s in range(p - 1, -1, -1):
            for j in range(m - 1, -1, -1):
                if s == p - 1:
                    deps = [set(fwd_tasks[s][j]) for _ in stage_devs[s]]
                else:
                    hop = b.add(boundary[s], per_hop, set(bwd_prev[j]))
                    deps = [{hop} | set(fwd_tasks[s][j])
                            for _ in stage_devs[s]]
                ids = [b.add(d, bwd_mb, dep)
                       for d, dep in zip(stage_devs[s], deps)]
                bwd_prev[j] = ids
                for d, tid in zip(stage_devs[s], ids):
                    completion_by_dev[d] = tid
    # every device completes at its last scheduled pipeline task; devices
    # outside any stage list (cannot happen: stages partition the mesh)
    sink = [completion_by_dev.get(d) for d in range(n_dev)]
    # stages other than the one a device belongs to never ran on it — give
    # those devices the nearest completed task so successors still chain
    fallback = next(t for t in sink if t is not None)
    return [t if t is not None else fallback for t in sink]
