"""Measured cost model: per-op microbenchmarks on the card (counterpart
of flexflow_tpu/search/measured.py).

Each op shard the search prices is run through the port's own lowering at
its per-shard shapes on the configured device, timed with CUDA events on
the card (perf_counter on the CPU), and cached by the reference's strict
key (op type, attrs, shard shapes, dtypes), optionally on disk, so
repeated searches skip re-measurement. Attention's forward therefore runs
the flash kernels (K1 at head dims that are multiples of 128, K4
otherwise), and their wrappers count those launches.

Measurements are used two ways, as in the reference: directly, as
`node_compute_time`, and as calibration: `calibrate()` fits the analytic
machine's `mxu_efficiency` to the measured sample so the ops no lowering
can time inherit it. Unlike the reference, whose search prices every op
shard the up-front sweep did not time analytically, the port times such
a shard when the search first prices it, as FlexFlow's simulator
measures inside the cost query (simulator.cc:537): otherwise a rewrite's
new ops (a linear with its activation fused in, two linears merged) are
priced by the roofline against measured originals, and on the card the
measured graph as built always wins. The collective sweep (timing the
all-reduce, all-gather and reduce-scatter of a process mesh across
cards to fit the machine model's NVLink knobs) is not ported yet
(ROADMAP.md queue 1 item 12: the collective sweep): the knobs keep their
datasheet defaults.

Unlike the reference, a failure is not an unmeasured op: a kernel that
fails to build or to launch raises. Only a lowering that refuses the
shapes (ValueError) or an op with no lowering (NotImplementedError)
leaves the op unmeasured.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import DataType, OpType, PARALLEL_OP_TYPES
from flexflow_tpu_torch.parallel.sharding import ShardingView
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.search.cost_model import CostModel, _in_shapes


def _shard_shape(shape, spec, axis_sizes) -> Tuple[int, ...]:
    """Local (per-shard) shape of a global tensor under a spec."""
    dims = []
    for i, d in enumerate(shape.dims):
        deg = 1
        if spec is not None and i < len(spec):
            for a in spec[i]:
                deg *= axis_sizes.get(a, 1)
        dims.append(d.size // deg if d.size % deg == 0 else d.size)
    return tuple(dims)


def _weight_shard_shape(shape, spec, axis_sizes) -> Tuple[int, ...]:
    dims = []
    for i, size in enumerate(shape):
        deg = 1
        if spec is not None and i < len(spec):
            for a in spec[i]:
                deg *= axis_sizes.get(a, 1)
        dims.append(size // deg if size % deg == 0 else size)
    return tuple(dims)


def calibration_scales(report: Dict) -> Dict[str, float]:
    """The scale table of an `fftrace calibrate` report
    (obs.calibrate.calibration_report): per-tick-shape factors plus the
    per-phase medians as `phase|*` fallbacks for shapes the ledger never
    saw."""
    if not isinstance(report, dict):
        raise TypeError(f"expected a report dict, got {type(report)}")
    scales = report.get("tick_scales", report)
    if not isinstance(scales, dict):
        raise TypeError(f"expected a report dict, got {type(report)}")
    table = {key: float(ratio) for key, ratio in scales.items()}
    for phase, ratio in report.get("phases", {}).items():
        table[f"{phase}|*"] = float(ratio)
    return table


def lookup_tick_scale(table: Dict[str, float], phase: str, batch: int,
                      chunk: int = 0, width: int = 1) -> float:
    """Measured/predicted ratio for this tick shape in a
    calibration_scales table: exact shape first, then the phase's
    median, else 1.0 (uncalibrated)."""
    from flexflow_tpu_torch.obs.ledger import shape_key

    exact = table.get(shape_key(phase, batch, chunk, width))
    if exact is not None:
        return exact
    return table.get(f"{phase}|*", 1.0)


@dataclasses.dataclass
class MeasuredCostModel(CostModel):
    """CostModel whose node_compute_time is backed by timings on `device`
    when available (measure_graph() must be called, or measurements
    loaded from `cache_path`)."""

    cache_path: Optional[str] = None
    warmup: int = 2
    repeats: int = 5
    device: str = "cuda"
    _measured: Dict[str, float] = dataclasses.field(default_factory=dict)
    # keys whose lowering refused the shapes: priced analytically
    _refused: set = dataclasses.field(default_factory=set)
    # serving-tick calibration (fftrace): per-tick-shape scale factors
    # (measured / predicted) from obs.calibrate.calibration_report
    _tick_scale: Dict[str, float] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------

    def _key(self, node: Node, view: Optional[ShardingView],
             in_shards, w_shards) -> str:
        return json.dumps(
            [str(node.op_type), repr(node.attrs), in_shards, w_shards],
            sort_keys=True,
        )

    def load_cache(self) -> None:
        if self.cache_path and os.path.exists(self.cache_path):
            with open(self.cache_path) as f:
                self._measured.update(json.load(f))

    def save_cache(self) -> None:
        if self.cache_path:
            with open(self.cache_path, "w") as f:
                json.dump(self._measured, f)

    # ------------------------------------------------------------------

    def _shard_inputs(self, graph: Graph, node: Node,
                      view: Optional[ShardingView]):
        ins = _in_shapes(graph, node)
        out_spec = view.output_spec(0) if view is not None else None
        in_shards = []
        for i, s in enumerate(ins):
            spec = None
            if view is not None:
                spec = view.input_spec(i)
            if spec is None:
                # inputs follow the output's batch sharding by default
                spec = out_spec
            in_shards.append((_shard_shape(s, spec, self.axis_sizes),
                              str(s.dtype.value)))
        w_shards = {}
        if node.attrs is not None:
            for name, wdecl in node.attrs.weights(*ins).items():
                wspec = None
                if view is not None:
                    wspec = view.weight_specs.get(name)
                w_shards[name] = (
                    _weight_shard_shape(wdecl.shape.dims, wspec,
                                        self.axis_sizes),
                    str(wdecl.shape.dtype.value),
                )
        return in_shards, w_shards

    def _seconds(self, node: Node, in_shards, w_shards,
                 key: str) -> Optional[float]:
        """The forward seconds of one op shard, timed at its first query
        and cached by key; None when the lowering refuses the shapes."""
        if key not in self._measured and key not in self._refused:
            t = self._time_lowering(node, in_shards, w_shards)
            if t is None:
                self._refused.add(key)
            else:
                self._measured[key] = t
        return self._measured.get(key)

    def measure_node(self, graph: Graph, node: Node,
                     view: Optional[ShardingView],
                     training: bool = True) -> Optional[float]:
        """Time this op's lowering at its per-shard shapes on the device.
        Returns seconds (fwd x (1 + backward_factor) when training),
        cached by the strict key; None for an op the lowering refuses."""
        if node.op_type in PARALLEL_OP_TYPES or node.attrs is None:
            return 0.0
        if node.op_type == OpType.INPUT:
            return 0.0
        in_shards, w_shards = self._shard_inputs(graph, node, view)
        t = self._seconds(node, in_shards, w_shards,
                          self._key(node, view, in_shards, w_shards))
        if t is None:
            return None
        factor = (1.0 + self.backward_factor) if training else 1.0
        return t * factor

    def _time_lowering(self, node: Node, in_shards,
                       w_shards) -> Optional[float]:
        from flexflow_tpu_torch.ops.registry import LowerCtx, get_lowering

        try:
            lowering = get_lowering(node.op_type)
        except NotImplementedError:
            return None  # no executable lowering, in the reference either
        dev = torch.device(self.device)
        # the values do not matter, only the shapes: drawn on the device
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def mk(shape, dt):
            tdt = DataType(dt).torch_dtype
            if "int" in dt:
                return torch.randint(0, 2, tuple(shape), generator=gen,
                                     device=dev, dtype=tdt)
            return torch.randn(tuple(shape), generator=gen, device=dev,
                               dtype=torch.float32).to(tdt)

        inputs = [mk(s, dt) for s, dt in in_shards]
        params = {n: mk(s, dt) for n, (s, dt) in w_shards.items()}
        ctx = LowerCtx(device=dev, mesh=None, training=False,
                       node_guid=node.guid)

        def run():
            return lowering(node.attrs, list(inputs), params, ctx)

        try:
            with torch.no_grad():
                for _ in range(self.warmup):
                    run()
                if dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(self.repeats):
                        run()
                    end.record()
                    end.synchronize()
                    return start.elapsed_time(end) / 1e3 / self.repeats
                t0 = time.perf_counter()
                for _ in range(self.repeats):
                    run()
                return (time.perf_counter() - t0) / self.repeats
        except ValueError:
            return None  # the lowering refuses these shard shapes

    # ------------------------------------------------------------------

    def measure_graph(self, graph: Graph,
                      strategy: Dict[str, ShardingView],
                      training: bool = True) -> int:
        """Measure every (node, view) in `strategy`; returns measured count."""
        n = 0
        for node in graph.topo_order():
            view = strategy.get(node.name, node.sharding)
            if self.measure_node(graph, node, view, training) is not None:
                n += 1
        self.save_cache()
        return n

    def node_compute_time(self, graph: Graph, node: Node,
                          view: Optional[ShardingView],
                          training: bool = True) -> float:
        if node.op_type in PARALLEL_OP_TYPES or node.attrs is None:
            return 0.0
        in_shards, w_shards = self._shard_inputs(graph, node, view)
        t = None
        if node.op_type != OpType.INPUT:
            t = self._seconds(node, in_shards, w_shards,
                              self._key(node, view, in_shards, w_shards))
        if t is None:
            return super().node_compute_time(graph, node, view, training)
        from flexflow_tpu_torch.search.cost_model import (
            pipeline_compute_factor,
        )

        factor = (1.0 + self.backward_factor) if training else 1.0
        # the microbenchmark times the per-stage compute only; a
        # pipe-sharded PIPELINE still pays the GPipe bubble on top
        factor *= pipeline_compute_factor(node, view, self.axis_sizes)
        return t * factor

    # ------------------------------------------------------------------
    # serving-tick calibration (fftrace): obs.calibrate measures real
    # decode/verify/prefill ticks against the analytic step price; the
    # per-shape ratios land here so a search pricing a serving
    # configuration can correct its tick-time estimate with the card's

    def set_tick_calibration(self, report: Dict) -> int:
        """Ingest an `fftrace calibrate` report (obs.calibrate
        .calibration_report): per-tick-shape scale factors plus the
        per-phase medians as `phase|*` fallbacks for shapes the ledger
        never saw. Returns the number of exact shapes loaded."""
        table = calibration_scales(report)
        self._tick_scale.update(table)
        return len(report.get("tick_scales", report))

    def tick_scale(self, phase: str, batch: int, chunk: int = 0,
                   width: int = 1) -> float:
        """Measured/predicted ratio for this tick shape
        (lookup_tick_scale)."""
        return lookup_tick_scale(self._tick_scale, phase, batch, chunk,
                                 width)

    def decode_tick_time(self, graph: Graph,
                         strategy: Dict[str, ShardingView],
                         phase: str = "decode", batch: int = 1,
                         chunk: int = 0, width: int = 1) -> float:
        """Calibrated wall-time estimate for one serving tick of the
        given shape: the step price (this model's, so measured op shards
        where it has timed them) scaled to the tick's token count
        (obs.calibrate's linear model), times the measured correction
        for that shape."""
        from flexflow_tpu_torch.obs.calibrate import (
            graph_tokens,
            predict_tick_seconds,
        )
        from flexflow_tpu_torch.search.cost_model import graph_cost

        base = graph_cost(graph, strategy, self, training=False).time
        pred = predict_tick_seconds(base, graph_tokens(graph), phase,
                                    batch, chunk, width)
        return pred * self.tick_scale(phase, batch, chunk, width)

    # ------------------------------------------------------------------

    def calibrate(self, graph: Graph, strategy: Dict[str, ShardingView],
                  training: bool = True) -> Dict[str, float]:
        """Fit the analytic machine's mxu_efficiency to the measured
        sample: the median ratio of analytic/measured over the measured
        ops scales it (reference discipline: measured kernels feed the
        simulator, simulator.cc:537). Returns the fitted knob, the sample
        count and the median ratio."""
        ratios = []
        for node in graph.topo_order():
            view = strategy.get(node.name, node.sharding)
            measured = self.measure_node(graph, node, view, training=False)
            if not measured:
                continue
            analytic = super().node_compute_time(graph, node, view, False)
            if analytic > 0:
                ratios.append(analytic / measured)
        scale = float(np.median(ratios)) if ratios else None
        if ratios:
            # analytic = flops / (peak * eff): analytic/measured = k means
            # efficiency should be multiplied by k to match measurements
            new_eff = min(max(self.machine.mxu_efficiency * scale, 0.01), 1.0)
            self.machine.mxu_efficiency = new_eff
        self.save_cache()
        return {
            "mxu_efficiency": self.machine.mxu_efficiency,
            "samples": len(ratios),
            "median_ratio": scale,
        }
