"""Machine models for the strategy search (counterpart of
flexflow_tpu/search/machine_model.py).

`H100MachineModel` is the port's machine: H100 SXM5 GPUs, eight a node
on NVSwitch, nodes joined by InfiniBand. `TPUMachineModel` and
`TorusMachineModel` are the JAX package's TPU machines, kept as they are
so the port prices a strategy on the same machine as the reference (its
parity tests do). Like the reference's `--machine-model-file`, a JSON
file can describe a machine you don't have, so strategies can be searched
for a 16-GPU cluster on one card or none.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TPUChipSpec:
    name: str
    bf16_flops: float  # peak FLOP/s
    hbm_bytes: float
    hbm_bw: float  # bytes/s
    ici_link_bw: float  # bytes/s per link per direction
    ici_links: int  # links per chip (torus degree * 2 dirs collapsed)
    torus_dims: int  # 2 (v5e/v6e) or 3 (v4/v5p)


# Published specs (approximate, public numbers)
CHIPS: Dict[str, TPUChipSpec] = {
    "v4": TPUChipSpec("v4", 275e12, 32e9, 1228e9, 50e9, 6, 3),
    "v5e": TPUChipSpec("v5e", 197e12, 16e9, 819e9, 50e9, 4, 2),
    "v5p": TPUChipSpec("v5p", 459e12, 95e9, 2765e9, 100e9, 6, 3),
    "v6e": TPUChipSpec("v6e", 918e12, 32e9, 1640e9, 100e9, 4, 2),
}


@dataclasses.dataclass
class TPUMachineModel:
    """Cost oracle for compute and collectives on a TPU slice.

    Collective estimates use standard ring/torus formulas: an all-reduce of
    B bytes over n chips moves 2B(n-1)/n per chip; bandwidth scales with the
    number of torus links usable by the mesh axis. `mxu_efficiency` and
    `ici_efficiency` are calibration knobs (cf. the reference's measured
    microbenchmarks feeding its simulator, simulator.cc:537).
    """

    chip: TPUChipSpec
    num_chips: int
    mxu_efficiency: float = 0.5
    hbm_efficiency: float = 0.8
    ici_efficiency: float = 0.8
    ici_latency: float = 1e-6  # per-hop software+link latency (s)
    # multi-slice: chips per slice; collectives crossing slices use DCN
    chips_per_slice: Optional[int] = None
    dcn_bw: float = 25e9  # bytes/s per host
    # ordered mesh axis sizes (outermost first, row-major device order) —
    # stamped by the search's _cost_model so slice-crossing detection can
    # use an axis's SPAN (stride x size) instead of its participant count:
    # a 2-way DP collective over the outermost axis of a 2-slice machine
    # crosses DCN even though it has only 2 participants per group
    axis_order: Optional[Dict[str, int]] = None

    @staticmethod
    def make(chip: str = "v5e", num_chips: int = 8, **kw) -> "TPUMachineModel":
        return TPUMachineModel(CHIPS[chip], num_chips, **kw)

    @staticmethod
    def from_file(path: str) -> "TPUMachineModel":
        """JSON machine description (reference --machine-model-file analog):
        {"chip": "v5p", "num_chips": 64, "mxu_efficiency": 0.55, ...} or a
        fully custom chip: {"chip": {"name": ..., "bf16_flops": ...}, ...}.
        A "torus_shape"/"axis_map" entry selects the torus-topology model
        (TorusMachineModel, the NetworkedMachineModel analog); a GPU chip
        name ({"chip": "h100", "num_chips": 16, "gpus_per_node": 8}) the
        GPU cluster (H100MachineModel)."""
        with open(path) as f:
            d = json.load(f)
        if d.get("chip") in GPUS:
            return H100MachineModel._from_dict(d)
        if "torus_shape" in d or "axis_map" in d:
            return TorusMachineModel._from_dict(d)
        chip = d.pop("chip", "v5e")
        if isinstance(chip, dict):
            spec = TPUChipSpec(**chip)
        else:
            spec = CHIPS[chip]
        return TPUMachineModel(spec, d.pop("num_chips", 8), **d)

    # ------------------------------------------------------------------

    def compute_time(self, flops: float, bytes_accessed: float) -> float:
        """Roofline: max of MXU time and HBM time for one chip's shard."""
        t_flops = flops / (self.chip.bf16_flops * self.mxu_efficiency)
        t_mem = bytes_accessed / (self.chip.hbm_bw * self.hbm_efficiency)
        return max(t_flops, t_mem)

    def _axis_bw(self, participants: int,
                 axes: Optional[Tuple[str, ...]] = None) -> float:
        """Aggregate ICI bandwidth available to a collective over one mesh
        axis. A contiguous axis rides one torus dimension: 2 links (both
        ring directions). `axes` (mesh axis names) is ignored here; the
        torus model maps them onto torus dims for multi-ring bandwidth."""
        return 2 * self.chip.ici_link_bw * self.ici_efficiency

    def _axis_span(self, axes) -> Optional[int]:
        """Device-index span of a collective over mesh `axes` under
        row-major device order, or None when the axis order is unknown."""
        if not self.axis_order or not axes:
            return None
        names = list(self.axis_order)
        sizes = [max(int(s), 1) for s in self.axis_order.values()]
        strides = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        span = 1
        for a in axes:
            if a in names:
                i = names.index(a)
                span = max(span, sizes[i] * strides[i])
        return span

    def _crosses_dcn(self, participants: int,
                     axes: Optional[Tuple[str, ...]] = None) -> bool:
        if self.chips_per_slice is None:
            return False
        span = self._axis_span(axes)
        if span is not None:
            return span > self.chips_per_slice
        return participants > self.chips_per_slice

    def all_reduce_time(self, bytes_global: float, participants: int,
                 axes: Optional[Tuple[str, ...]] = None) -> float:
        if participants <= 1:
            return 0.0
        if self._crosses_dcn(participants, axes):
            return bytes_global * 2 / self.dcn_bw + self.ici_latency * participants
        moved = 2 * bytes_global * (participants - 1) / participants
        return (moved / self._axis_bw(participants, axes)
                + self.ici_latency * participants)

    def all_gather_time(self, bytes_global: float, participants: int,
                 axes: Optional[Tuple[str, ...]] = None) -> float:
        if participants <= 1:
            return 0.0
        moved = bytes_global * (participants - 1) / participants
        bw = (self.dcn_bw if self._crosses_dcn(participants, axes)
              else self._axis_bw(participants, axes))
        return moved / bw + self.ici_latency * participants

    def reduce_scatter_time(self, bytes_global: float, participants: int,
                            axes: Optional[Tuple[str, ...]] = None) -> float:
        return self.all_gather_time(bytes_global, participants, axes)

    def all_to_all_time(self, bytes_global: float, participants: int,
                 axes: Optional[Tuple[str, ...]] = None) -> float:
        if participants <= 1:
            return 0.0
        # each chip keeps 1/n, sends (n-1)/n of its shard
        moved = bytes_global * (participants - 1) / (participants * participants)
        bw = (self.dcn_bw if self._crosses_dcn(participants, axes)
              else self._axis_bw(participants, axes))
        return moved / bw + self.ici_latency * participants

    def p2p_time(self, bytes_per_chip: float, hops: int = 1) -> float:
        return bytes_per_chip / self._axis_bw(2) + self.ici_latency * hops

    def memory_per_chip(self) -> float:
        return self.chip.hbm_bytes


# ---------------------------------------------------------------------------
# torus-topology model (NetworkedMachineModel / network.cc analog)


@dataclasses.dataclass
class TorusMachineModel(TPUMachineModel):
    """Explicit ICI torus: chips live at coordinates in a 2D/3D torus and
    every MESH axis is mapped onto the TORUS dims it spans. This fixes the
    flat model's simplification that every axis gets one torus ring: an
    axis folded over k torus dims drives 2k bidirectional links, and p2p
    cost follows shortest-path torus routing (the reference prices routes
    through an explicit switch graph + routing strategy, network.cc:47-264;
    on TPU the topology is the torus itself).

    axis_map: mesh axis name -> tuple of torus dim indices it spans, e.g.
    v5p-64 as {"data": (0, 1), "model": (2,)} lays data over a 4x4 plane
    (4 rings) and model along the third dim (2 rings).
    """

    torus_shape: Tuple[int, ...] = ()
    axis_map: Dict[str, Tuple[int, ...]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.torus_shape:
            # default: fold num_chips into the chip's native torus rank
            shape = []
            n = self.num_chips
            for _ in range(self.chip.torus_dims - 1):
                d = 1
                while n % 2 == 0 and d * d <= n:
                    d *= 2
                    n //= 2
                shape.append(d)
            shape.append(n)
            self.torus_shape = tuple(s for s in shape if s > 1) or (self.num_chips,)
        assert math.prod(self.torus_shape) == self.num_chips, (
            f"torus {self.torus_shape} != {self.num_chips} chips"
        )

    # -- routing (network.cc ShortestPath analog on a torus) ------------

    def coords(self, device: int) -> Tuple[int, ...]:
        out = []
        for s in reversed(self.torus_shape):
            out.append(device % s)
            device //= s
        return tuple(reversed(out))

    def hops(self, a: int, b: int) -> int:
        """Shortest-path hop count with per-dim wraparound."""
        total = 0
        for da, db, s in zip(self.coords(a), self.coords(b), self.torus_shape):
            d = abs(da - db)
            total += min(d, s - d)
        return total

    def p2p_time(self, bytes_per_chip: float, hops: int = 1) -> float:
        # serial store-and-forward over `hops` links (worst case; real ICI
        # pipelines — ici_efficiency absorbs the difference)
        return (bytes_per_chip / (self.chip.ici_link_bw * self.ici_efficiency)
                + self.ici_latency * hops)

    # -- axis-aware bandwidth -------------------------------------------

    def _axis_links(self, axes: Optional[Tuple[str, ...]]) -> int:
        """Bidirectional ring count available to a collective over `axes`:
        2 per torus dim spanned. Unmapped/unknown axes keep the flat
        model's single-ring assumption."""
        if not axes:
            return 2
        dims = set()
        for a in axes:
            dims.update(self.axis_map.get(a, ()))
        return 2 * len(dims) if dims else 2

    def _axis_bw(self, participants: int,
                 axes: Optional[Tuple[str, ...]] = None) -> float:
        return (self._axis_links(axes) * self.chip.ici_link_bw
                * self.ici_efficiency)

    @staticmethod
    def from_file(path: str) -> "TorusMachineModel":
        """{"chip": "v5p", "num_chips": 64, "torus_shape": [4, 4, 4],
            "axis_map": {"data": [0, 1], "model": [2]}, ...}"""
        with open(path) as f:
            return TorusMachineModel._from_dict(json.load(f))

    @staticmethod
    def _from_dict(d: Dict) -> "TorusMachineModel":
        chip = d.pop("chip", "v5e")
        spec = TPUChipSpec(**chip) if isinstance(chip, dict) else CHIPS[chip]
        d["torus_shape"] = tuple(d.get("torus_shape", ()))
        d["axis_map"] = {k: tuple(v) for k, v in d.get("axis_map", {}).items()}
        return TorusMachineModel(spec, d.pop("num_chips", 8), **d)


# ---------------------------------------------------------------------------
# the H100 GPU cluster


@dataclasses.dataclass(frozen=True)
class GPUChipSpec:
    name: str
    bf16_flops: float  # dense peak FLOP/s
    hbm_bytes: float
    hbm_bw: float  # bytes/s
    nvlink_bw: float  # bytes/s a direction, one GPU to the NVSwitch fabric
    ib_bw: float  # bytes/s a direction, one GPU's InfiniBand NIC


# NVIDIA H100 SXM5 datasheet: 989.4 TF/s dense bf16, 80 GB HBM3 at
# 3.35 TB/s, NVLink 4 at 900 GB/s both ways (450 a direction); a ConnectX-7
# NDR NIC a GPU at 400 Gb/s (50 GB/s)
GPUS: Dict[str, GPUChipSpec] = {
    "h100": GPUChipSpec("h100", 989.4e12, 80e9, 3.35e12, 450e9, 50e9),
}


@dataclasses.dataclass
class H100MachineModel(TPUMachineModel):
    """Cost oracle for compute and collectives on H100 nodes: the
    TPUMachineModel interface (compute_time, all_reduce_time,
    all_gather_time, reduce_scatter_time, all_to_all_time, p2p_time,
    memory_per_chip, _axis_bw, _crosses_dcn, axis_order) on a GPU
    cluster, so the cost model, the event simulator and the measured cost
    model read it as they read a TPU slice.

    `gpus_per_node` GPUs share one NVSwitch: any group inside a node gets
    every GPU's full NVLink rate, whatever its size and axes. A collective
    whose group spans nodes runs over InfiniBand (`dcn_bw`, one NIC a GPU)
    with the TPU model's DCN formulas, `gpus_per_node` taking the place of
    `chips_per_slice`. The calibration knobs keep their TPU names:
    `mxu_efficiency` is the tensor cores' share of the dense peak,
    `hbm_efficiency` the share of the HBM rate a kernel streams,
    `ici_efficiency` the share of the NVLink rate a collective reaches and
    `ici_latency` the per-participant NVLink latency (s).
    """

    gpus_per_node: int = 8

    def __post_init__(self):
        self.chips_per_slice = self.gpus_per_node
        self.dcn_bw = self.chip.ib_bw

    @staticmethod
    def make(chip: str = "h100", num_chips: int = 8,
             **kw) -> "H100MachineModel":
        return H100MachineModel(GPUS[chip], num_chips, **kw)

    @staticmethod
    def _from_dict(d: Dict) -> "H100MachineModel":
        d = dict(d)
        spec = GPUS[d.pop("chip")]
        return H100MachineModel(spec, d.pop("num_chips", 8), **d)

    def _axis_bw(self, participants: int,
                 axes: Optional[Tuple[str, ...]] = None) -> float:
        """A GPU's NVLink rate a direction: the switch gives every group
        inside the node the same rate, however the mesh axes lie."""
        return self.chip.nvlink_bw * self.ici_efficiency


def logical_traffic_matrix(graph, strategy, cost) -> Dict[str, float]:
    """Per-mesh-axis communicated bytes for one training step under
    `strategy` (the reference's logical_traffic_demand, simulator.h:603):
    weight-sync allreduces bill their sync axes, parallel-op collectives
    bill their declared axes, reshard edges bill every axis whose degree
    changes across the edge. A pure observability/product of the cost
    model — useful for choosing the axis_map."""
    from flexflow_tpu_torch.ffconst import OpType, PARALLEL_OP_TYPES
    from flexflow_tpu_torch.search.cost_model import (
        _in_shapes,
        is_pipe_sharded,
        spec_degree,
    )

    out: Dict[str, float] = {}

    def bill(axes, nbytes):
        for a in axes:
            out[a] = out.get(a, 0.0) + nbytes

    for node in graph.topo_order():
        view = strategy.get(node.name, node.sharding)
        ins = _in_shapes(graph, node)
        if node.op_type in (OpType.REDUCTION, OpType.COMBINE,
                            OpType.ALL_TO_ALL) and ins:
            axes = getattr(node.attrs, "axes", ()) or ("model",)
            bill(axes, ins[0].global_bytes())
            continue
        if node.op_type in PARALLEL_OP_TYPES or node.attrs is None:
            continue
        if is_pipe_sharded(node, view) and ins:
            # (M+P-1) microbatch hops ride the pipe axis
            m = max(getattr(node.attrs, "n_microbatches", 1), 1)
            p = cost.axis_sizes.get("pipe", 1)
            if p > 1:
                bill(("pipe",), (m + p - 1) * ins[0].global_bytes() / m)
        ws = node.attrs.weights(*ins)
        for name, decl in ws.items():
            if not decl.trainable:
                continue
            used = set()
            wspec = view.weight_specs.get(name) if view is not None else None
            shard = 1
            if wspec:
                shard = spec_degree(wspec, cost.axis_sizes)
                for axes in wspec:
                    used.update(axes)
            sync_axes = [a for a, s in cost.axis_sizes.items()
                         if a not in used and s > 1]
            if sync_axes:
                bill(sync_axes, 2 * decl.shape.size_bytes() / shard)
        for e in graph.out_edges(node):
            dst = graph.node(e.dst)
            dst_view = strategy.get(dst.name, dst.sharding)
            src_spec = view.output_spec(e.src_idx) if view else None
            dst_spec = None
            if dst_view is not None:
                dst_spec = dst_view.input_spec(e.dst_idx)
                if dst_spec is None:
                    dst_spec = dst_view.output_spec(0)
            shape = node.outputs[e.src_idx]
            ndim = len(shape.dims)

            def axes_at(spec, i):
                if spec is None or i >= len(spec):
                    return ()
                return tuple(spec[i])

            src_deg = spec_degree(src_spec, cost.axis_sizes)
            if src_deg <= 1:
                # partitioning replicated data is a local slice — no bytes
                # move (matches CostModel.edge_xfer_time)
                continue
            changed = set()
            for i in range(ndim):
                sa, da = axes_at(src_spec, i), axes_at(dst_spec, i)
                if sa != da:
                    changed.update(sa)
                    changed.update(da)
            if changed:
                bill(changed, shape.global_bytes())
    return out
