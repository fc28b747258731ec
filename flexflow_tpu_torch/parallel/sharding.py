"""ShardingView — the MachineView analog (counterpart of
flexflow_tpu/parallel/sharding.py).

A view names, for each tensor dim of an op's outputs and weights, the
mesh axes that shard it. The strategy search assigns one per node and
prices it on a modeled machine. On a process mesh (the `data` and
`model` axes, one process per card) the executor lays each value out as
its view's spec says, pruned by prune_spec: each rank holds the piece its
coordinates pick (parallel/spmd.py), as GSPMD places a NamedSharding's
shards. In one process a view is the record of the strategy and the
executor computes whole tensors.

A `Spec` is a per-dim tuple of mesh-axis tuples, e.g. for a (batch, seq,
hidden) activation sharded DP×TP: ((("data",), (), ("model",))).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

Spec = Tuple[Tuple[str, ...], ...]


def replicated_spec(ndim: int) -> Spec:
    return tuple(() for _ in range(ndim))


def batch_spec(ndim: int, axis: str = "data") -> Spec:
    """Shard dim 0 over `axis`, replicate the rest (pure DP)."""
    return ((axis,),) + tuple(() for _ in range(ndim - 1))


def data_axes_for(dim0: int, axis_sizes) -> tuple:
    """The batch-dim mesh axes a tensor of leading size `dim0` can use.

    With submesh placement (FFConfig.enable_submesh) the data axis is
    split into data x data_sub — the GSPMD analog of the reference's
    MachineView{start_device_id, stride} device subsets
    (include/flexflow/machine_view.h:14-96): an op whose batch dim only
    divides the outer factor shards over ("data",) and stays REPLICATED
    over data_sub, i.e. it runs on a device subset instead of silently
    degrading to full replication (prune_spec's fallback)."""
    sub = axis_sizes.get("data_sub", 1)
    d = axis_sizes.get("data", 1)
    if sub > 1 and dim0 % (d * sub) == 0:
        return ("data", "data_sub")
    if d > 1 and dim0 % d == 0:
        return ("data",)
    if sub > 1 and dim0 % sub == 0:
        return ("data_sub",)
    return ("data",)  # prune_spec degrades it to replicated at execution


def data_batch_spec(ndim: int, dim0: int, axis_sizes) -> Spec:
    """batch_spec over the full data x data_sub group when divisible,
    else the largest usable subset (submesh placement)."""
    return (data_axes_for(dim0, axis_sizes),) + tuple(
        () for _ in range(ndim - 1)
    )


def group_degree(axes, axis_sizes) -> int:
    """Product of the named axes' sizes — the sharding degree a dim-0
    axes tuple implies (shared by input placement and host-batch
    sharding so the two can never disagree)."""
    d = 1
    for a in axes:
        d *= axis_sizes.get(a, 1)
    return d


@dataclasses.dataclass(frozen=True)
class ShardingView:
    """Per-node strategy record assigned by the search (or default-DP).

    output_specs[i] shards the node's i-th output; weight_specs[name] shards
    that weight (None entries = replicated). `input_specs[i]`, when given,
    states the sharding this op consumes its i-th input in — used by the
    cost model to price the resharding on each edge exactly (the reference's
    estimate_xfer_cost compares producer and consumer *input* layouts,
    graph.cc:1438); when absent the consumer is assumed to accept the
    producer's layout on matching dims. Degrees are implied by the mesh the
    strategy was built for.
    """

    output_specs: Tuple[Optional[Spec], ...] = ()
    weight_specs: Dict[str, Optional[Spec]] = dataclasses.field(default_factory=dict)
    input_specs: Tuple[Optional[Spec], ...] = ()

    def __post_init__(self):
        # freeze dict for hashing
        object.__setattr__(self, "weight_specs", dict(self.weight_specs))

    def __hash__(self):
        return hash(
            (self.output_specs, tuple(sorted(self.weight_specs.items())),
             self.input_specs)
        )

    def output_spec(self, idx: int = 0) -> Optional[Spec]:
        if idx < len(self.output_specs):
            return self.output_specs[idx]
        return None

    def input_spec(self, idx: int = 0) -> Optional[Spec]:
        if idx < len(self.input_specs):
            return self.input_specs[idx]
        return None

    def __repr__(self):
        def fmt(spec):
            if spec is None:
                return "R"
            return "(" + ",".join("+".join(a) if a else "·" for a in spec) + ")"

        outs = ";".join(fmt(s) for s in self.output_specs)
        ws = ",".join(f"{k}:{fmt(v)}" for k, v in self.weight_specs.items())
        return f"View[{outs}{('|' + ws) if ws else ''}]"


def prune_spec(spec: Optional[Spec], shape: Tuple[int, ...],
               mesh) -> Optional[Spec]:
    """Drop per-dim axis assignments whose degree does not divide the dim
    size (the reference's machine-view validity rule: a kv-head dim of 2
    cannot shard over a 4-way model axis, so it stays replicated), axes
    the mesh lacks and axes of size 1. `mesh` is a parallel.mesh.Mesh or
    its {axis: size} dict."""
    if spec is None or mesh is None:
        return spec
    sizes = dict(mesh) if isinstance(mesh, dict) else mesh.axes
    out = []
    for i, axes in enumerate(spec):
        if i >= len(shape) or not axes:
            out.append(())
            continue
        axes = tuple(a for a in axes if a in sizes and sizes[a] > 1)
        degree = 1
        for a in axes:
            degree *= sizes[a]
        out.append(axes if axes and shape[i] % degree == 0 else ())
    return tuple(out)


def view_to_json(view: Optional[ShardingView]):
    if view is None:
        return None
    def enc(s):
        return list(map(list, s)) if s is not None else None

    out = {
        "outputs": [enc(s) for s in view.output_specs],
        "weights": {k: enc(v) for k, v in view.weight_specs.items()},
    }
    if view.input_specs:
        out["inputs"] = [enc(s) for s in view.input_specs]
    return out


def view_from_json(d) -> Optional[ShardingView]:
    if d is None:
        return None
    def dec(s):
        return tuple(tuple(a) for a in s) if s is not None else None

    outs = tuple(dec(s) for s in d["outputs"])
    ws = {k: dec(v) for k, v in d["weights"].items()}
    ins = tuple(dec(s) for s in d.get("inputs", ()))
    return ShardingView(outs, ws, ins)


def used_axes(view: ShardingView) -> Tuple[str, ...]:
    axes = []
    for spec in list(view.output_specs) + list(view.weight_specs.values()):
        if spec:
            for entry in spec:
                for a in entry:
                    if a not in axes:
                        axes.append(a)
    return tuple(axes)


def pipeline_pipe_view(out_ndim: int = 3) -> "ShardingView":
    """The canonical view for a pipe-sharded PIPELINE composite: every
    stacked decoder weight shards its leading layer dim over `pipe`,
    activations stay batch-sharded over `data`. Single source of truth for
    search/space.py enumeration and models.llama.llama_pp_strategy."""
    pipe1 = (("pipe",),)
    return ShardingView(
        (batch_spec(out_ndim),),
        {
            "ln1": pipe1 + ((),), "ln2": pipe1 + ((),),
            "wq": pipe1 + ((), (), ()), "wk": pipe1 + ((), (), ()),
            "wv": pipe1 + ((), (), ()), "wo": pipe1 + ((), (), ()),
            "gate": pipe1 + ((), ()), "up": pipe1 + ((), ()),
            "down": pipe1 + ((), ()),
        },
    )
