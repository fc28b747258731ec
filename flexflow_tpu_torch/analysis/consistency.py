"""Strategy/sharding consistency checks (counterpart of
flexflow_tpu/analysis/consistency.py: its check_strategy, without the
fflint pass registry). FFModel.compile runs them on an imported strategy
file.

Verifies the sharding algebra of a PCG + per-node ShardingView assignment
(searched, hand-written, or imported from a strategy file) node by node:

  - every mesh-axis degree divides the tensor dim it shards (prune_spec
    silently replicates non-dividing axes at execution, so a view that
    declares them is priced for a shard the machine never runs —
    warning: execution stays correct but the pricing diverges);
  - no axis appears twice within one spec, specs don't outrank tensors
    (errors: GSPMD/XLA reject these outright — the cryptic lowering
    failures strategy-file import used to die with);
  - GQA head grouping is consistent across wq/wk/wv/wo (warnings:
    GSPMD reshards to correctness, the grouping is priced wrong);
  - producer/consumer views agree or the reshard is explicit (implicit
    GSPMD reshards are legal and priced — reported as info);
  - the communication the cost model PRICES for an attention node+view
    matches the collectives the lowering would EMIT — both sides export a
    declarative comm-spec (CostModel.attention_comm_spec vs
    parallel.comm_spec.attention_lowered_comm_spec); this is the check
    the round-5 advisor did by hand for the ulysses h_deg and ring GQA
    divergences.

Unknown axes are info (a strategy written for a larger mesh degrades
gracefully by design).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import OpType, PARALLEL_OP_TYPES

_ATTN_OPS = (OpType.MULTIHEAD_ATTENTION, OpType.RING_ATTENTION)


@dataclasses.dataclass
class Finding:
    """One finding. `where` names the subject (node, rule, or file:line)
    so every message is actionable without re-running."""

    pass_name: str
    severity: str
    code: str
    where: str
    message: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _deg(axes, axis_sizes) -> int:
    from flexflow_tpu_torch.parallel.comm_spec import axes_degree

    return axes_degree(axes, axis_sizes)


def _fmt_spec(spec) -> str:
    if spec is None:
        return "R"
    return "(" + ",".join("+".join(a) if a else "·" for a in spec) + ")"


def _check_spec(findings: List[Finding], subject: str, node_name: str,
                what: str, spec, dims: Tuple[int, ...],
                axis_sizes: Dict[str, int]) -> None:
    """Structural checks of one spec against the tensor dims it shards."""
    if spec is None:
        return
    where = f"{subject}:{node_name}" if subject else node_name

    def add(severity, code, msg):
        findings.append(Finding("consistency", severity, code, where, msg))

    if len(spec) > len(dims):
        add("error", "spec-rank",
            f"{what} spec {_fmt_spec(spec)} has {len(spec)} entries for a "
            f"rank-{len(dims)} tensor {dims}")
        return
    for i, axes in enumerate(spec):
        if not axes:
            continue
        if len(set(axes)) != len(axes):
            add("error", "duplicate-axis",
                f"{what} dim {i} repeats a mesh axis: {_fmt_spec(spec)}")
            continue
        known = tuple(a for a in axes if a in axis_sizes)
        unknown = tuple(a for a in axes if a not in axis_sizes)
        if unknown:
            add("info", "unknown-axis",
                f"{what} dim {i} names mesh axes {unknown} absent from "
                f"this mesh {sorted(axis_sizes)} — they are dropped at "
                "execution (strategy written for a larger mesh)")
        d = _deg(known, axis_sizes)
        if d > 1 and dims[i] % d != 0:
            # warning, not error: prune_spec defines this as graceful
            # degradation (the axis is dropped at execution), so the
            # program stays correct — but the cost model prices the
            # shard the machine never runs, so under --strict it gates
            add("warning", "degree-divides",
                f"{what} dim {i} (size {dims[i]}) sharded {d}-way over "
                f"{known}: degree does not divide the dim, so execution "
                "replicates it (prune_spec) while the cost model prices "
                "the shard — fix the view or the mesh")


def _axes_used_twice_across_dims(spec) -> Optional[str]:
    seen = set()
    for axes in spec or ():
        for a in axes:
            if a in seen:
                return a
            seen.add(a)
    return None


def _check_gqa(findings: List[Finding], subject: str, node, view,
               axis_sizes: Dict[str, int]) -> None:
    a = node.attrs
    where = f"{subject}:{node.name}" if subject else node.name

    def add(severity, code, msg):
        findings.append(Finding("consistency", severity, code, where, msg))

    if a.num_kv and a.num_heads % a.num_kv != 0:
        add("warning", "gqa-grouping",
            f"num_heads={a.num_heads} is not a multiple of "
            f"kv_heads={a.num_kv}: GQA groups are ill-defined")
        return
    # head-dim positions: wq (embed, H, hd) dim 1; wk/wv (embed, Hkv, hd)
    # dim 1; wo (H, hd, embed) dim 0
    def head_axes(name, dim):
        spec = (view.weight_specs or {}).get(name)
        if spec is None or dim >= len(spec):
            return ()
        return tuple(spec[dim])

    wq, wo = head_axes("wq", 1), head_axes("wo", 0)
    wk, wv = head_axes("wk", 1), head_axes("wv", 1)
    if wq and wo and set(wq) != set(wo):
        add("warning", "gqa-grouping",
            f"wq shards heads over {wq} but wo over {wo}: the output "
            "projection's partial sums would mix different head groups")
    if wk != wv:
        add("warning", "gqa-grouping",
            f"wk shards kv heads over {wk} but wv over {wv}: k and v "
            "rows of one group would land on different shards")
    if wq and wk and set(wk) - set(wq):
        add("warning", "gqa-grouping",
            f"wk shards kv heads over {wk} not covered by wq's head "
            f"axes {wq}: kv groups must follow their query heads")
    if wq and not wk and a.num_kv != a.num_heads:
        add("info", "gqa-replicated-kv",
            f"query heads sharded over {wq} with kv heads replicated "
            "(legal GQA fallback; each shard repeats kv locally)")


def _norm(spec, ndim: int):
    out = []
    for i in range(ndim):
        axes = spec[i] if spec is not None and i < len(spec) else ()
        out.append(tuple(axes))
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def _check_edges(findings: List[Finding], subject: str, graph, strategy,
                 axis_sizes) -> None:
    for node in graph.nodes:
        view = strategy.get(node.name, node.sharding)
        if view is None:
            continue
        for e in graph.out_edges(node):
            dst = graph.node(e.dst)
            if dst.op_type in PARALLEL_OP_TYPES:
                continue  # the reshard is explicit
            dst_view = strategy.get(dst.name, dst.sharding)
            if dst_view is None or not dst_view.input_specs:
                continue
            din = dst_view.input_spec(e.dst_idx)
            if din is None:
                continue
            shape = node.outputs[e.src_idx]
            src = _norm(view.output_spec(e.src_idx), shape.ndim)
            dstn = _norm(din, shape.ndim)
            if src != dstn:
                where = f"{subject}:{node.name}->{dst.name}" if subject \
                    else f"{node.name}->{dst.name}"
                findings.append(Finding(
                    "consistency", "info", "implicit-reshard", where,
                    f"producer emits {_fmt_spec(src)} but consumer "
                    f"declares input {_fmt_spec(dstn)}: GSPMD inserts the "
                    "reshard implicitly (priced by edge_xfer_time)"))


def _check_attention_comm(findings: List[Finding], subject: str, graph,
                          node, view, axis_sizes, cost_model) -> None:
    """Cross-check: priced comm-spec == lowered comm-spec."""
    from flexflow_tpu_torch.parallel.comm_spec import attention_lowered_comm_spec

    # view may be None (node not covered by the strategy): the cost model
    # then prices NO attention comm, but a mesh-driven ring/ulysses
    # lowering still exchanges — exactly the underpricing to surface
    priced = [st for st in cost_model.attention_comm_spec(graph, node, view)
              if st.kind != "all_reduce"]  # wo psum is view-driven;
    # the exchange legs are where pricing historically drifted
    out = node.outputs[0]
    spec = view.output_spec(0) if view is not None else None
    view_seq = tuple(spec[1]) if spec and len(spec) > 1 and spec[1] else ()
    is_ring = node.op_type == OpType.RING_ATTENTION
    lowered = attention_lowered_comm_spec(
        node.attrs, out.dims[0].size, out.dims[1].size,
        out.dtype.size_bytes, axis_sizes,
        is_ring_op=is_ring, view_seq_axes=view_seq,
    )
    if sorted(st.key() for st in priced) == sorted(
            st.key() for st in lowered):
        return
    where = f"{subject}:{node.name}" if subject else node.name

    def fmt(steps):
        if not steps:
            return "(none)"
        return "; ".join(
            f"{st.kind} over {list(st.axes)} of {st.nbytes}B"
            for st in steps)

    findings.append(Finding(
        "consistency", "error", "comm-spec-mismatch", where,
        f"cost model prices [{fmt(priced)}] but the lowering emits "
        f"[{fmt(lowered)}] — the search would rank strategies against "
        "communication the machine never runs (the round-5 ulysses-h_deg "
        "bug class); align CostModel.attention_comm_spec with "
        "parallel.comm_spec.attention_lowered_comm_spec"))


def check_strategy(graph, strategy: Optional[Dict], axis_sizes: Dict[str, int],
                   cost_model=None, subject: str = "") -> List[Finding]:
    """Run all consistency checks; `strategy` falls back to each node's
    attached sharding when None (post-_apply_strategy graphs)."""
    findings: List[Finding] = []
    strategy = dict(strategy or {})

    known = {n.name for n in graph.nodes}
    stale = sorted(set(strategy) - known)
    if stale:
        sev = "error" if len(stale) == len(strategy) and strategy else "warning"
        findings.append(Finding(
            "consistency", sev, "stale-strategy",
            subject or "strategy",
            f"{len(stale)}/{len(strategy)} strategy entries name nodes "
            f"absent from the graph ({', '.join(stale[:5])}"
            f"{', ...' if len(stale) > 5 else ''}): "
            + ("the whole file matches nothing — wrong model or a stale "
               "export" if sev == "error" else
               "those views are ignored (stale or renamed nodes)")))

    for node in graph.nodes:
        view = strategy.get(node.name, node.sharding)
        if view is None:
            # a view-less attention node still gets the comm cross-check:
            # ring/ulysses lowerings exchange mesh-driven, so "no view"
            # prices zero while the machine still pays — flag it
            if (node.op_type in _ATTN_OPS and node.attrs is not None
                    and cost_model is not None and node.outputs
                    and node.outputs[0].ndim >= 3):
                _check_attention_comm(findings, subject, graph, node, None,
                                      axis_sizes, cost_model)
            continue
        ins = graph.input_shapes(node)
        if node.in_shapes and len(ins) < len(node.in_shapes):
            ins = list(node.in_shapes)
        for i, spec in enumerate(view.output_specs):
            if i < len(node.outputs):
                dims = tuple(d.size for d in node.outputs[i].dims)
                _check_spec(findings, subject, node.name,
                            f"output[{i}]", spec, dims, axis_sizes)
            if spec is not None:
                a = _axes_used_twice_across_dims(spec)
                if a:
                    findings.append(Finding(
                        "consistency", "error", "duplicate-axis",
                        f"{subject}:{node.name}" if subject else node.name,
                        f"output[{i}] uses mesh axis {a!r} on two dims: "
                        f"{_fmt_spec(spec)}"))
        if node.attrs is not None and view.weight_specs:
            try:
                ws = node.attrs.weights(*ins)
            except Exception:
                ws = {}
            for name, wspec in view.weight_specs.items():
                if name not in ws:
                    findings.append(Finding(
                        "consistency", "warning", "unknown-weight",
                        f"{subject}:{node.name}" if subject else node.name,
                        f"view shards weight {name!r} but "
                        f"{node.op_type.name} has weights "
                        f"{sorted(ws) or '(none)'}"))
                    continue
                dims = tuple(d for d in ws[name].shape.dims)
                _check_spec(findings, subject, node.name,
                            f"weight {name!r}", wspec, dims, axis_sizes)
        for i, spec in enumerate(view.input_specs):
            if spec is not None and i < len(ins):
                dims = tuple(d.size for d in ins[i].dims)
                _check_spec(findings, subject, node.name,
                            f"input[{i}]", spec, dims, axis_sizes)
        if node.op_type in _ATTN_OPS and node.attrs is not None:
            _check_gqa(findings, subject, node, view, axis_sizes)
            if cost_model is not None and node.outputs \
                    and node.outputs[0].ndim >= 3:
                _check_attention_comm(findings, subject, graph, node, view,
                                      axis_sizes, cost_model)

    _check_edges(findings, subject, graph, strategy, axis_sizes)
    return findings
