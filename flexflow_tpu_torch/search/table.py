"""Strategy cost tables: price every (node, candidate view) pair once
(counterpart of flexflow_tpu/search/table.py, the same logic).

Bridge between the Python cost model (search/cost_model.py) and the native
search engine (native/ffsim.cc loaded via flexflow_tpu_torch.native): the
reference caches measured op costs by (params, machine view)
(strict_hash_to_operator_cost, simulator.cc:542); here the analytic model
fills dense tables instead, and both the C++ MCMC loop and the Python
fallback evaluate assignments from the same tables — so the two paths
agree exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.parallel.sharding import ShardingView
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.search.cost_model import CostModel


@dataclasses.dataclass
class StrategyTable:
    nodes: List[Node]
    views: List[List[Optional[ShardingView]]]  # per node: candidate views
    compute: List[List[float]]
    comm: List[List[float]]
    sync: List[List[float]]
    memory: List[List[float]]
    # (src_index, dst_index, xfer[ku][kv])
    edges: List[Tuple[int, int, List[List[float]]]]

    def searchable(self) -> List[int]:
        return [i for i, v in enumerate(self.views) if len(v) > 1]

    # -- evaluation (Python fallback; mirrors ffsim_eval) ---------------

    def eval(self, assignment: Sequence[int], overlap: float = 0.0):
        compute = comm = mem = 0.0
        for i, k in enumerate(assignment):
            compute += self.compute[i][k]
            comm += self.comm[i][k] + self.sync[i][k]
            mem += self.memory[i][k]
        for src, dst, xfer in self.edges:
            comm += xfer[assignment[src]][assignment[dst]]
        return compute + comm * (1.0 - overlap), mem

    def to_strategy(self, assignment: Sequence[int]) -> Dict[str, ShardingView]:
        out = {}
        for i, k in enumerate(assignment):
            v = self.views[i][k]
            if v is not None:
                out[self.nodes[i].name] = v
        return out

    def to_native(self):
        """Upload the tables into a NativeSimGraph (caller checked
        native.available())."""
        from flexflow_tpu_torch.native import NativeSimGraph

        g = NativeSimGraph(len(self.nodes))
        for i in range(len(self.nodes)):
            g.set_node(i, self.compute[i], self.comm[i], self.sync[i],
                       self.memory[i])
        for src, dst, xfer in self.edges:
            g.add_edge(src, dst, xfer)
        return g


def coordinate_descent(table, assign, ev, *, sweeps: int = 4,
                       pairs: bool = True) -> float:
    """Greedy hill-climb over `assign` IN PLACE: per-sweep, try every
    alternative view at every searchable index (plus joint flips of edge
    endpoints when `pairs`), keep strict improvements, stop when a sweep
    finds none. `ev(assignment) -> float` is whatever objective the
    caller optimizes — the summed cost tables for the sharding polish
    (search/dp.py greedy_polish), the SLO objective for the serving knob
    table (search/servesearch.py). Returns the final cost."""
    cur = ev(assign)
    searchable = set(table.searchable())
    for _ in range(sweeps):
        improved = False
        for i in sorted(searchable):
            best_k, best_c = assign[i], cur
            for k in range(len(table.views[i])):
                if k == assign[i]:
                    continue
                assign[i] = k
                c = ev(assign)
                if c < best_c - 1e-15:
                    best_k, best_c = k, c
            assign[i] = best_k
            if best_c < cur - 1e-15:
                cur, improved = best_c, True
        if pairs:
            for src, dst, _ in table.edges:
                if src not in searchable or dst not in searchable:
                    continue
                best_pair, best_c = (assign[src], assign[dst]), cur
                for ks in range(len(table.views[src])):
                    for kd in range(len(table.views[dst])):
                        if (ks, kd) == (assign[src], assign[dst]):
                            continue
                        assign[src], assign[dst] = ks, kd
                        c = ev(assign)
                        if c < best_c - 1e-15:
                            best_pair, best_c = (ks, kd), c
                assign[src], assign[dst] = best_pair
                if best_c < cur - 1e-15:
                    cur, improved = best_c, True
        if not improved:
            break
    return cur


def simulated_strategy_cost(graph: Graph, cost: CostModel,
                            strategy: Dict[str, ShardingView],
                            training: bool = True) -> Optional[float]:
    """Overlap-aware step time of ONE fixed strategy through the native
    event simulator (the reference's simulate_runtime, simulator.cc:822).
    Prefers the PER-DEVICE task simulator (search/eventsim.py: per-chip
    compute channels, per-axis ICI channels, pipeline/ring wave expansion);
    falls back to the two-channel list scheduler (ffsim_simulate) for
    oversized meshes, and to None when the native engine is unavailable."""
    from flexflow_tpu_torch import native

    if not native.available():
        return None
    from flexflow_tpu_torch.search.eventsim import simulate_graph

    sim = simulate_graph(graph, strategy, cost, training)
    if sim is not None:
        return sim
    table = build_table(graph, cost, {}, strategy, training)
    return table.to_native().simulate([0] * len(table.nodes))


def build_table(
    graph: Graph,
    cost: CostModel,
    candidates: Dict[str, List[ShardingView]],
    base_strategy: Dict[str, ShardingView],
    training: bool = True,
) -> StrategyTable:
    nodes = list(graph.topo_order())
    index = {n.guid: i for i, n in enumerate(nodes)}

    views: List[List[Optional[ShardingView]]] = []
    for n in nodes:
        base = base_strategy.get(n.name, n.sharding)
        vlist: List[Optional[ShardingView]] = [base]
        for v in candidates.get(n.name, ()):
            if v not in vlist:
                vlist.append(v)
        views.append(vlist)

    compute, comm, sync, memory = [], [], [], []
    for n, vlist in zip(nodes, views):
        compute.append([cost.node_compute_time(graph, n, v, training) for v in vlist])
        comm.append([cost.node_comm_time(graph, n, v) for v in vlist])
        sync.append([cost.weight_sync_time(graph, n, v) if training else 0.0
                     for v in vlist])
        memory.append([cost.node_memory(graph, n, v, training) for v in vlist])

    edges = []
    for n in nodes:
        for e in graph.out_edges(n):
            si, di = index[e.src], index[e.dst]
            shape = n.outputs[e.src_idx]
            mat = []
            for sv in views[si]:
                row = []
                src_spec = sv.output_spec(e.src_idx) if sv else None
                for dv in views[di]:
                    dst_spec = None
                    if dv is not None:
                        dst_spec = dv.input_spec(e.dst_idx)
                        if dst_spec is None:
                            dst_spec = dv.output_spec(0)
                    row.append(cost.edge_xfer_time(shape, src_spec, dst_spec))
                mat.append(row)
            edges.append((si, di, mat))

    return StrategyTable(nodes, views, compute, comm, sync, memory, edges)
