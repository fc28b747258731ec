"""Machine-view DP over graph structure (the Unity inner search)
(counterpart of flexflow_tpu/search/dp.py, the same logic).

Reference analog: SearchHelper::graph_cost (graph.cc:1586): recursively
decompose the PCG — bottleneck (dominator) node -> sequence split trying
every view at the boundary; otherwise a horizontal split of independent
branches; memoize by (graph hash, boundary views). The base case here is an
exhaustive product for tiny subgraphs and coordinate-descent otherwise
(replacing the reference's per-node exhaustive machine-view scan, which is
cheap for device lists but exponential for named-axis specs).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Tuple

from flexflow_tpu_torch.parallel.sharding import ShardingView
from flexflow_tpu_torch.pcg.graph import Graph
from flexflow_tpu_torch.search import space
from flexflow_tpu_torch.search.cost_model import CostModel, graph_cost


class ViewDP:
    def __init__(self, cost: CostModel, *, training: bool = True,
                 max_exhaustive: int = 4, product_cap: int = 4096,
                 objective: Optional[Callable[[float, float], float]] = None):
        self.cost = cost
        self.training = training
        self.max_exhaustive = max_exhaustive
        # objective(time, memory_per_chip) -> scalar; None = pure run time.
        # The memory-λ search (graph.cc:2046) passes a blend here so the DP
        # itself prefers memory-lean views, not just the outer loop.
        # CONTRACT: must be LINEAR in (time, memory) — the horizontal
        # decomposition solves independent components separately, which is
        # exact only when the objective distributes over the additive cost
        # terms (the built-in λ-blend does; a hard-threshold penalty would
        # not).
        self.objective = objective
        # exhaustive base case bound: total view-combination count, not node
        # count — a 6-node module with 3 views each (432 combos) is cheap to
        # solve exactly, and exactness is what crosses TP chain barriers
        # (col-linear → sharded elementwise → row-linear must flip together)
        self.product_cap = product_cap
        self._memo: Dict = {}
        self._cands_memo: Dict[int, Dict[str, List[ShardingView]]] = {}

    def optimize(self, graph: Graph) -> Dict[str, ShardingView]:
        strategy = self._solve(graph, {})
        # fill uncovered nodes with DP defaults (attached rewrite views are
        # preserved through _candidates, which makes every such node
        # searchable with its own view as a candidate)
        base = space.default_dp_strategy(graph, self.cost.axis_sizes)
        base.update(strategy)
        return base

    # ------------------------------------------------------------------

    def _solve(self, graph: Graph, fixed: Dict[str, ShardingView]) -> Dict[str, ShardingView]:
        key = (graph.structure_hash(), tuple(sorted((k, hash(v)) for k, v in fixed.items())))
        if key in self._memo:
            return self._memo[key]
        result = self._solve_uncached(graph, fixed)
        self._memo[key] = result
        return result

    def _candidates(self, graph: Graph) -> Dict[str, List[ShardingView]]:
        # memoized by structure: per-component sub-solves re-enter with the
        # same graph and must not redo full enumeration
        ck = graph.structure_hash()
        hit = self._cands_memo.get(ck)
        if hit is not None:
            return hit
        out = {}
        for n in graph.nodes:
            views = space.enumerate_views(
                n, self.cost.axis_sizes,
                param_parallel=self.cost.param_parallel,
                attr_parallel=self.cost.attr_parallel,
            )
            # the node's attached view (substitution-carried) is always a
            # candidate, first so it is the solver's starting point — a
            # rewrite-carried view the enumeration can't express (e.g. TP
            # over a seq/expert axis) must not be silently reset to DP
            if n.sharding is not None and n.sharding not in views:
                views = [n.sharding] + views
            if len(views) > 1:
                out[n.name] = views
        self._cands_memo[ck] = out
        return out

    def _searchable_components(self, graph: Graph,
                               cands: Dict[str, List[ShardingView]]):
        """Connected components of the searchable nodes, linked only by
        DIRECT searchable-searchable edges (paths through fixed or
        choice-free nodes do not couple choices: those nodes' views are
        constants, so every cost term factors per component)."""
        names = set(cands)
        within = {n for n in graph.nodes if n.name in names}
        return [{n.name for n in comp}
                for comp in graph.connected_components(within)]

    def _eval(self, graph: Graph, strategy: Dict[str, ShardingView]) -> float:
        gc = graph_cost(graph, strategy, self.cost, self.training)
        if self.objective is not None:
            return self.objective(gc.time, gc.memory_per_chip)
        return gc.time

    def _solve_uncached(self, graph: Graph, fixed) -> Dict[str, ShardingView]:
        cands = {k: v for k, v in self._candidates(graph).items() if k not in fixed}
        if not cands:
            return dict(fixed)

        product = 1
        for v in cands.values():
            product *= len(v)
            if product > self.product_cap:
                break
        if product <= self.product_cap:
            # exhaustive product (optimal for this module). Costs are
            # priced ONCE per (node, view) and per edge view-pair into
            # tables (the reference's strict-hash cost cache discipline);
            # each combination is then a cheap table sum instead of a full
            # graph_cost walk.
            table = self._priced_table(graph, cands, fixed)
            searchable = table.searchable()

            def tab_cost(a) -> float:
                t, m = table.eval(a)
                return self.objective(t, m) if self.objective else t

            assign = [0] * len(table.nodes)
            best_assign, best_cost = list(assign), tab_cost(assign)
            view_counts = [len(table.views[i]) for i in searchable]
            for combo in itertools.product(*(range(c) for c in view_counts)):
                for idx, k in zip(searchable, combo):
                    assign[idx] = k
                c = tab_cost(assign)
                if c < best_cost:
                    best_assign, best_cost = list(assign), c
            strategy = dict(fixed)
            strategy.update(table.to_strategy(best_assign))
            return strategy

        # horizontal decomposition (graph.cc:267 / split_horizontal's role):
        # searchable nodes whose every connection to the other searchable
        # nodes runs through a fixed or choice-free node are independent —
        # node, edge, and weight-sync costs all separate — so each component
        # solves exactly on its own (often making the exhaustive base case
        # reachable where the joint product blows the cap)
        comps = self._searchable_components(graph, cands)
        if len(comps) > 1:
            strategy = dict(fixed)
            for comp in comps:
                f = dict(fixed)
                for name in cands:
                    if name not in comp:
                        f[name] = cands[name][0]  # pinned; costs separate
                sub = self._solve(graph, f)
                strategy.update({k: v for k, v in sub.items() if k in comp})
            return strategy

        # sequence split at a bottleneck (graph.cc:115)
        if len(graph) > self.max_exhaustive:
            b = graph.find_bottleneck_node()
            if b is not None and b.name in cands:
                best, best_cost = None, float("inf")
                first, second = graph.split_at_node(b)
                for view in cands[b.name]:
                    f = dict(fixed)
                    f[b.name] = view
                    s1 = self._solve(first, {k: v for k, v in f.items()
                                             if any(n.name == k for n in first.nodes)})
                    s2 = self._solve(second, {k: v for k, v in f.items()
                                              if any(n.name == k for n in second.nodes)})
                    merged = dict(f)
                    merged.update(s1)
                    merged.update(s2)
                    c = self._eval(graph, merged)
                    if c < best_cost:
                        best, best_cost = merged, c
                if best is not None:
                    return best
            elif b is not None:
                # bottleneck exists but has no choices: solve halves
                first, second = graph.split_at_node(b)
                s1 = self._solve(first, {k: v for k, v in fixed.items()
                                         if any(n.name == k for n in first.nodes)})
                s2 = self._solve(second, {k: v for k, v in fixed.items()
                                          if any(n.name == k for n in second.nodes)})
                merged = dict(fixed)
                merged.update(s1)
                merged.update(s2)
                return merged

        # fallback: coordinate descent (2 sweeps) on a priced StrategyTable
        # — each flip is a table sum instead of a full graph_cost walk
        # (the r4 form re-walked the graph per candidate flip, and on
        # 3-axis meshes that dominated the whole search: ~550s of a
        # budget-12 llama solve was spent here)
        table = self._priced_table(graph, cands, fixed)

        def tab_cost(a) -> float:
            t, m = table.eval(a)
            return self.objective(t, m) if self.objective else t

        # seed from each node's FIRST candidate (substitution-carried
        # views come first in _candidates): starting from the all-base
        # assignment would reset a rewrite's coupled TP chain to DP, and
        # single flips cannot climb back across the resharding barrier
        assign = [0] * len(table.nodes)
        searchable = table.searchable()
        for i, node in enumerate(table.nodes):
            first = cands.get(node.name, (None,))[0]
            if first is not None and first in table.views[i]:
                assign[i] = table.views[i].index(first)
        cur = tab_cost(assign)
        for _ in range(2):
            improved = False
            for i in searchable:
                best_k, best_c = assign[i], cur
                for k in range(len(table.views[i])):
                    if k == assign[i]:
                        continue
                    assign[i] = k
                    c = tab_cost(assign)
                    if c < best_c - 1e-15:
                        best_k, best_c = k, c
                assign[i] = best_k
                if best_c < cur - 1e-15:
                    cur, improved = best_c, True
            if not improved:
                break
        strategy = dict(fixed)
        strategy.update(table.to_strategy(assign))
        return strategy

    def _priced_table(self, graph: Graph, cands, fixed):
        """StrategyTable over `cands` with non-candidate nodes held at the
        divisibility/submesh-aware DP defaults (the same base optimize()
        fills) — a naive batch spec here would both mis-price choice-free
        nodes inside the table and leak worse-than-default views into the
        returned strategy. Shared by the exhaustive and coordinate-descent
        branches so the two can never price the same graph differently."""
        from flexflow_tpu_torch.search.table import build_table

        base = space.default_dp_strategy(graph, self.cost.axis_sizes)
        base.update(fixed)
        return build_table(graph, self.cost, cands, base, self.training)


def greedy_polish(graph: Graph, strategy: Dict[str, ShardingView],
                  cost: CostModel, *, training: bool = True,
                  sweeps: int = 4, memory_limit: Optional[float] = None,
                  objective=None, table=None,
                  start=None) -> Tuple[Dict[str, ShardingView], float]:
    """Hill-climb view flips until a sweep finds no improvement: single-node
    flips plus joint flips of edge endpoints. The pair moves matter: a TP
    chain only pays off when producer and consumer switch together, so a
    single-flip climber stalls at the resharding barrier between them.
    Runs on a StrategyTable, so each move is a cheap table sum instead of a
    full graph_cost walk (the reference polishes inside the annealing loop
    against its cached measurements, model.cc:3317) — the sweep itself is
    search.table.coordinate_descent, shared with the serving-strategy
    search's knob polish. Callers that already priced a table over the
    same candidate set (mcmc_optimize) pass it in via `table`/`start` to
    avoid re-pricing every (node, view) pair; `memory_limit`/`objective`
    keep the polish honoring the same constraint the search enforced."""
    from flexflow_tpu_torch.search.table import build_table, coordinate_descent

    if table is None:
        candidates = {}
        for n in graph.nodes:
            views = space.enumerate_views(
                n, cost.axis_sizes, param_parallel=cost.param_parallel,
                attr_parallel=cost.attr_parallel,
            )
            if len(views) > 1:
                candidates[n.name] = views
        table = build_table(graph, cost, candidates, dict(strategy), training)
    assign = list(start) if start is not None else [0] * len(table.nodes)

    def ev(a) -> float:
        t, m = table.eval(a)
        if objective is not None:
            return objective(t, m)
        if memory_limit and m > memory_limit:
            t += 1e3 * (m / memory_limit)
        return t

    coordinate_descent(table, assign, ev, sweeps=sweeps)
    s = dict(strategy)
    s.update(table.to_strategy(assign))
    return s, graph_cost(graph, s, cost, training).time
