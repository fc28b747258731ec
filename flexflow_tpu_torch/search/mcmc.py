"""MCMC strategy search (simulated annealing over per-op ShardingViews)
(counterpart of flexflow_tpu/search/mcmc.py, the same logic).

Reference analog: FFModel::mcmc_optimize (model.cc:3285-3356): start from
data parallel, propose "random op -> random legal config", accept improving
moves always and worsening moves with prob exp(-alpha * diff), track the
best strategy seen within the budget.

The hot loop runs in the native C++ engine (native/ffsim.cc) when the
library is available — the reference's search is C++ for the same reason —
with a pure-Python fallback evaluating the identical cost tables.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Optional

from flexflow_tpu_torch.parallel.sharding import ShardingView
from flexflow_tpu_torch.pcg.graph import Graph
from flexflow_tpu_torch.search import space
from flexflow_tpu_torch.search.cost_model import CostModel
from flexflow_tpu_torch.search.table import build_table


def anneal_assignment(table, start, evaluate, *, budget: int = 200,
                      alpha: float = 0.05, seed: int = 0,
                      verbose: bool = False):
    """The annealing loop itself, over any StrategyTable-shaped search
    space (anything with `views` and `searchable()`) and any `evaluate`
    callable over assignments — the reference's accept rule
    (model.cc:3285-3356) verbatim: improving moves always, worsening
    moves with prob exp(-alpha * relative diff * 100). Returns
    (best_assignment, best_cost). Shared by the sharding search fallback
    below and the serving-strategy search (search/servesearch.py), whose
    knob table evaluates an SLO objective instead of the summed cost
    tables — one driver, two objectives."""
    rng = random.Random(seed)
    searchable = table.searchable()
    cur = list(start)
    cur_cost = evaluate(cur)
    best, best_cost = list(cur), cur_cost
    if not searchable:
        return best, best_cost
    for it in range(budget):
        i = rng.choice(searchable)
        k = rng.randrange(len(table.views[i]))
        if k == cur[i]:
            continue
        prev = cur[i]
        cur[i] = k
        nxt_cost = evaluate(cur)
        diff = nxt_cost - cur_cost
        if diff < 0 or rng.random() < math.exp(
                -alpha * diff / max(cur_cost, 1e-12) * 100):
            cur_cost = nxt_cost
            if cur_cost < best_cost:
                best, best_cost = list(cur), cur_cost
                if verbose:
                    print(f"mcmc iter {it}: best {best_cost * 1e3:.3f} ms")
        else:
            cur[i] = prev
    return best, best_cost


def mcmc_optimize(
    graph: Graph,
    cost: CostModel,
    *,
    budget: int = 200,
    alpha: float = 0.05,
    seed: int = 0,
    training: bool = True,
    memory_limit: Optional[float] = None,
    verbose: bool = False,
    use_simulate: bool = False,
    polish: bool = True,
) -> Dict[str, ShardingView]:
    axis_sizes = cost.axis_sizes

    candidates = {}
    for node in graph.nodes:
        views = space.enumerate_views(
            node, axis_sizes, param_parallel=cost.param_parallel,
            attr_parallel=cost.attr_parallel,
        )
        if len(views) > 1:
            candidates[node.name] = views
    base = space.default_dp_strategy(graph, axis_sizes)
    if not candidates:
        return base

    table = build_table(graph, cost, candidates, base, training)
    start = [0] * len(table.nodes)

    from flexflow_tpu_torch import native

    if native.available():
        g = table.to_native()
        best_assign, best_cost, _ = g.mcmc(
            start, budget=budget, alpha=alpha, seed=seed,
            memory_limit=memory_limit or 0.0, use_simulate=use_simulate,
        )
        if verbose:
            print(f"mcmc (native): best {best_cost * 1e3:.3f} ms")
        strategy = table.to_strategy(best_assign)
        # polish hill-climbs the summed-table objective; under use_simulate
        # the anneal optimized the event-driven SIMULATED cost, and a flip
        # that improves the sum can lengthen the simulated critical path —
        # so the simulator's answer is returned unpolished
        if polish and not use_simulate:
            from flexflow_tpu_torch.search.dp import greedy_polish

            strategy, polished_cost = greedy_polish(
                graph, strategy, cost, training=training,
                memory_limit=memory_limit, table=table, start=best_assign,
            )
            if verbose:
                print(f"mcmc polished: {polished_cost * 1e3:.3f} ms")
        return strategy

    # ---- pure-Python fallback over the same tables --------------------
    if use_simulate:
        raise NotImplementedError(
            "use_simulate requires the native engine (libffsim failed to "
            "build); the Python fallback only evaluates the summed cost"
        )

    def evaluate(a):
        t, mem = table.eval(a)
        # match the native sentinel: a limit of 0 (or None) disables the check
        if memory_limit and mem > memory_limit:
            t += 1e3 * (mem / memory_limit)
        return t

    best, _ = anneal_assignment(table, start, evaluate, budget=budget,
                                alpha=alpha, seed=seed, verbose=verbose)
    strategy = table.to_strategy(best)
    if polish:
        from flexflow_tpu_torch.search.dp import greedy_polish

        strategy, _ = greedy_polish(graph, strategy, cost, training=training,
                                    memory_limit=memory_limit, table=table,
                                    start=best)
    return strategy


def mcmc_search(graph: Graph, axis_sizes: Dict[str, int], config,
                cost=None) -> Dict[str, ShardingView]:
    """Entry used by FFModel.compile (search/api.py)."""
    if cost is None:
        from flexflow_tpu_torch.search.api import _cost_model

        cost = _cost_model(axis_sizes, config)
    machine = cost.machine
    return mcmc_optimize(
        graph,
        cost,
        budget=max(config.search_budget, 1) * 50,
        alpha=config.search_alpha - 1.0 if config.search_alpha > 1 else 0.05,
        memory_limit=machine.memory_per_chip() if config.memory_search else None,
        verbose=config.profiling,
        use_simulate=getattr(config, "use_simulator", False),
    )
