"""Search entry points used by FFModel.compile (counterpart of
flexflow_tpu/search/api.py).

The port's entry points take the mesh's axis sizes ({axis: size}), not a
device mesh: a modeled mesh such as {"data": 2, "model": 4} needs no
devices, and the machine priced is the H100 cluster of that many GPUs
unless config.machine_model_file names another. Measured costs
(config.measure_costs) run on config.device.

Reference analog: FFModel::compile launching GRAPH_OPTIMIZE_TASK
(model.cc:2826) -> PCG::Graph::graph_optimize_task (graph.cc:2046). Two
levels are available, selected by config:
  - search_budget <= 5:  MCMC over per-op views on the FIXED graph
    (FFModel::mcmc_optimize analog) — cheap, no graph rewriting;
  - search_budget > 5:   Unity-style substitution search (GraphXfer
    best-first + view DP), which may rewrite the PCG (inserting parallel
    ops / fusing) and returns the new graph.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.parallel.sharding import ShardingView
from flexflow_tpu_torch.pcg.graph import Graph
from flexflow_tpu_torch.search.cost_model import CostModel
from flexflow_tpu_torch.search.machine_model import (
    H100MachineModel,
    TPUMachineModel,
)


def _cost_model(axis_sizes: Dict[str, int], config) -> CostModel:
    from flexflow_tpu_torch.parallel.mesh import canonical_axes

    axis_sizes = canonical_axes(axis_sizes)
    num_chips = math.prod(axis_sizes.values())
    if config.search_num_devices and config.search_num_devices > num_chips:
        # reference --search-num-workers (model.cc:3692): search for a
        # machine bigger than the one running. Extra chips extend the data
        # axis (the axis every model scales along); non-multiple requests
        # round down to the largest consistent multiple so the machine
        # model and the axis sizes describe the same chip count.
        scale = config.search_num_devices // num_chips
        if scale > 1:
            axis_sizes["data"] = axis_sizes.get("data", 1) * scale
            num_chips = num_chips * scale
        if num_chips != config.search_num_devices:
            import warnings

            warnings.warn(
                f"search_num_devices={config.search_num_devices} is not a "
                f"multiple of the mesh size; searching for {num_chips} chips"
            )
    machine = (
        TPUMachineModel.from_file(config.machine_model_file)
        if config.machine_model_file
        else H100MachineModel.make("h100", num_chips=num_chips)
    )
    # node-crossing detection needs the mesh axis ORDER (outer axes span
    # nodes under row-major device placement), not just participant counts
    machine.axis_order = dict(axis_sizes)
    kw = dict(
        param_parallel=config.enable_parameter_parallel,
        attr_parallel=config.enable_attribute_parallel,
    )
    if getattr(config, "measure_costs", False):
        from flexflow_tpu_torch.search.measured import MeasuredCostModel

        cm = MeasuredCostModel(
            machine, axis_sizes,
            cache_path=config.measure_cache_file, device=config.device, **kw,
        )
        cm.load_cache()
    else:
        cm = CostModel(machine, axis_sizes, **kw)
    # rank candidates with the per-device event simulator when enabled
    # (unity_search.evaluate checks this attribute; harmless elsewhere)
    cm.event_sim = bool(getattr(config, "use_simulator", False))
    return cm


def _maybe_measure(cost, graph, config) -> Optional[Dict[str, float]]:
    """When measure_costs is on, time the graph's op shards on the device
    and calibrate the analytic compute knob BEFORE searching (the
    reference measures inside the cost query, simulator.cc:537; here the
    sweep is up-front so the search loop stays cheap). Returns the fitted
    knobs with the count of op shards measured, or None."""
    from flexflow_tpu_torch.search.measured import MeasuredCostModel

    if not isinstance(cost, MeasuredCostModel):
        return None
    measured = cost.measure_graph(graph, {}, training=True)
    knobs = dict(cost.calibrate(graph, {}), measured=measured,
                 op_shards=len(cost._measured))
    if config.profiling:
        print(f"[search] measured {len(cost._measured)} op shards; "
              f"mxu_eff={cost.machine.mxu_efficiency:.3f}")
    return knobs


def space_dp_strategy(graph, axis_sizes):
    from flexflow_tpu_torch.search.space import default_dp_strategy

    return default_dp_strategy(graph, axis_sizes)


def _collect_playoff_pair(candidates_out, cost, *, winner,
                          baseline, winner_graph, baseline_graph) -> None:
    """Shared winner-vs-baseline pool for the validate_top_k playoff:
    modeled-cost both, drop the baseline when identical to the winner,
    keep the pool sorted best-modeled first."""
    from flexflow_tpu_torch.search.cost_model import graph_cost

    pool = [(graph_cost(winner_graph, winner, cost).time,
             winner_graph, winner)]
    if (winner_graph.structure_hash() != baseline_graph.structure_hash()
            or winner != baseline):
        pool.append((graph_cost(baseline_graph, baseline, cost).time,
                     baseline_graph, baseline))
    candidates_out.extend(sorted(pool, key=lambda t: t[0]))


def _simulate_rerank(candidates_out, cost, config):
    """Re-rank a playoff pool by the event simulator's overlap-aware list
    scheduler (reference simulate_runtime, simulator.cc:822). Shared by
    the Unity and MCMC entry points. Returns the new head
    (sim_cost, graph, strategy) when every candidate simulated, else None
    (native engine unavailable -> pool left untouched)."""
    import warnings

    if candidates_out is None:
        warnings.warn(
            "use_simulator: no playoff pool to re-rank (validate_top_k < 2 "
            "or multi-host) — the search result is the serial-sum ranking"
        )
        return None
    from flexflow_tpu_torch import native
    from flexflow_tpu_torch.search.table import simulated_strategy_cost

    if not native.available():
        warnings.warn(
            "use_simulator requires the native engine (libffsim); the "
            "playoff pool keeps its serial-sum ranking"
        )
        return None
    reranked = []
    for (c, g, s) in candidates_out:
        sim = simulated_strategy_cost(g, cost, s)
        if sim is None:
            return None
        reranked.append((sim, g, s))
    reranked.sort(key=lambda t: t[0])
    candidates_out[:] = reranked
    if config.profiling:
        print("[search] playoff pool re-ranked by event simulator: "
              + ", ".join(f"{c * 1e3:.3f}" for c, _, _ in reranked))
    return reranked[0]


def search_strategy(graph, axis_sizes: Dict[str, int], config,
                    candidates_out=None) -> Dict[str, ShardingView]:
    """Views-only search on a fixed graph (MCMC). `candidates_out`: when a
    list is passed, receives the (modeled_cost, graph, strategy) pair of
    the MCMC winner and the plain-DP baseline for the validate_top_k timed
    playoff — same contract as graph_optimize."""
    from flexflow_tpu_torch.search.mcmc import mcmc_search

    cost = _cost_model(axis_sizes, config)
    _maybe_measure(cost, graph, config)
    strategy = mcmc_search(graph, axis_sizes, config, cost=cost)
    # no playoff pool under memory_search: the DP baseline (full weight
    # replication) may exceed the memory limit the search honored, and the
    # playoff would compile and run the over-limit layout (the memory-λ
    # graph_optimize path skips collection for the same reason)
    if candidates_out is not None and not config.memory_search:
        base = space_dp_strategy(graph, cost.axis_sizes)
        _collect_playoff_pair(
            candidates_out, cost,
            winner=strategy, baseline=base,
            winner_graph=graph, baseline_graph=graph,
        )
        if getattr(config, "use_simulator", False):
            # the anneal optimized the simulated objective; rank the
            # playoff pool on the same scale
            head = _simulate_rerank(candidates_out, cost, config)
            if head is not None:
                strategy = head[2]
    return strategy


def graph_optimize(graph: Graph, axis_sizes: Dict[str, int], config,
                   candidates_out=None, stats_out=None
                   ) -> Tuple[Graph, Dict[str, ShardingView]]:
    """Full Unity search: substitutions + view DP. Returns (possibly
    rewritten graph, strategy). `candidates_out`: optional list receiving
    the top-k modeled candidates for empirical whole-step validation. The
    flat best-first path fills it with its k best distinct candidates;
    the sequence-DP stitched path contributes a winner-vs-unrewritten-
    baseline pair instead; only the memory-λ path skips collection."""
    import time as _time

    from flexflow_tpu_torch.search.substitution import (
        memory_lambda_search,
        pick_search_fn,
        sequence_unity_search,
    )

    _t0 = _time.perf_counter()
    cost = _cost_model(axis_sizes, config)
    knobs = _maybe_measure(cost, graph, config)
    if stats_out is not None and knobs is not None:
        stats_out["measured"] = knobs
    if (stats_out is not None
            and getattr(cost.machine, "chips_per_slice", None)):
        # which mesh axes' collectives leave the node (InfiniBand) or the
        # slice (DCN) on this machine
        stats_out["dcn_axes"] = [
            a for a, s in cost.axis_sizes.items()
            if s > 1 and cost.machine._crosses_dcn(s, (a,))
        ]
    if config.memory_search:
        # memory-aware path: λ binary search blending run time and per-chip
        # memory (graph.cc:2046-2131 analog)
        best_graph, strategy, gc = memory_lambda_search(
            graph, cost,
            memory_limit=cost.machine.memory_per_chip(),
            budget=config.search_budget,
            alpha=config.search_alpha,
        )
        if config.profiling:
            print(f"[search] best estimated step time {gc.time * 1e3:.3f} ms "
                  f"@ {gc.memory_per_chip / 2**30:.2f} GiB/chip")
        return best_graph, strategy
    # deep graphs: sequence-DP decomposition at module boundaries
    # (generic_sequence_optimize, substitution.cc:2572) — per-module
    # best-first is ~linear in depth where the flat search is not
    fn = pick_search_fn(graph)
    kw = {}
    exclude = getattr(config, "exclude_rules", None)
    if exclude:
        # rule-ablation hook (tools/rule_coverage.py --profit): run the
        # identical search minus the named rules to price each rule's
        # contribution to the winner
        from flexflow_tpu_torch.search.substitution import default_xfers

        drop = set(exclude)
        kw["xfers"] = [x for x in default_xfers(cost.axis_sizes)
                       if getattr(x, "name", None) not in drop]
    runner_up = None
    if candidates_out is not None:
        kw["candidates_out"] = candidates_out
        kw["candidates_k"] = max(getattr(config, "validate_top_k", 0), 2)
        if fn is sequence_unity_search:
            runner_up = kw["runner_up_out"] = []
    if stats_out is not None:
        kw["stats_out"] = stats_out
    best_graph, strategy, best_time = fn(
        graph,
        cost,
        budget=config.search_budget,
        alpha=config.search_alpha,
        **kw,
    )
    if stats_out is not None:
        # search-cost observability: regressions in corpus size / pattern
        # matching show up here (and in the gates that record this)
        stats_out["wall_s"] = _time.perf_counter() - _t0
        stats_out["best_cost"] = best_time
        stats_out["graph_nodes"] = len(graph)
    if candidates_out is not None and not candidates_out:
        # the sequence-DP path stitched per-module results and built no
        # whole-graph pool; give the playoff the next-best pair — the
        # stitched winner vs the UNREWRITTEN graph at its own optimal
        # views (catches a search result that models faster but compiles
        # slower than the plain graph)
        from flexflow_tpu_torch.search.dp import ViewDP

        _collect_playoff_pair(
            candidates_out, cost,
            winner=strategy, baseline=ViewDP(cost).optimize(graph),
            winner_graph=best_graph, baseline_graph=graph,
        )
        if len(candidates_out) == 1 and runner_up:
            # the stitched winner is the graph as built: the playoff
            # times the best rewrite the module searches saw against it
            # (the port's addition; the reference times nothing then)
            candidates_out.extend(runner_up)
            candidates_out.sort(key=lambda t: t[0])
    if getattr(config, "use_simulator", False) and candidates_out:
        # re-rank the playoff pool with the event simulator's overlap-
        # aware list scheduler: a candidate whose grad allreduces hide
        # behind later compute can beat one the serial sum prefers. The
        # simulator's pick becomes the modeled winner (the timed playoff,
        # when enabled, still gets the final word on hardware). With no
        # pool (validate_top_k<2) the search result is ALREADY simulator-
        # ranked via evaluate()'s event_sim path — nothing to re-rank.
        head = _simulate_rerank(candidates_out, cost, config)
        if head is not None:
            best_time, best_graph, strategy = head
    if config.profiling:
        print(f"[search] best estimated step time {best_time * 1e3:.3f} ms")
    return best_graph, strategy
