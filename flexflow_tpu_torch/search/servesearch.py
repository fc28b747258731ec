"""Serving-strategy search: the strategy search turned loose on the
serving tick (counterpart of flexflow_tpu/search/servesearch.py; the
same knob space, the same closed-form pricing, the same drivers).

Every serving knob (`page_size`, `prefill_chunk`, spec tree width/depth,
`megastep_ticks`, `megastep_mixed` / `overlap_dispatch`, `ragged_pack`,
pool size, KV storage dtype, host tier, mesh layout) is a point in one
space this module searches:

  1. a `ServeStrategy` names one point in the serving knob space and
     knows how to configure `serve_generation` (`to_server_kwargs`); its
     JSON form and fingerprint are byte-identical to the reference's, so
     a strategy file written by either package loads in both;
  2. `ServePricer` prices one strategy's serving tick against a named
     traffic profile (search/traffic.py): ragged launch shapes and
     padding waste, chunked-prefill TTFT, the spec tree's expected
     accepted tokens/step (SpecConfig.expected_tokens_per_step),
     megastep host-roundtrip amortization (cost_model.TickPricer), page
     size vs pool occupancy, and the KV pool's HBM bill
     (cost_model.kv_cache_token_bytes) — with the per-token compute rate
     coming from the SAME step pricing the sharding search uses
     (eventsim.step_seconds), per candidate mesh layout. The machine is
     search/api._cost_model's: the H100 (80 GB of HBM, the pool's bill
     against it) unless the config names a machine-model file;
  3. the EXISTING drivers search the space: mcmc.anneal_assignment over
     a knob-valued StrategyTable, table.coordinate_descent as the
     polish, and mcmc_optimize itself pricing each candidate mesh
     layout's step — one search machinery, train and serve;
  4. `fftrace calibrate` reports (obs/calibrate.py: ticks measured on
     the card, stamped with its name) feed `MeasuredCostModel.
     set_tick_calibration`, so measured per-tick-shape wall times scale
     the analytic prices (reports older than the staleness window are
     REFUSED).

A calibration scales the tick prices and nothing else: where the caller
priced with the analytic CostModel, the scales ride a MeasuredCostModel
that only holds them (the port's MeasuredCostModel times an op shard on
the card at its first query, so pricing the layouts with it would turn a
calibrated search into a measuring one; the reference's holds no timings
there either, so both price the same step). A mesh layout of more than
one card may be priced; serving it raises, as the port's meshes do
(ROADMAP.md, queue 1 item 12).

Surface: `serve_generation(search_budget=...)` /
`FFModel.serve_generation(...)` run the search at serve time;
`python -m flexflow_tpu_torch.tools.servesearch` (search / simulate /
explain / apply) emits the winning strategy as JSON the server loads
back.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import logging
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.search.cost_model import (
    HOST_DISPATCH_SECONDS,
    TickPricer,
    graph_cost,
    kv_cache_elem_counts,
    kv_cache_token_bytes,
)
from flexflow_tpu_torch.search.table import StrategyTable, coordinate_descent
from flexflow_tpu_torch.spec.config import SpecConfig

logger = logging.getLogger(__name__)

# A calibration report older than this is refused (with a warning), not
# silently used.
CALIBRATION_MAX_AGE_S = 7 * 24 * 3600

# Objective assigned to knob combinations serve_generation would reject
# (spec + megastep, oversized pages, ...): finite so the anneal's accept
# rule stays well-defined, large enough that no walk settles there.
INVALID_OBJECTIVE = 1e9

# The spec-acceptance prior used when neither the caller nor the traffic
# profile supplies one (a RecordedProfile's measured acceptance wins —
# see search_serve_strategy's acceptance_rate resolution).
DEFAULT_ACCEPTANCE_RATE = 0.6


def _prefill_window_rows() -> int:
    # lazy: keeps `search/` importable without the serving stack
    from flexflow_tpu_torch.paged.scheduler import PREFILL_WINDOW_ROWS

    return PREFILL_WINDOW_ROWS


# ---------------------------------------------------------------------------
# Strategy + objective


@dataclasses.dataclass(frozen=True)
class ServeStrategy:
    """One point in the serving knob space — everything
    `serve_generation(paged=True)` lets a caller choose, in one
    JSON-serializable value the search walks and the server loads.

    spec_width/spec_depth 0 = speculation off; `mesh` is the serving
    mesh layout as sorted (axis, size) pairs, () = the compiled mesh.
    pool_fraction scales the page pool against the dense capacity
    (slots x pages-per-seq) — the HBM knob; 1.0 keeps the server
    default. kv_dtype picks the pool's storage dtype
    (paged.quant.KV_DTYPES; "auto" = the model's own dtype, "int8" =
    quantized pages with the per-page scale sidecar) — the OTHER HBM
    knob, trading bytes per cached token against a bounded logit
    error instead of trading pages away. host_tier_pages sizes the
    host-RAM KV spill tier (disagg.HostTier) in pages; 0 = no tier
    (LRU evictions drop pages, prefix misses recompute). A tier lets
    the pool trade a PCIe fetch for a prefill recompute — whether
    that wins depends on traffic, which is exactly what the search
    decides."""

    page_size: int = 64
    prefill_chunk: int = 64
    spec_width: int = 0
    spec_depth: int = 0
    megastep_ticks: int = 1
    megastep_mixed: bool = False
    overlap_dispatch: bool = False
    ragged_pack: bool = True
    pool_fraction: float = 1.0
    kv_dtype: str = "auto"
    host_tier_pages: int = 0
    mesh: Tuple[Tuple[str, int], ...] = ()

    def validate(self, max_len: Optional[int] = None) -> None:
        """Raise ValueError on combinations serve_generation rejects —
        the SAME constraints, so a searched strategy is a servable one."""
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.megastep_ticks < 1:
            raise ValueError(
                f"megastep_ticks must be >= 1, got {self.megastep_ticks}")
        if not (0.0 < self.pool_fraction <= 1.0):
            raise ValueError(
                f"pool_fraction must be in (0, 1], got {self.pool_fraction}")
        if self.host_tier_pages < 0:
            raise ValueError(
                f"host_tier_pages must be >= 0, got {self.host_tier_pages}")
        if (self.spec_width >= 1) != (self.spec_depth >= 1):
            raise ValueError(
                f"spec_width/spec_depth must both be 0 or both >= 1, got "
                f"{self.spec_width}x{self.spec_depth}")
        if self.overlap_dispatch and not self.megastep_mixed:
            raise ValueError(
                "overlap_dispatch overlaps host work with the in-flight "
                "MIXED megastep dispatch; it requires megastep_mixed")
        if (self.spec_width >= 1 and self.megastep_ticks > 1
                and not self.megastep_mixed):
            raise ValueError(
                "speculative decoding and megastep_ticks > 1 are mutually "
                "exclusive (the fused decode loop cannot host verify "
                "ticks) — unless megastep_mixed fuses verify on device")
        # typo'd dtypes fail HERE, not as a silently-fp32 served pool
        from flexflow_tpu_torch.paged.quant import kv_dtype_info

        kv_dtype_info(self.kv_dtype)
        if max_len is not None and self.page_size > max_len:
            raise ValueError(
                f"page_size {self.page_size} exceeds max_len {max_len}")

    def spec_config(self) -> Optional[SpecConfig]:
        if self.spec_width < 1:
            return None
        return SpecConfig(width=self.spec_width, depth=self.spec_depth)

    def to_server_kwargs(self, slots: int, max_len: int) -> Dict:
        """The serve_generation(...) kwargs this strategy stands for.
        num_pages stays None (the server's dense-capacity default) at
        pool_fraction 1.0; smaller fractions shrink the pool but never
        below one sequence's worth — the pool must admit SOMETHING."""
        self.validate(max_len=max_len)
        pages_per_seq = -(-int(max_len) // self.page_size)
        num_pages = None
        if self.pool_fraction < 1.0:
            num_pages = max(
                int(math.ceil(self.pool_fraction * slots * pages_per_seq)) + 1,
                pages_per_seq + 1)
        return {
            "paged": True,
            "page_size": self.page_size,
            "prefill_chunk": self.prefill_chunk,
            "ragged_pack": self.ragged_pack,
            "megastep_ticks": self.megastep_ticks,
            "megastep_mixed": self.megastep_mixed,
            "overlap_dispatch": self.overlap_dispatch,
            "num_pages": num_pages,
            "speculate": self.spec_config(),
            "kv_dtype": self.kv_dtype,
            "host_tier": self.host_tier_pages or None,
        }

    def describe(self) -> str:
        spec = (f"spec {self.spec_width}x{self.spec_depth}"
                if self.spec_width else "spec off")
        mesh = ",".join(f"{a}={s}" for a, s in self.mesh) or "compiled mesh"
        tier = (f"tier {self.host_tier_pages}p"
                if self.host_tier_pages else "tier off")
        mega = f"megastep {self.megastep_ticks}"
        if self.megastep_mixed:
            mega += " mixed"
        if self.overlap_dispatch:
            mega += "+overlap"
        return (f"page {self.page_size} + chunk {self.prefill_chunk} + "
                f"{mega} + {spec} + "
                f"{'packed' if self.ragged_pack else 'legacy'} + "
                f"pool {self.pool_fraction:g} + kv {self.kv_dtype} + "
                f"{tier} + {mesh}")

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["mesh"] = [[a, s] for a, s in self.mesh]
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "ServeStrategy":
        kw = dict(d)
        kw["mesh"] = tuple((str(a), int(s)) for a, s in kw.get("mesh", ()))
        return cls(**kw)

    def fingerprint(self) -> str:
        """Stable short content hash over the canonical JSON form — the
        strategy's identity across processes. Stamped into every reqlog
        record and the /v2 metrics payload so post-swap records
        attribute to the strategy that actually served them, and equal
        for any two strategies with equal knobs regardless of how they
        were constructed."""
        doc = json.dumps(self.to_json(), sort_keys=True,
                         separators=(",", ":"))
        return hashlib.sha1(doc.encode("utf-8")).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class ServeObjective:
    """Composable SLO objective, minimized: ttft_weight * TTFT p95 +
    throughput_weight * seconds-per-decoded-token, plus the mcmc memory
    penalty (1e3 * hbm/budget) when the strategy's resident bytes exceed
    hbm_budget_bytes — tokens/sec AT a fixed HBM budget, not traded
    against it."""

    ttft_weight: float = 1.0
    throughput_weight: float = 1.0
    hbm_budget_bytes: Optional[float] = None

    def breakdown(self, m: Dict) -> Dict[str, float]:
        terms = {
            "ttft_term": self.ttft_weight * m["ttft_p95_s"],
            "throughput_term":
                self.throughput_weight / max(m["tokens_per_s"], 1e-9),
            "hbm_penalty": 0.0,
        }
        if self.hbm_budget_bytes and m["hbm_bytes"] > self.hbm_budget_bytes:
            terms["hbm_penalty"] = 1e3 * (m["hbm_bytes"]
                                          / self.hbm_budget_bytes)
        return terms

    def value(self, m: Dict) -> float:
        return sum(self.breakdown(m).values())

    def to_json(self) -> Dict:
        return {"ttft_weight": self.ttft_weight,
                "throughput_weight": self.throughput_weight,
                "hbm_budget_bytes": self.hbm_budget_bytes}

    @classmethod
    def from_json(cls, d: Dict) -> "ServeObjective":
        return cls(**d)


# ---------------------------------------------------------------------------
# Calibration hand-off (fftrace calibrate -> MeasuredCostModel)


def load_calibration(report, max_age_s: Optional[float] = None,
                     now: Optional[float] = None) -> Optional[Dict]:
    """Load + freshness-check an `fftrace calibrate` report (path or
    dict). Returns the report, or None — with a logged warning — when it
    predates the schema-v2 created-at stamp or is older than
    `max_age_s` (default CALIBRATION_MAX_AGE_S, overridable via
    FLEXFLOW_CALIBRATION_MAX_AGE): stale scale factors silently applied
    are worse than none."""
    if isinstance(report, (str, os.PathLike)):
        with open(report) as f:
            report = json.load(f)
    if max_age_s is None:
        max_age_s = float(os.environ.get("FLEXFLOW_CALIBRATION_MAX_AGE",
                                         CALIBRATION_MAX_AGE_S))
    created = report.get("created_at_unix")
    if created is None:
        logger.warning(
            "calibration report has no created_at_unix stamp (schema v%s "
            "predates it) — refusing it; re-run `fftrace calibrate` to get "
            "a stamped v2 report", report.get("version", "?"))
        return None
    age = (time.time() if now is None else now) - float(created)
    if age > max_age_s:
        logger.warning(
            "calibration report is %.1f days old (stamp %s, max %.1f "
            "days) — refusing stale scale factors; re-run `fftrace "
            "calibrate` against a fresh serving run",
            age / 86400.0, report.get("created_at", created),
            max_age_s / 86400.0)
        return None
    return report


# ---------------------------------------------------------------------------
# Layout pricing: one priced step per candidate serving mesh, found by
# the EXISTING sharding search (mcmc_optimize + greedy_polish)


@dataclasses.dataclass
class PricedLayout:
    """One candidate serving-mesh layout, priced: the best sharding
    strategy the existing search found for it, the eventsim/graph_cost
    step seconds that sharding prices at, its per-chip weight/activation
    bytes, and the per-token K/V bytes its head sharding leaves on each
    chip."""

    axis_sizes: Dict[str, int]
    strategy: Dict
    step_s: float
    base_tokens: int
    mem_bytes: float
    kv_token_bytes: int
    mode: str
    # dtype-independent counts (cost_model.kv_cache_elem_counts) so the
    # pricer can re-bill the pool per candidate kv_dtype without
    # re-walking the graph: K/V elements per token row, and scale-
    # sidecar entries per PAGE when the dtype is quantized
    kv_token_elems: int = 0
    kv_scale_elems: int = 0

    @property
    def mesh_key(self) -> Tuple[Tuple[str, int], ...]:
        return tuple(sorted(self.axis_sizes.items()))

    def summary(self) -> Dict:
        return {"mesh": dict(self.axis_sizes), "step_s": self.step_s,
                "mem_bytes": self.mem_bytes,
                "kv_token_bytes": self.kv_token_bytes,
                "pricing_mode": self.mode}


def price_layouts(graph, cost, layouts: Sequence[Dict[str, int]], *,
                  inner_budget: int = 0, seed: int = 0
                  ) -> List[PricedLayout]:
    """Price each candidate mesh layout's forward step. With
    inner_budget > 0 each layout's sharding comes from the EXISTING
    mcmc_optimize (anneal + DP polish) under that layout's axis sizes —
    the serving search literally nests the training search; at 0 the
    compiled shardings (or the DP default for a foreign layout) price
    it."""
    from flexflow_tpu_torch.search import space as space_mod
    from flexflow_tpu_torch.search.eventsim import step_seconds
    from flexflow_tpu_torch.search.mcmc import mcmc_optimize
    from flexflow_tpu_torch.obs.calibrate import graph_tokens

    priced = []
    for axis_sizes in layouts:
        cm = dataclasses.replace(cost, axis_sizes=dict(axis_sizes))
        if inner_budget > 0:
            strategy = mcmc_optimize(
                graph, cm, budget=inner_budget, seed=seed, training=False,
                memory_limit=cm.machine.memory_per_chip())
        elif dict(axis_sizes) == dict(cost.axis_sizes):
            strategy = {n.name: n.sharding for n in graph.nodes
                        if n.sharding is not None}
        else:
            strategy = space_mod.default_dp_strategy(graph, cm.axis_sizes)
        step_s, mode = step_seconds(graph, strategy, cm, training=False)
        gc = graph_cost(graph, strategy, cm, training=False)
        elems, scale_elems = kv_cache_elem_counts(graph, strategy,
                                                  cm.axis_sizes)
        priced.append(PricedLayout(
            axis_sizes=dict(axis_sizes), strategy=strategy,
            step_s=step_s, base_tokens=graph_tokens(graph),
            mem_bytes=gc.memory_per_chip,
            kv_token_bytes=kv_cache_token_bytes(graph, strategy,
                                                cm.axis_sizes),
            mode=mode, kv_token_elems=elems, kv_scale_elems=scale_elems))
    return priced


# ---------------------------------------------------------------------------
# The pricer: ServeStrategy x traffic profile -> tick-level metrics


class ServePricer:
    """Closed-form serving model of one strategy under one traffic
    profile. Everything is expectations over the profile's analytic
    moments (traffic.prompt_stats) — no sampling, so one evaluation is
    microseconds and the anneal can afford thousands."""

    def __init__(self, layouts: Sequence[PricedLayout],
                 stats: Dict[str, float], *, slots: int, max_len: int,
                 acceptance_rate: float = DEFAULT_ACCEPTANCE_RATE,
                 host_dispatch_s: float = HOST_DISPATCH_SECONDS,
                 tick_scale: Optional[Callable] = None):
        self.layouts = list(layouts)
        self.by_mesh = {lay.mesh_key: lay for lay in self.layouts}
        self.stats = dict(stats)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.acceptance_rate = float(acceptance_rate)
        self.host_dispatch_s = float(host_dispatch_s)
        self.tick_scale = tick_scale

    def _layout(self, mesh: Tuple[Tuple[str, int], ...]) -> PricedLayout:
        if not mesh:
            return self.layouts[0]
        try:
            return self.by_mesh[tuple(mesh)]
        except KeyError:
            raise ValueError(
                f"strategy mesh {mesh} is not among the priced layouts "
                f"{sorted(self.by_mesh)}") from None

    @staticmethod
    def _bucket(n: float) -> int:
        """The scheduler's legacy pow2 launch bucket (floor 8)."""
        n = max(int(math.ceil(n)), 1)
        return max(8, 1 << (n - 1).bit_length())

    def metrics(self, s: ServeStrategy) -> Dict[str, float]:
        lay = self._layout(s.mesh)
        pricer = TickPricer(base_step_s=lay.step_s,
                            base_tokens=lay.base_tokens,
                            host_dispatch_s=self.host_dispatch_s,
                            tick_scale=self.tick_scale)
        st = self.stats
        slots, max_len = self.slots, self.max_len
        page = min(s.page_size, max_len)
        chunk = min(s.prefill_chunk, max_len)
        mean_p = st["mean_prompt_tokens"]
        p95_p = st["p95_prompt_tokens"]
        share = st["prefix_share_rate"]
        new_t = max(st["new_tokens"], 1.0)
        offered = max(st["offered_concurrency"], 1.0)

        # -- pool occupancy: page size vs tokens in flight --------------
        pages_per_seq = -(-max_len // page)
        if s.pool_fraction >= 1.0:
            pages = slots * pages_per_seq + 1
        else:
            pages = max(int(math.ceil(
                s.pool_fraction * slots * pages_per_seq)) + 1,
                pages_per_seq + 1)
        pool_tokens = pages * page
        # resident tokens one live request uniquely holds: the uncached
        # prompt suffix (the shared prefix's pages are refcounted once),
        # half its decode budget on average, and half a page of internal
        # fragmentation — the page-size tax
        resident = (1.0 - share) * mean_p + new_t / 2.0 + page / 2.0
        live = max(1.0, min(offered, slots, pool_tokens / resident))
        occupancy = min(1.0, live * resident / pool_tokens)

        # -- decode launch shape: packed rows vs padding waste ----------
        if s.ragged_pack:
            launch_rows = self._bucket(live)
        else:
            launch_rows = max(slots, self._bucket(live))
        padded = max(launch_rows - live, 0.0)

        # -- chunked prefill padding (both dispatch models below) -------
        uncached_mean = (1.0 - share) * mean_p
        uncached_p95 = (1.0 - share) * p95_p
        if s.ragged_pack:
            w = min(_prefill_window_rows(), chunk)
            pad_pre = -(-chunk // w) * w - chunk
        else:
            pad_pre = self._bucket(chunk) - chunk

        # -- decode dispatch: megastep fusion or spec verify ------------
        spec = s.spec_config()
        if s.megastep_mixed:
            # universal megastep: chunk rows and on-device drafted spec
            # chains ride the SAME fused dispatch, so mixed
            # ticks amortize the host exactly like pure-decode ones
            if spec is not None:
                # the device drafts a width-1 unigram chain per tick
                accepted = SpecConfig(
                    width=1, depth=spec.depth).expected_tokens_per_step(
                        self.acceptance_rate)
                nodes = spec.depth + 1
            else:
                accepted = 1.0
                nodes = 1
            # a fused run breaks when ANY live slot finishes
            # (~accepted/new_t per tick each), crosses a page boundary
            # (~1/page each), or completes its prefill chunk run (the
            # `chunk`/`verify` break reasons fold into the same rate)
            p_break = live * (1.0 / page + accepted / new_t)
            fused = 1.0
            if s.megastep_ticks > 1:
                fused = min(float(s.megastep_ticks),
                            max(1.0, 1.0 / max(p_break, 1e-9)))
            t_disp = pricer.mixed_dispatch(
                live, tree_nodes=nodes, padded_rows=padded,
                megastep=fused, overlap=s.overlap_dispatch)
            tokens_per_dispatch = fused * accepted
            # a tick with a chunk in flight rides the SAME fused launch
            # — the host is paid once per RUN, not once per chunk tick
            t_mixed = pricer.mixed_dispatch(
                live, chunk_tokens=chunk, tree_nodes=nodes,
                padded_rows=padded + pad_pre, megastep=fused,
                overlap=s.overlap_dispatch) / fused
            t_pre = t_mixed
        elif spec is not None:
            accepted = spec.expected_tokens_per_step(self.acceptance_rate)
            t_disp = pricer.verify_dispatch(live, spec.max_nodes,
                                            padded_rows=padded)
            tokens_per_dispatch = accepted
            fused = 1.0
            t_tick1 = t_disp
        else:
            accepted = 1.0
            # a fused run breaks when ANY live slot finishes (~1/new_t
            # per tick each) or crosses a page boundary (~1/page each)
            p_break = live * (1.0 / page + 1.0 / new_t)
            fused = 1.0
            if s.megastep_ticks > 1:
                fused = min(float(s.megastep_ticks),
                            max(1.0, 1.0 / max(p_break, 1e-9)))
            t_disp = pricer.decode_dispatch(live, padded_rows=padded,
                                            megastep=fused)
            tokens_per_dispatch = fused
            t_tick1 = pricer.decode_dispatch(live, padded_rows=padded,
                                             megastep=1.0)

        # -- chunked prefill: TTFT -------------------------------------
        if not s.megastep_mixed:
            t_pre = pricer.prefill_tick(chunk, padded_rows=pad_pre)
            # a tick with a chunk in flight runs the prefill launch AND
            # the one-tick decode for everyone else (megasteps never
            # fire then)
            t_mixed = t_pre + t_tick1
        chunks_mean = max(math.ceil(uncached_mean / chunk), 1)
        chunks_p95 = max(math.ceil(uncached_p95 / chunk), 1)
        ttft = chunks_p95 * t_mixed + self.host_dispatch_s

        # -- the KV pool's HBM bill, at the strategy's storage dtype ----
        from flexflow_tpu_torch.paged.quant import SCALE_BYTES, kv_dtype_info

        info = kv_dtype_info(s.kv_dtype)
        if info is None:
            kv_token_b = lay.kv_token_bytes
        else:
            kv_token_b = lay.kv_token_elems * info[1]
            if info[2]:  # quantized: scale sidecar amortized per page
                kv_token_b += -(-lay.kv_scale_elems * SCALE_BYTES // page)

        # -- request lifetime + throughput ------------------------------
        t_request = (chunks_mean * t_mixed
                     + (new_t / tokens_per_dispatch) * t_disp)
        if occupancy > 0.9:
            # pool saturation: preemption + prefix recompute stalls
            pressure = 1.0 + 4.0 * (occupancy - 0.9)
            t_request *= pressure
            ttft *= pressure
        if offered > slots:
            # requests beyond the slot count wait for an earlier wave
            ttft += (offered / slots - 1.0) * t_request
        tokens_per_s = live * new_t / t_request

        return {
            "ttft_p95_s": ttft,
            "tokens_per_s": tokens_per_s,
            "hbm_bytes": lay.mem_bytes + pool_tokens * kv_token_b,
            "kv_token_bytes": float(kv_token_b),
            "pool_pages": float(pages),
            "pool_occupancy": occupancy,
            "live_rows": live,
            "padding_waste_ratio": padded / max(launch_rows, 1),
            "prefill_pad_rows": float(pad_pre),
            "expected_accepted_per_step": accepted,
            "expected_fused_ticks": fused,
            "host_roundtrips_per_token": 1.0 / (tokens_per_dispatch * live),
            "decode_dispatch_s": t_disp,
            "prefill_tick_s": t_pre,
            "step_s": lay.step_s,
        }


# ---------------------------------------------------------------------------
# The knob table the existing drivers walk


class _Knob:
    """Stand-in node for StrategyTable rows — the drivers only read
    `.name`."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


def default_space(*, max_len: int) -> Dict[str, List]:
    """The searched knob values. `spec` is a joint (width, depth) knob
    so half-set speculation can never be proposed, and `fuse` a joint
    (megastep_mixed, overlap_dispatch) knob so overlap-without-mixed
    can never be proposed; layout values are appended by the search
    when candidate meshes are given."""
    return {
        "page_size": [p for p in (8, 16, 32, 64, 128) if p <= max_len]
        or [max_len],
        "prefill_chunk": [c for c in (16, 32, 64, 128, 256) if c <= max_len]
        or [max_len],
        "spec": [(0, 0), (2, 2), (2, 4), (4, 4)],
        "megastep_ticks": [1, 2, 4, 8, 16],
        "fuse": [(False, False), (True, False), (True, True)],
        "ragged_pack": [True, False],
        "pool_fraction": [1.0, 0.75, 0.5, 0.25],
        "kv_dtype": ["auto", "int8"],
        "host_tier_pages": [0, 256, 1024],
    }


def _knob_table(knobs: List[Tuple[str, List]]) -> StrategyTable:
    """A StrategyTable whose 'views' are knob values and whose cost
    tables are zero — the whole objective lives in the evaluate closure
    the drivers are handed, exactly how mcmc_optimize's fallback hands
    its summed-table evaluate to the same loop."""
    n = len(knobs)
    zeros = lambda: [[0.0] * len(vals) for _, vals in knobs]  # noqa: E731
    return StrategyTable(
        nodes=[_Knob(name) for name, _ in knobs],
        views=[list(vals) for _, vals in knobs],
        compute=zeros(), comm=zeros(), sync=zeros(), memory=zeros(),
        edges=[])


# ---------------------------------------------------------------------------
# Search result + driver


@dataclasses.dataclass
class ServeSearchResult:
    traffic: str
    slots: int
    max_len: int
    budget: int
    seed: int
    best: ServeStrategy
    best_objective: float
    best_metrics: Dict
    default: ServeStrategy
    default_objective: float
    default_metrics: Dict
    objective: ServeObjective
    trials: int
    calibration: Optional[Dict] = None
    layouts: List[Dict] = dataclasses.field(default_factory=list)
    # the pricer's traffic inputs, for provenance: the prompt moments
    # it priced with, the recorded arrival process (RecordedProfile
    # only), and where acceptance_rate came from (measured / default /
    # explicit) — a --replay search is auditable against its log
    stats: Optional[Dict] = None
    arrival: Optional[Dict] = None
    acceptance: Optional[Dict] = None
    # which evaluation backend scored the candidates: "closed-form"
    # (ServePricer algebra) or "ticksim" (event-driven replay of the
    # recorded arrival sequence — the --sim path)
    backend: str = "closed-form"

    @property
    def improvement(self) -> float:
        """Fractional objective win over the hand default (0.25 = 25%
        better)."""
        if self.default_objective <= 0:
            return 0.0
        return (self.default_objective - self.best_objective) \
            / self.default_objective

    def to_json(self) -> Dict:
        return {
            "traffic": self.traffic,
            "slots": self.slots,
            "max_len": self.max_len,
            "budget": self.budget,
            "seed": self.seed,
            "best": self.best.to_json(),
            "best_objective": self.best_objective,
            "best_metrics": self.best_metrics,
            "default": self.default.to_json(),
            "default_objective": self.default_objective,
            "default_metrics": self.default_metrics,
            "objective": self.objective.to_json(),
            "improvement": self.improvement,
            "trials": self.trials,
            "calibration": self.calibration,
            "layouts": self.layouts,
            "stats": self.stats,
            "arrival": self.arrival,
            "acceptance": self.acceptance,
            "backend": self.backend,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "ServeSearchResult":
        return cls(
            traffic=d["traffic"], slots=d["slots"], max_len=d["max_len"],
            budget=d["budget"], seed=d["seed"],
            best=ServeStrategy.from_json(d["best"]),
            best_objective=d["best_objective"],
            best_metrics=d["best_metrics"],
            default=ServeStrategy.from_json(d["default"]),
            default_objective=d["default_objective"],
            default_metrics=d["default_metrics"],
            objective=ServeObjective.from_json(d["objective"]),
            trials=d["trials"], calibration=d.get("calibration"),
            layouts=d.get("layouts", []), stats=d.get("stats"),
            arrival=d.get("arrival"), acceptance=d.get("acceptance"),
            backend=d.get("backend", "closed-form"))


def _tick_calibration(cost, report: Dict) -> Callable:
    """The tick-scale function of a fresh calibration report. A caller's
    MeasuredCostModel takes the scales itself, as in the reference; with
    an analytic CostModel the layouts stay priced by it and the scales
    are looked up in the report's table (the reference moves to an empty
    MeasuredCostModel here, whose pricing in the port would time op
    shards)."""
    from flexflow_tpu_torch.search.measured import (
        MeasuredCostModel,
        calibration_scales,
        lookup_tick_scale,
    )

    if isinstance(cost, MeasuredCostModel):
        cost.set_tick_calibration(report)
        return cost.tick_scale
    return functools.partial(lookup_tick_scale, calibration_scales(report))


def build_pricer(ff=None, *, graph=None, cost=None, traffic="smoke",
                 slots: int = 4, max_len: int = 512,
                 acceptance_rate: Optional[float] = None,
                 calibration=None,
                 host_dispatch_s: float = HOST_DISPATCH_SECONDS,
                 seed: int = 0) -> ServePricer:
    """A ServePricer for one traffic profile WITHOUT running a search —
    the entry `servesearch simulate` and the sim-accuracy tests share.
    Same resolution rules as search_serve_strategy: a RecordedProfile's
    measured acceptance wins over the prior, and a fresh calibration
    report threads its measured tick scales into every price."""
    if ff is not None:
        from flexflow_tpu_torch.search.api import _cost_model

        graph = ff.graph
        cost = _cost_model(ff.mesh.axes, ff.config)
    if graph is None or cost is None:
        raise ValueError("build_pricer needs ff= or graph=+cost=")

    from flexflow_tpu_torch.search import traffic as traffic_mod

    profile = traffic_mod.get_profile(traffic)
    stats = profile.prompt_stats()
    if acceptance_rate is None:
        measured = (profile.measured_acceptance()
                    if hasattr(profile, "measured_acceptance") else None)
        acceptance_rate = (float(measured) if measured is not None
                           else DEFAULT_ACCEPTANCE_RATE)
    tick_scale_fn = None
    if calibration is not None:
        report = load_calibration(calibration)
        if report is not None:
            tick_scale_fn = _tick_calibration(cost, report)
    priced = price_layouts(graph, cost, [dict(cost.axis_sizes)], seed=seed)
    return ServePricer(priced, stats, slots=slots, max_len=max_len,
                       acceptance_rate=acceptance_rate,
                       host_dispatch_s=host_dispatch_s,
                       tick_scale=tick_scale_fn)


def search_serve_strategy(
    ff=None, *, graph=None, cost=None, traffic="smoke",
    objective: Optional[ServeObjective] = None, budget: int = 200,
    alpha: float = 0.05, seed: int = 0, slots: int = 4,
    max_len: int = 512, default: Optional[ServeStrategy] = None,
    space: Optional[Dict[str, List]] = None,
    layouts: Optional[Sequence[Dict[str, int]]] = None,
    inner_budget: int = 0, calibration=None,
    acceptance_rate: Optional[float] = None,
    host_dispatch_s: float = HOST_DISPATCH_SECONDS, verbose: bool = False,
    sim: bool = False,
) -> ServeSearchResult:
    """Search the ServeStrategy space for `traffic`, minimizing
    `objective` (default: TTFT p95 + seconds/token at the machine's HBM
    budget). Pass a compiled `ff`, or a (graph, cost) pair directly.

    `layouts` adds candidate serving-mesh axis layouts; with
    `inner_budget` > 0 each is shard-searched by the existing
    mcmc_optimize before pricing. `calibration` takes an `fftrace
    calibrate` report (path or dict); fresh reports are threaded through
    MeasuredCostModel.set_tick_calibration into every tick price, stale
    ones refused with a warning (load_calibration). Fixed `seed` makes
    the whole search deterministic.

    `acceptance_rate=None` (default) resolves automatically: a
    RecordedProfile's MEASURED spec acceptance when `traffic` carries
    one (the --replay path), else the 0.6 prior. An explicit value
    always wins. The result's `acceptance` dict records which.

    `sim=True` evaluates each candidate with the event-driven
    `ticksim.TickSimulator` — replaying the profile's recorded arrival
    sequence through the simulated tick loop — instead of the
    closed-form ServePricer, IF the profile carries an arrival trace
    (a RecordedProfile / --replay log); otherwise it falls back to the
    closed form with a warning. The result's `backend` field records
    which backend scored the winner."""
    if ff is not None:
        from flexflow_tpu_torch.search.api import _cost_model

        graph = ff.graph
        cost = _cost_model(ff.mesh.axes, ff.config)
    if graph is None or cost is None:
        raise ValueError("search_serve_strategy needs ff= or graph=+cost=")

    from flexflow_tpu_torch.search import traffic as traffic_mod

    profile = traffic_mod.get_profile(traffic)
    stats = profile.prompt_stats()
    arrival = (profile.arrival_stats()
               if hasattr(profile, "arrival_stats") else None)

    # acceptance_rate=None -> measured from the profile when the log
    # recorded drafting (RecordedProfile.measured_acceptance), else the
    # prior; an explicit value always wins
    if acceptance_rate is None:
        measured = (profile.measured_acceptance()
                    if hasattr(profile, "measured_acceptance") else None)
        if measured is not None:
            acceptance_rate, acceptance_src = float(measured), "measured"
        else:
            acceptance_rate, acceptance_src = (
                DEFAULT_ACCEPTANCE_RATE, "default")
    else:
        acceptance_rate, acceptance_src = float(acceptance_rate), "explicit"

    # -- calibration hand-off -------------------------------------------
    tick_scale_fn = None
    cal_summary = None
    if calibration is not None:
        report = load_calibration(calibration)
        if report is None:
            cal_summary = {"used": False, "reason": "stale-or-unstamped"}
        else:
            tick_scale_fn = _tick_calibration(cost, report)
            cal_summary = {
                "used": True,
                "version": report.get("version"),
                "created_at": report.get("created_at"),
                "shapes": len(report.get("tick_scales", {})),
                "card": report.get("meta", {}).get("card"),
            }

    # -- price the candidate mesh layouts -------------------------------
    layout_dicts = ([dict(cost.axis_sizes)] if layouts is None
                    else [dict(axes) for axes in layouts])
    priced = price_layouts(graph, cost, layout_dicts,
                           inner_budget=inner_budget, seed=seed)

    if objective is None:
        objective = ServeObjective(
            hbm_budget_bytes=cost.machine.memory_per_chip())

    pricer = ServePricer(priced, stats, slots=slots, max_len=max_len,
                         acceptance_rate=acceptance_rate,
                         host_dispatch_s=host_dispatch_s,
                         tick_scale=tick_scale_fn)

    # -- evaluation backend: closed-form algebra or event replay --------
    backend = "closed-form"
    simulator = None
    if sim:
        from flexflow_tpu_torch.search.ticksim import (
            TickSimulator,
            has_arrival_trace,
        )

        if has_arrival_trace(profile):
            simulator = TickSimulator(pricer)
            backend = "ticksim"
        else:
            logger.warning(
                "servesearch sim=True: profile %r carries no arrival "
                "trace (not a recorded reqlog) — falling back to the "
                "closed-form pricer", profile.name)

    # -- knob table + start point ---------------------------------------
    if default is None:
        default = ServeStrategy()
    default = dataclasses.replace(
        default, page_size=min(default.page_size, max_len),
        prefill_chunk=min(default.prefill_chunk, max_len))
    values = default_space(max_len=max_len) if space is None else \
        {k: list(v) for k, v in space.items()}
    defaults = {
        "page_size": default.page_size,
        "prefill_chunk": default.prefill_chunk,
        "spec": (default.spec_width, default.spec_depth),
        "megastep_ticks": default.megastep_ticks,
        "fuse": (default.megastep_mixed, default.overlap_dispatch),
        "ragged_pack": default.ragged_pack,
        "pool_fraction": default.pool_fraction,
        "kv_dtype": default.kv_dtype,
        "host_tier_pages": default.host_tier_pages,
    }
    for name, dval in defaults.items():
        vals = values.setdefault(name, [dval])
        if dval not in vals:
            vals.insert(0, dval)
    knobs = [(name, values[name]) for name in
             ("page_size", "prefill_chunk", "spec", "megastep_ticks",
              "fuse", "ragged_pack", "pool_fraction", "kv_dtype",
              "host_tier_pages")]
    if len(priced) > 1:
        knobs.append(("mesh", [lay.mesh_key for lay in priced]))
    table = _knob_table(knobs)

    names = [name for name, _ in knobs]

    def to_strategy(assign) -> ServeStrategy:
        kv = {name: table.views[i][k]
              for i, (name, k) in enumerate(zip(names, assign))}
        w, d = kv.pop("spec")
        mixed, overlap = kv.pop("fuse")
        return ServeStrategy(spec_width=w, spec_depth=d,
                             megastep_mixed=mixed,
                             overlap_dispatch=overlap,
                             mesh=kv.pop("mesh", default.mesh), **kv)

    cache: Dict[Tuple[int, ...], Tuple[float, Optional[Dict]]] = {}

    def evaluate(assign) -> float:
        key = tuple(assign)
        hit = cache.get(key)
        if hit is None:
            strat = to_strategy(assign)
            try:
                strat.validate(max_len=max_len)
            except ValueError:
                hit = (INVALID_OBJECTIVE, None)
            else:
                if simulator is not None:
                    m = simulator.simulate(strat, profile, seed=seed).metrics
                else:
                    m = pricer.metrics(strat)
                hit = (objective.value(m), m)
            cache[key] = hit
        return hit[0]

    start = [vals.index(defaults[name]) if name in defaults else 0
             for name, vals in knobs]
    default_cost = evaluate(start)
    default_metrics = cache[tuple(start)][1]
    default_strategy = to_strategy(start)

    # -- the existing drivers: anneal, then coordinate descent ----------
    from flexflow_tpu_torch.search.mcmc import anneal_assignment

    best_assign, _ = anneal_assignment(table, start, evaluate,
                                       budget=budget, alpha=alpha,
                                       seed=seed, verbose=verbose)
    best_assign = list(best_assign)
    best_cost = coordinate_descent(table, best_assign, evaluate, sweeps=2)
    best_metrics = cache[tuple(best_assign)][1]
    best_strategy = to_strategy(best_assign)
    if verbose:
        logger.info("servesearch[%s]: %s -> %.6f (default %.6f, %d trials)",
                    profile.name, best_strategy.describe(), best_cost,
                    default_cost, len(cache))

    return ServeSearchResult(
        traffic=profile.name, slots=slots, max_len=max_len, budget=budget,
        seed=seed, best=best_strategy, best_objective=best_cost,
        best_metrics=best_metrics, default=default_strategy,
        default_objective=default_cost, default_metrics=default_metrics,
        objective=objective, trials=len(cache), calibration=cal_summary,
        layouts=[lay.summary() for lay in priced], stats=stats,
        arrival=arrival,
        acceptance={"rate": acceptance_rate, "source": acceptance_src},
        backend=backend)
