"""ticksim — discrete-event simulator of the serving tick loop
(counterpart of flexflow_tpu/search/ticksim.py: host code over the
pricer, the same walk and the same seeded draws, so a fixed seed gives
the reference's timeline).

`ServePricer` is steady-state algebra: expectations over the traffic
profile's analytic moments. That is the right cost for a thousand-trial
anneal, but it prices a BURST the same as a trickle — the measured
arrival process a `RecordedProfile` carries (submit-time sequence,
interarrival gaps, queue depth) never reaches the TTFT estimate. This
module replays that arrival sequence through a simulated copy of the
paged scheduler's tick loop, pricing each dispatch with the SAME
`TickPricer` the closed form uses:

  * admission by page budget — a request enters a slot only when the
    simulated pool can hold `pages_for(len(prompt) + 1)` private pages,
    FIFO with a requeue-front for preempted requests, exactly the
    scheduler's `_admit_pending` discipline;
  * chunked prefill with the adaptive packed window — one shared
    `prefill_chunk` token budget per tick, rotating start, takes split
    into `W = min(PREFILL_WINDOW_ROWS, max take)` pieces packed into one
    launch (or legacy per-slot pow2 buckets), priced with
    `TickPricer.prefill_tick`;
  * decode / megastep fusion — one row per slot (idle rows padded), a
    fused run breaking at the first finish, page boundary, or the
    `megastep_ticks` limit, priced with `TickPricer.decode_dispatch`;
    with `megastep_mixed` the in-flight prefill chunks ride the same
    fused dispatch (`TickPricer.mixed_dispatch`) and `overlap_dispatch`
    discounts the host-side admission work that hides behind it;
  * speculative verify — per-tick accepted-token draws from the
    acceptance rate (a seeded chain through the draft depth), priced
    with `TickPricer.verify_dispatch`;
  * preemption under page pressure — a decode that cannot grow evicts
    the youngest other live request (progress parked page-aligned, the
    re-admission re-attaches it), mirroring `_ensure_pages`;
  * the content-addressed prefix cache — published prefixes stay
    resident, later requests attach instead of recomputing, unattached
    resident pages are reclaimed under pressure like the pool's LRU;
  * the host-RAM KV tier (`ServeStrategy.host_tier_pages` > 0) —
    reclaimed prefixes SPILL to a bounded host store instead of
    dropping, and a later request whose prefix lives there fetches it
    back at admission, priced with `TickPricer.fetch_seconds` (the
    PCIe-ish bytes/s knob) instead of recomputing the prefill. This is
    the spill-vs-preempt question the simulator answers: a fetch costs
    page bytes over host bandwidth, a recompute costs whole prefill
    ticks — which wins depends on the recorded traffic's reuse.

The output is a per-request timeline (submit / admit / first-token /
done) whose TTFT and queue percentiles reflect the recorded bursts and
queue depth instead of Little's-law averages. `SimResult.metrics`
starts from the closed-form `ServePricer.metrics` dict (HBM bill, pool
occupancy, launch shapes) and overrides the event-driven keys, so the
same `ServeObjective` scores both backends and `servesearch --sim` is a
drop-in evaluation swap. Simulated time is purely the priced dispatch
seconds — no wall clock, no `time.time()` — so a fixed seed makes every
simulation bit-reproducible.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# Backstop against a stuck simulation (a bug, never a workload): each
# tick must either advance a request or advance simulated time to the
# next arrival, so real runs stay far below this.
MAX_SIM_TICKS = 2_000_000


def has_arrival_trace(profile) -> bool:
    """True when the profile carries a real arrival sequence to replay
    (a RecordedProfile or anything with per-request records) — the
    `--sim` gate: without one the closed-form pricer is the honest
    backend."""
    return bool(getattr(profile, "records", None))


def _percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile, matching obs.slo.percentile — local so
    search/ stays importable without the serving stack."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = min(max(1, math.ceil(q * len(ordered))), len(ordered))
    return float(ordered[rank - 1])


def _prefill_window_rows() -> int:
    from flexflow_tpu_torch.paged.scheduler import PREFILL_WINDOW_ROWS

    return PREFILL_WINDOW_ROWS


def _bucket(n: int) -> int:
    """The scheduler's legacy pow2 launch bucket (floor 8)."""
    n = max(int(n), 1)
    return max(8, 1 << (n - 1).bit_length())


# ---------------------------------------------------------------------------
# Arrivals: one simulated request per recorded (or sampled) request


@dataclasses.dataclass
class SimRequest:
    """One simulated request: the recorded arrival time and lengths,
    plus the mutable tick-loop state the simulator walks."""

    rid: str
    submit_s: float
    prompt_tokens: int
    new_tokens: int
    # prefix identity: requests sharing a group can re-attach each
    # other's published pages; `cached_hint` caps how much of THIS
    # prompt the recorded run saw served from cache
    prefix_group: Optional[str] = None
    cached_hint: int = 0

    # -- runtime state (reset on preemption) ----------------------------
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    prefill_pos: int = 0
    prefill_target: int = 0
    cached_tokens: int = 0
    pos: int = 0  # decoded tokens emitted
    private_pages: int = 0
    attached_pages: int = 0
    preemptions: int = 0
    # page-aligned progress parked on eviction; re-admission resumes here
    parked_tokens: int = 0

    @property
    def seq_len(self) -> int:
        return self.prompt_tokens + self.pos

    def record(self) -> Dict:
        ttft = (self.first_token_s - self.submit_s
                if self.first_token_s is not None else None)
        return {
            "rid": self.rid,
            "submit_s": self.submit_s,
            "admit_s": self.admit_s,
            "first_token_s": self.first_token_s,
            "done_s": self.done_s,
            "ttft_s": ttft,
            "queue_s": (self.admit_s - self.submit_s
                        if self.admit_s is not None else None),
            "prompt_tokens": self.prompt_tokens,
            "decode_tokens": self.pos,
            "cached_prefill_tokens": self.cached_tokens,
            "preemptions": self.preemptions,
        }


def arrivals_from_profile(profile, *, seed: int = 0,
                          max_len: Optional[int] = None
                          ) -> List[SimRequest]:
    """Build the simulated arrival sequence. A RecordedProfile replays
    its records' real submit times, prompt lengths, per-request decode
    budgets, and prefix-chain groups; a synthetic TrafficProfile samples
    its declared lengths (deterministic in `seed`) and submits them all
    at t=0 — the burst the bench and smoke tests actually issue.
    Lengths are clamped to `max_len` so a simulated request always fits
    the pool it is simulated against."""
    reqs: List[SimRequest] = []
    records = getattr(profile, "records", None)
    if records:
        t0 = min(int(r["submit_ns"]) for r in records)
        for i, r in enumerate(records):
            chain = list(r.get("prefix_chain") or [])
            prompt = max(1, int(r["prompt_tokens"]))
            budget = max(1, int(r.get("decode_tokens", 0))
                         or int(r.get("max_new_tokens", 0)))
            reqs.append(SimRequest(
                rid=str(r.get("rid", i)),
                submit_s=(int(r["submit_ns"]) - t0) / 1e9,
                prompt_tokens=prompt, new_tokens=budget,
                prefix_group=chain[0] if chain else None,
                cached_hint=int(r.get("cached_prefill_tokens", 0))))
    else:
        rs = np.random.RandomState(seed)
        sample = profile.sample(rs, vocab=32)
        shared = (len(sample.shared_prefix)
                  if sample.shared_prefix is not None else 0)
        for i, p in enumerate(sample.prompts):
            reqs.append(SimRequest(
                rid=str(i), submit_s=0.0, prompt_tokens=len(p),
                new_tokens=max(1, int(profile.new_tokens)),
                prefix_group="shared" if shared else None,
                cached_hint=shared if shared else 0))
    if max_len:
        for r in reqs:
            r.prompt_tokens = min(r.prompt_tokens, int(max_len) - 1)
            r.new_tokens = max(1, min(r.new_tokens,
                                      int(max_len) - r.prompt_tokens))
            r.cached_hint = min(r.cached_hint, r.prompt_tokens - 1)
    return reqs


# ---------------------------------------------------------------------------
# Result


@dataclasses.dataclass
class SimResult:
    """One simulated serving run: per-request timelines plus the merged
    metrics dict (closed-form statics + event-driven overrides) the
    ServeObjective scores."""

    records: List[Dict]
    metrics: Dict[str, float]
    ticks: int
    makespan_s: float
    preemptions: int
    seed: int

    def timeline_json(self) -> Dict:
        return {
            "version": 1,
            "backend": "ticksim",
            "seed": self.seed,
            "ticks": self.ticks,
            "makespan_s": self.makespan_s,
            "preemptions": self.preemptions,
            "metrics": self.metrics,
            "requests": self.records,
        }


# ---------------------------------------------------------------------------
# The simulator


class TickSimulator:
    """Event-driven evaluation backend over a ServePricer's priced
    layouts: same TickPricer per dispatch, same HBM bill, but TTFT and
    queue percentiles come from replaying the profile's arrival
    sequence through the scheduler's tick structure."""

    def __init__(self, pricer):
        self.pricer = pricer  # search.servesearch.ServePricer

    # -- public entry ---------------------------------------------------

    def simulate(self, strategy, profile, *, seed: int = 0) -> SimResult:
        from flexflow_tpu_torch.search.cost_model import TickPricer

        p = self.pricer
        strategy.validate(max_len=p.max_len)
        lay = p._layout(strategy.mesh)
        tick = TickPricer(base_step_s=lay.step_s,
                          base_tokens=lay.base_tokens,
                          host_dispatch_s=p.host_dispatch_s,
                          tick_scale=p.tick_scale)
        arrivals = arrivals_from_profile(profile, seed=seed,
                                         max_len=p.max_len)
        closed = p.metrics(strategy)
        # one page's HBM footprint — what a host-tier fetch moves back
        # over the PCIe-ish link when a spilled prefix gets re-attached
        page_bytes = closed["kv_token_bytes"] * min(strategy.page_size,
                                                    p.max_len)
        run = _SimRun(strategy, tick, slots=p.slots, max_len=p.max_len,
                      acceptance_rate=p.acceptance_rate, seed=seed,
                      page_bytes=page_bytes)
        run.play(arrivals)
        ttfts = [r["ttft_s"] for r in (q.record() for q in arrivals)
                 if r["ttft_s"] is not None]
        queues = [max(0.0, q.admit_s - q.submit_s) for q in arrivals
                  if q.admit_s is not None]
        decoded = sum(q.pos for q in arrivals)
        makespan = max((q.done_s for q in arrivals
                        if q.done_s is not None), default=0.0)
        metrics = dict(closed)
        metrics.update({
            "backend": "ticksim",
            "ttft_p50_s": _percentile(ttfts, 0.5),
            "ttft_p95_s": _percentile(ttfts, 0.95),
            "queue_p50_s": _percentile(queues, 0.5),
            "queue_p95_s": _percentile(queues, 0.95),
            "tokens_per_s": (decoded / makespan if makespan > 0
                             else closed["tokens_per_s"]),
            "makespan_s": makespan,
            "sim_ticks": float(run.ticks),
            "sim_preemptions": float(run.preemptions),
            "sim_spilled_pages": float(run.spills),
            "sim_fetched_pages": float(run.fetches),
            "sim_host_fetch_s": run.fetch_cost_total_s,
        })
        return SimResult(records=[q.record() for q in arrivals],
                         metrics=metrics, ticks=run.ticks,
                         makespan_s=makespan,
                         preemptions=run.preemptions, seed=seed)


class _SimRun:
    """The mutable tick loop of one simulation — a host-side twin of
    PagedGenerationServer._loop_body over priced seconds."""

    def __init__(self, strategy, tick, *, slots: int, max_len: int,
                 acceptance_rate: float, seed: int,
                 page_bytes: float = 0.0):
        kw = strategy.to_server_kwargs(slots=slots, max_len=max_len)
        self.page = int(kw["page_size"])
        self.chunk = int(kw["prefill_chunk"])
        self.ragged_pack = bool(kw["ragged_pack"])
        self.megastep = int(kw["megastep_ticks"])
        self.mixed = bool(kw.get("megastep_mixed"))
        self.overlap = bool(kw.get("overlap_dispatch"))
        self.spec = kw["speculate"]
        self.slots = int(slots)
        self.max_len = int(max_len)
        pages_per_seq = -(-self.max_len // self.page)
        num_pages = kw["num_pages"] or slots * pages_per_seq + 1
        self.capacity = int(num_pages) - 1
        self.tick = tick
        self.acceptance = float(acceptance_rate)
        self.rs = np.random.RandomState(seed)
        self.window = min(_prefill_window_rows(), self.chunk)

        self.t = 0.0
        self.ticks = 0
        self.preemptions = 0
        self.active: List[Optional[SimRequest]] = [None] * self.slots
        self.admit_order: List[int] = []  # slots, oldest first
        self.requeue: List[SimRequest] = []
        self.queue: List[SimRequest] = []
        self.prefill_rr = 0
        # resident published prefixes: group -> (pages, attach_count)
        self.resident: Dict[str, List[int]] = {}
        # host-RAM KV tier: group -> pages, insertion order = LRU (the
        # HostTier's OrderedDict). 0 capacity = no tier, reclaims drop.
        self.tier_capacity = int(kw.get("host_tier") or 0)
        self.page_bytes = float(page_bytes)
        self.spilled: Dict[str, int] = {}
        self.spills = 0
        self.fetches = 0
        self.fetch_cost_total_s = 0.0
        self._pending_fetch_s = 0.0  # charged to the admitting tick

    def _pages_for(self, tokens: int) -> int:
        return -(-max(1, tokens) // self.page)

    # -- pool accounting ------------------------------------------------

    def _held(self) -> int:
        private = sum(r.private_pages for r in self.active if r)
        private += sum(r.private_pages for r in self.requeue)
        cached = sum(pages for pages, _ in self.resident.values())
        return private + cached

    def _free(self) -> int:
        return self.capacity - self._held()

    def _reclaim(self, needed: int) -> int:
        """Evict unattached resident prefixes (the pool's LRU dead list)
        until `needed` pages are free; returns the free count. With a
        host tier the eviction SPILLS (the prefix stays fetchable);
        without one it drops (the next reuse recomputes)."""
        if self._free() >= needed:
            return self._free()
        for group in list(self.resident):
            pages, attach = self.resident[group]
            if attach <= 0:
                del self.resident[group]
                self._spill(group, pages)
                if self._free() >= needed:
                    break
        return self._free()

    def _spill(self, group: str, pages: int) -> None:
        """Move an evicted prefix into the host tier (latest-wins
        re-append, capacity evicts oldest-first — HostTier.spill)."""
        if self.tier_capacity <= 0 or pages <= 0:
            return
        self.spilled.pop(group, None)
        self.spilled[group] = pages
        self.spills += pages
        while sum(self.spilled.values()) > self.tier_capacity:
            self.spilled.pop(next(iter(self.spilled)))

    def _publish(self, req: SimRequest) -> None:
        """Park a request's page-aligned progress in the prefix store —
        the simulated `_publish_tail`: full pages become re-attachable
        by this request (and its group) later."""
        aligned = (req.seq_len // self.page) * self.page
        req.parked_tokens = aligned
        group = req.prefix_group or f"own:{req.rid}"
        pages = self._pages_for(aligned) if aligned else 0
        have = self.resident.get(group)
        if pages and (have is None or have[0] < pages):
            self.resident[group] = [pages, have[1] if have else 0]
            # a republished prefix supersedes its spilled copy — the
            # pool's register_full drops the tier duplicate the same way
            self.spilled.pop(group, None)

    def _detach(self, req: SimRequest) -> None:
        if req.attached_pages:
            group = req.prefix_group or f"own:{req.rid}"
            have = self.resident.get(group)
            if have:
                have[1] = max(0, have[1] - 1)
            req.attached_pages = 0

    # -- admission ------------------------------------------------------

    def _cached_for(self, req: SimRequest, assume_pages: int = 0) -> int:
        """Tokens of this prompt re-attachable from the resident store:
        the published group prefix, capped by the recorded cache hint
        (first arrival of a group recorded a miss) and page-aligned.
        `assume_pages` prices a prefix still in the host tier as if
        already fetched — the admission decides fetch-vs-recompute
        BEFORE paying for either."""
        group = req.prefix_group or f"own:{req.rid}"
        have = self.resident.get(group)
        resident_tokens = (have[0] if have else assume_pages) * self.page
        cap = max(req.cached_hint, req.parked_tokens)
        cached = min(resident_tokens, cap, req.prompt_tokens - 1)
        return (cached // self.page) * self.page

    def _try_admit(self, req: SimRequest) -> bool:
        try:
            slot = self.active.index(None)
        except ValueError:
            return False
        group = req.prefix_group or f"own:{req.rid}"
        tiered = 0
        if group not in self.resident:
            tiered = self.spilled.get(group, 0)
        cached = self._cached_for(req, assume_pages=tiered)
        # fetch only the prefix pages this request can attach — the
        # real pool's lookup walk fetches per matched page, never a
        # whole spilled chain it has no use for
        fetch_pages = min(tiered, cached // self.page)
        need = self._pages_for(req.prompt_tokens + 1) - cached // self.page
        if self._reclaim(need + fetch_pages) < need + fetch_pages:
            return False
        if fetch_pages:
            # pull the spilled prefix back on-device: it becomes a
            # resident group this admission attaches, and the tick that
            # admitted it pays the PCIe transfer (fetches gate prefill)
            if fetch_pages >= self.spilled[group]:
                self.spilled.pop(group)
            else:
                self.spilled[group] -= fetch_pages
            self.resident[group] = [fetch_pages, 0]
            self.fetches += fetch_pages
            cost = self.tick.fetch_seconds(self.page_bytes, fetch_pages)
            self.fetch_cost_total_s += cost
            self._pending_fetch_s += cost
        req.cached_tokens = cached
        req.private_pages = need
        if cached:
            group = req.prefix_group or f"own:{req.rid}"
            self.resident[group][1] += 1
            req.attached_pages = cached // self.page
        req.prefill_pos = cached
        req.prefill_target = req.prompt_tokens
        req.pos = 0
        if req.admit_s is None:
            req.admit_s = self.t
        self.active[slot] = req
        self.admit_order.append(slot)
        return True

    def _admit_pending(self) -> None:
        while self.requeue:
            if not self._try_admit(self.requeue[0]):
                return
            self.requeue.pop(0)
        while self.queue:
            if not self._try_admit(self.queue[0]):
                return
            self.queue.pop(0)

    # -- eviction / growth ----------------------------------------------

    def _evict(self, slot: int) -> None:
        req = self.active[slot]
        self._publish(req)
        self._detach(req)
        req.private_pages = 0
        req.preemptions += 1
        self.preemptions += 1
        self.active[slot] = None
        self.admit_order.remove(slot)
        self.requeue.insert(0, req)

    def _grow(self, slot: int) -> bool:
        """Grant the slot pages for its next token; preempt the
        youngest OTHER live request under pressure (the `_ensure_pages`
        policy). False = stalled this tick."""
        req = self.active[slot]
        target = min(self._pages_for(req.seq_len + 1),
                     self._pages_for(self.max_len))
        need = target - req.private_pages - req.attached_pages
        while need > 0 and self._reclaim(need) < need:
            victims = [s for s in self.admit_order if s != slot]
            if not victims:
                return False
            self._evict(victims[-1])
        if need > 0:
            req.private_pages += need
        return True

    # -- tick phases ----------------------------------------------------

    def _prefill_tick(self, slots: List[int]) -> float:
        budget = self.chunk
        rot = self.prefill_rr % len(slots)
        self.prefill_rr += 1
        plan = []
        for s in slots[rot:] + slots[:rot]:
            if budget <= 0:
                break
            req = self.active[s]
            take = min(budget, req.prefill_target - req.prefill_pos)
            if take > 0:
                plan.append((s, take))
                budget -= take
        if not plan:
            return 0.0
        cost = 0.0
        if self.ragged_pack:
            w = min(self.window, max(take for _, take in plan))
            pieces = sum(-(-take // w) for _, take in plan)
            total = sum(take for _, take in plan)
            cost += self.tick.prefill_tick(total,
                                           padded_rows=pieces * w - total,
                                           batch=pieces)
        else:
            for _, take in plan:
                padded = _bucket(take) - take
                cost += self.tick.prefill_tick(take, padded_rows=padded)
        for s, take in plan:
            req = self.active[s]
            req.prefill_pos += take
            if req.prefill_pos >= req.prefill_target:
                if req.first_token_s is None:
                    req.first_token_s = self.t + cost
                req.pos = 1  # the completion tick samples token one
        return cost

    def _decode_tick(self, dec: List[int], mixed: bool) -> float:
        live = [s for s in dec if self.active[s].pos
                < self.active[s].new_tokens]
        if not live:
            return 0.0
        # a grow under pool pressure can evict the youngest OTHER live
        # slot — one still ahead in this scan, or one already granted.
        # Either way the evicted slot decodes nothing this tick.
        granted = [s for s in live
                   if self.active[s] is not None and self._grow(s)]
        granted = [s for s in granted if self.active[s] is not None]
        if not granted:
            return 0.0
        padded = self.slots - len(granted)
        if self.spec is not None:
            cost = self.tick.verify_dispatch(len(granted),
                                             self.spec.max_nodes,
                                             padded_rows=padded)
            for s in granted:
                req = self.active[s]
                accepted = 1
                d = 0
                while (d < self.spec.depth
                       and self.rs.random_sample() < self.acceptance):
                    accepted += 1
                    d += 1
                req.pos = min(req.new_tokens, req.pos + accepted)
            return cost
        fused = 1
        if self.megastep > 1 and not mixed:
            fused = self.megastep
            for s in granted:
                req = self.active[s]
                fused = min(fused, req.new_tokens - req.pos)
                held = req.private_pages + req.attached_pages
                fused = min(fused, max(1, held * self.page - req.seq_len))
        cost = self.tick.decode_dispatch(len(granted), padded_rows=padded,
                                         megastep=float(fused))
        for s in granted:
            req = self.active[s]
            req.pos = min(req.new_tokens, req.pos + fused)
        return cost

    def _mixed_tick(self, pre: List[int], dec: List[int]) -> float:
        """One universal-fused dispatch (megastep_mixed): decode rows —
        each `depth+1` wide when an on-device spec chain rides it — and
        the in-flight prefill chunks advance together inside one
        while_loop run, tick by tick until a slot finishes, crosses a
        page boundary, or completes its prefill (the `chunk` break:
        page publication is host work). The whole run is priced as ONE
        TickPricer.mixed_dispatch — the host paid once, discounted
        further when overlap_dispatch hides the admission work in the
        device's shadow."""
        live = [s for s in dec if self.active[s].pos
                < self.active[s].new_tokens]
        granted = [s for s in live
                   if self.active[s] is not None and self._grow(s)]
        granted = [s for s in granted if self.active[s] is not None]
        pre = [s for s in pre if self.active[s] is not None]
        if not granted and not pre:
            return 0.0
        depth = self.spec.depth if self.spec is not None else 0
        nodes = depth + 1 if self.spec is not None else 1
        w = min(self.window, self.chunk)
        ticks = 0
        chunk_rows = 0
        completed: List[int] = []
        brk = False
        while ticks < max(self.megastep, 1) and not brk:
            ticks += 1
            for s in pre:
                req = self.active[s]
                take = min(w, req.prefill_target - req.prefill_pos)
                chunk_rows += take
                req.prefill_pos += take
                if req.prefill_pos >= req.prefill_target:
                    req.pos = max(req.pos, 1)  # device samples token one
                    completed.append(s)
                    brk = True  # `chunk` break
            for s in granted:
                req = self.active[s]
                emit = 1
                d = 0
                while (d < depth
                       and self.rs.random_sample() < self.acceptance):
                    emit += 1
                    d += 1
                req.pos = min(req.new_tokens, req.pos + emit)
                if req.pos >= req.new_tokens:
                    brk = True  # finish break
                held = req.private_pages + req.attached_pages
                if req.seq_len + nodes > held * self.page:
                    brk = True  # page (or spec `verify`) break
        padded = self.slots - len(granted) - len(pre)
        cost = self.tick.mixed_dispatch(
            len(granted), chunk_tokens=chunk_rows / ticks,
            tree_nodes=nodes, padded_rows=max(padded, 0),
            megastep=float(ticks), overlap=self.overlap)
        for s in completed:
            req = self.active[s]
            if req is not None and req.first_token_s is None:
                req.first_token_s = self.t + cost
        return cost

    def _finish(self) -> None:
        for s in list(self.admit_order):
            req = self.active[s]
            if (req.prefill_pos >= req.prefill_target
                    and req.pos >= req.new_tokens):
                req.done_s = self.t
                self._publish(req)
                self._detach(req)
                req.private_pages = 0
                self.active[s] = None
                self.admit_order.remove(s)

    # -- the loop -------------------------------------------------------

    def play(self, arrivals: List[SimRequest]) -> None:
        pending = sorted(arrivals, key=lambda r: (r.submit_s, r.rid))
        ai = 0
        remaining = len(pending)
        while remaining > 0:
            self.ticks += 1
            if self.ticks > MAX_SIM_TICKS:
                raise RuntimeError(
                    f"ticksim exceeded {MAX_SIM_TICKS} ticks — the "
                    "simulated strategy cannot make progress (pool too "
                    "small for the workload?)")
            while ai < len(pending) and pending[ai].submit_s <= self.t:
                self.queue.append(pending[ai])
                ai += 1
            self._admit_pending()
            live = [s for s in self.admit_order]
            if not live:
                if ai < len(pending):
                    self.t = max(self.t, pending[ai].submit_s)
                    continue
                break  # queue unservable — records stay open
            pre = [s for s in live if self.active[s].prefill_pos
                   < self.active[s].prefill_target]
            dec = [s for s in live if s not in pre]
            # host-tier fetches issued by this tick's admissions gate
            # the prefills they feed — the transfer is simulated time
            cost = self._pending_fetch_s
            self._pending_fetch_s = 0.0
            if self.mixed:
                cost += self._mixed_tick(pre, dec)
            else:
                if pre:
                    cost += self._prefill_tick(pre)
                cost += self._decode_tick(dec, mixed=bool(pre))
            if cost <= 0.0:
                # every live slot stalled: charge one idle host tick so
                # time always advances
                cost = self.tick.host_dispatch_s
            self.t += cost
            self._finish()
            remaining = sum(1 for r in arrivals if r.done_s is None)
