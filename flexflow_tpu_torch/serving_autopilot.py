"""serving_autopilot — online strategy re-tuning with drain-and-swap
(counterpart of flexflow_tpu/serving_autopilot.py).

The serving-strategy search (search.servesearch) picks knobs for the
traffic it was shown ONCE, at deploy time. Live traffic drifts: prompt
lengths shift, offered concurrency rises, the prefix-share rate decays
when a campaign's shared header rotates out. `ServingAutopilot` closes
the loop:

  * it serves through an inner paged generation server and watches the
    request log it stamps — every record carries the serving
    ServeStrategy's fingerprint(), so windows segment cleanly across
    swaps;
  * `step()` re-runs the strategy search against the live window as a
    `RecordedProfile` (the event-driven `--sim` backend when the window
    carries an arrival trace), with the CURRENT strategy as the search
    default, so `result.improvement` is exactly "how much better than
    what we are running now";
  * when the win clears the threshold it hot-swaps via DRAIN-AND-SWAP:
    build the successor with `defer_start=True`, warm it
    (`warm_launch_shapes()`: build and bind the K3 body its pool dtype
    takes while the old server still serves),
    pause the old loop with `detach_for_swap()` (futures stay pending),
    adopt the old content-addressed PagePool when the geometry matches
    (`adopt_pool_from` — carried requests re-attach their prefix pages
    and recompute only the suffix), seed the successor with the carried
    requests (`absorb_requests`) and start it. Zero requests dropped;
    greedy streams submitted before the swap finish token-identical to
    an unswapped run.

The facade keeps the server surface (`submit` / `generate` / `metrics` /
`request_log` / `registry` / `stop`), so it drops into
`http_serve(..., generation_server=autopilot)` unchanged. `swap_to(
strategy)` is the deterministic primitive; `start(interval_s)` runs
`step()` on a background thread.

Not ported yet: the reference's `catalog` (the union of the two
strategies' shapecheck launch-shape catalogs), `compile_events()` and the
shapecheck soundness check over them. They wait for the compile tracker
(ROADMAP.md queue 1 item 9, after item 7's CUDA graphs) and shapecheck
(item 13); this module does not stand in for them.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

# decisions kept for the /v2 payload — a tail, not an unbounded log
DECISION_LOG_LIMIT = 64

# relative change in any windowed traffic moment (prompt mean, decode
# length, offered concurrency) that counts as drift worth a re-tune
DRIFT_THRESHOLD = 0.25


def _traffic_moments(profile) -> dict:
    """The drift coordinates: the windowed traffic moments a strategy
    was tuned for. Compared relatively, so the threshold is unitless."""
    stats = profile.prompt_stats()
    return {
        "prompt_mean": float(stats.get("prompt_mean", 0.0)),
        "new_tokens": float(getattr(profile, "new_tokens", 0) or 0),
        "offered_concurrency": float(
            getattr(profile, "offered_concurrency", 0.0) or 0.0),
    }


def _drift(a: Optional[dict], b: dict) -> float:
    """Max relative delta across the traffic moments (0 = identical)."""
    if not a:
        return float("inf")  # never tuned — any window is "drifted"
    worst = 0.0
    for k, new in b.items():
        old = a.get(k, 0.0)
        denom = max(abs(old), 1e-9)
        worst = max(worst, abs(new - old) / denom)
    return worst


class ServingAutopilot:
    """Self-tuning facade over a paged generation server.

    Build it where you would have called `serve_generation(paged=True)`;
    it constructs (and owns) the inner server, re-tunes against the
    live request log, and hot-swaps strategies without dropping
    requests. All server kwargs are captured so every successor is
    built with the same slots/max_len/eos/seed/SLO wiring — only the
    ServeStrategy knobs change across a swap.

    `min_window` gates re-tuning on how many completed requests the
    CURRENT strategy has served (records are segmented by strategy
    fingerprint); `improvement` is the fractional objective win a
    candidate must show over the running strategy before a swap is
    worth the cutover; `sim=True` scores candidates with the
    event-driven tick simulator (search.ticksim) against the window's
    recorded arrival sequence."""

    def __init__(self, ff, strategy=None, *, slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0, reqlog_capacity: Optional[int] = None,
                 slo=None, slo_dump_dir: Optional[str] = None,
                 min_window: int = 32, improvement: float = 0.05,
                 drift_threshold: float = DRIFT_THRESHOLD,
                 budget: int = 64, sim: bool = True, search_seed: int = 0):
        from flexflow_tpu_torch.serving import serve_generation

        self._ff = ff
        self._server_kwargs = dict(
            slots=int(slots), max_len=int(max_len), eos_id=eos_id,
            seed=int(seed), reqlog_capacity=reqlog_capacity, slo=slo,
            slo_dump_dir=slo_dump_dir)
        self.min_window = int(min_window)
        self.improvement = float(improvement)
        self.drift_threshold = float(drift_threshold)
        self.budget = int(budget)
        self.sim = bool(sim)
        self.search_seed = int(search_seed)
        self._inner = serve_generation(ff, paged=True,
                                       serve_strategy=strategy,
                                       **self._server_kwargs)
        # one swap (or submit racing a swap) at a time: submits grab
        # this lock too, so a request lands in the OLD queue (and gets
        # carried) or the NEW one — never in a stopped server
        self._swap_lock = threading.Lock()
        self.decisions: List[dict] = []
        self.steps = 0
        self.swaps = 0
        self.holds = 0
        self.last_improvement = 0.0
        # moments of the window the running strategy was last tuned
        # against — the drift baseline. None until the first search.
        self._tuned_moments: Optional[dict] = None
        # sim-vs-measured: the simulator's TTFT p95 prediction for the
        # running strategy vs what the live window measured
        self._predicted_ttft_p95 = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -- server facade ----------------------------------------------------

    @property
    def server(self):
        """The inner generation server currently taking traffic —
        snapshotted under the swap lock, so a caller holds a coherent
        reference even if a swap lands the next instant."""
        with self._swap_lock:
            return self._inner

    @property
    def strategy(self):
        return self.server.serve_strategy

    @property
    def strategy_fingerprint(self) -> Optional[str]:
        return self.server.strategy_fingerprint

    @property
    def request_log(self):
        return self.server.request_log

    @property
    def registry(self):
        return self.server.registry

    def submit(self, prompt_ids, max_new_tokens, temperature: float = 0.0):
        # under the swap lock: a submit either reaches the old server
        # (whose queue detach_for_swap() carries over wholesale) or the
        # started successor — the brief cutover stall is the entire
        # client-visible cost of a swap
        with self._swap_lock:
            return self._inner.submit(prompt_ids, max_new_tokens,
                                      temperature)

    def generate(self, prompt_ids, max_new_tokens,
                 temperature: float = 0.0):
        return self.submit(prompt_ids, max_new_tokens,
                           temperature).result()

    def metrics(self) -> dict:
        out = self.server.metrics()
        window = self._window_records()
        measured = self._measured_ttft_p95(window)
        with self._swap_lock:
            decisions = self.decisions[-DECISION_LOG_LIMIT:]
            holds = self.holds
        # deliberate relaxed reads: the counters are monotonic ints
        # mutated only by the controller thread, and a metrics scrape
        # that races a step by one tick is harmless
        out["autopilot"] = {
            "steps": self.steps,
            "swaps": self.swaps,
            "holds": holds,
            "last_improvement": self.last_improvement,
            "window_records": len(window),
            "sim_backend": 1.0 if self.sim else 0.0,
            "predicted_ttft_p95_s": self._predicted_ttft_p95,
            "measured_ttft_p95_s": measured,
            # decisions are dicts-with-strings: JSON payload only, the
            # Prometheus flattener (obs.flatten_scalars) skips them
            "decisions": decisions,
        }
        return out

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            # join OUTSIDE the swap lock: the controller thread takes it
            # inside swap_to, and joining while holding it would deadlock
            self._thread.join(timeout=30)
            self._thread = None
        self.server.stop()

    # -- controller -------------------------------------------------------

    def _window_records(self) -> List[dict]:
        """Completed-request records served by the CURRENT strategy —
        the fingerprint stamp segments the log across swaps, so a
        freshly swapped-in strategy re-tunes only on its own traffic."""
        log = self._inner.request_log
        if not log:
            return []
        fp = self._inner.strategy_fingerprint
        return [r for r in log.records() if r.get("strategy") == fp]

    @staticmethod
    def _measured_ttft_p95(records: List[dict]) -> float:
        from flexflow_tpu_torch.obs.slo import percentile

        ttfts = [(r["first_token_ns"] - r["submit_ns"]) / 1e9
                 for r in records
                 if r.get("first_token_ns") and r.get("submit_ns")]
        return percentile(ttfts, 0.95) if ttfts else 0.0

    def step(self, force: bool = False) -> dict:
        """One controller evaluation: window -> drift gate -> search ->
        swap-or-hold. Returns (and logs) the decision record. `force`
        skips the drift gate — the search still has to show the
        improvement before anything swaps."""
        self.steps += 1
        inner = self.server  # one coherent snapshot for this evaluation
        fp = inner.strategy_fingerprint
        window = self._window_records()
        decision = {"step": self.steps, "fingerprint": fp,
                    "window": len(window), "action": "hold"}
        if len(window) < self.min_window:
            decision["reason"] = "insufficient-window"
            return self._record(decision)

        from flexflow_tpu_torch.search.traffic import RecordedProfile

        profile = RecordedProfile(window, name=f"autopilot-{fp}")
        moments = _traffic_moments(profile)
        slo = getattr(inner, "_slo", None)
        breached = bool(slo is not None and slo.breached)
        drift = _drift(self._tuned_moments, moments)
        decision["drift"] = None if drift == float("inf") else drift
        decision["slo_breached"] = breached
        if (not force and not breached
                and drift <= self.drift_threshold):
            decision["reason"] = "no-drift"
            return self._record(decision)

        from flexflow_tpu_torch.search.servesearch import search_serve_strategy

        result = search_serve_strategy(
            self._ff, traffic=profile, budget=self.budget,
            slots=self._server_kwargs["slots"],
            max_len=self._server_kwargs["max_len"],
            default=inner.serve_strategy,
            sim=self.sim, seed=self.search_seed)
        self._tuned_moments = moments
        self.last_improvement = result.improvement
        self._predicted_ttft_p95 = float(
            result.default_metrics.get("ttft_p95_s", 0.0))
        decision["backend"] = result.backend
        decision["improvement"] = result.improvement
        decision["candidate"] = result.best.fingerprint()
        if result.best.fingerprint() == fp:
            decision["reason"] = "already-optimal"
            return self._record(decision)
        if result.improvement < self.improvement:
            decision["reason"] = "below-threshold"
            return self._record(decision)
        swap = self.swap_to(result.best)
        decision.update(action="swap", reason="improvement", **swap)
        return self._record(decision)

    def _record(self, decision: dict) -> dict:
        # the decision log is swap-lock-guarded: the /v2 scrape slices
        # it from other threads while the controller appends + trims,
        # and a trim mid-slice must not hand the scrape a torn tail
        # (never called with the lock held — swap_to releases first)
        with self._swap_lock:
            if decision["action"] != "swap":
                self.holds += 1
            self.decisions.append(decision)
            del self.decisions[:-DECISION_LOG_LIMIT]
        logger.info("autopilot step %d: %s (%s)", decision["step"],
                    decision["action"], decision.get("reason", ""))
        return decision

    # -- drain-and-swap ---------------------------------------------------

    def swap_to(self, strategy) -> dict:
        """Hot-swap the inner server to `strategy` with zero dropped
        requests: load the successor's K3 body BEFORE cutover, pause the
        old loop without cancelling futures, carry every pending request
        across, adopt the page pool when the geometry allows, and only
        then take new submits. Returns the swap record (carried count,
        pool adoption, cutover seconds, kernels warmed)."""
        from flexflow_tpu_torch.serving import serve_generation

        # build + warm OUTSIDE the swap lock: the successor allocates
        # its pool and loads its K3 body while the old server still
        # takes traffic, and submits only stall for the cutover itself
        new = serve_generation(self._ff, paged=True,
                               serve_strategy=strategy,
                               defer_start=True,
                               **self._server_kwargs)
        warmed = new.warm_launch_shapes()
        t0 = time.monotonic()
        with self._swap_lock:
            old = self._inner
            old_fp = old.strategy_fingerprint
            carried = old.detach_for_swap()
            adopted = new.adopt_pool_from(old)
            new.absorb_requests(carried)
            # request history survives the swap: the successor appends
            # to the predecessor's ring buffer, so the autopilot's
            # tuning window and any reqlog export span the cutover
            # (records still segment by their strategy stamp)
            new._reqlog = old._reqlog
            new.start()
            self._inner = new
            self.swaps += 1
        record = {
            "from": old_fp,
            "to": new.strategy_fingerprint,
            "carried": len(carried),
            "pool_adopted": bool(adopted),
            "cutover_s": time.monotonic() - t0,
            "warmed": warmed,
        }
        logger.info("autopilot swap %s -> %s: carried=%d adopted=%s "
                    "cutover=%.3fs", record["from"], record["to"],
                    record["carried"], record["pool_adopted"],
                    record["cutover_s"])
        return record

    # -- background operation ---------------------------------------------

    def start(self, interval_s: float = 30.0):
        """Run `step()` every `interval_s` on a daemon thread until
        `stop()`. Manual `step()`/`swap_to()` remain available (they
        serialize on the swap lock)."""
        if self._thread is not None:
            raise RuntimeError("autopilot already started")
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval_s):
                try:
                    self.step()
                except Exception:  # keep the controller alive — a bad
                    # search window must never take serving down
                    logger.exception("autopilot step failed")

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
