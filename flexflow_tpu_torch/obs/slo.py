"""slo — live SLO monitoring over the request log, with breach capture
(counterpart of flexflow_tpu/obs/slo.py).

An `SLOTarget` declares the latency contract a serving config was
picked for: TTFT p95 and decode seconds per token. The `SLOMonitor`
folds every completed request's reqlog record (obs.reqlog) into sliding
windows, maintains the window percentiles and a GOODPUT ratio (the
fraction of windowed requests that met every declared target
individually), and latches breach state: the first record that tips a
window percentile over its target is a breach EVENT (counted once per
excursion, `ff_slo_breaches_total`), and the monitor stays "breached"
until the window percentile recovers.

A breach event triggers the flight-recorder dump: the last-N reqlog
records, the span recorder's Chrome-trace tail (when `obs.enable()` is
on, the servers pass it), and a full metrics snapshot, bundled into
`<dump_dir>/breach_NNNN/`.

Percentiles are NEAREST-RANK (ceil(q*n)-th of the sorted window) so a
breach test can hand-compute the exact trip point.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from collections import deque
from typing import Callable, List, Optional

from flexflow_tpu_torch.obs import reqlog as _reqlog

# reqlog records / trace events a breach bundle keeps — a tail, not the
# whole ring, so dumps stay small enough to attach to an incident
DUMP_REQLOG_TAIL = 64
DUMP_TRACE_TAIL = 2048


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile of `values` (q in [0, 1])."""
    if not values:
        return 0.0
    vals = sorted(values)
    rank = max(1, math.ceil(len(vals) * q))
    return vals[min(rank, len(vals)) - 1]


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """The declared contract plus the window the monitor judges it
    over. Either latency target may be None (not declared — never
    breaches on that axis); at least one must be set.

    ttft_p95_s: windowed p95 of per-request TTFT (submit -> first
      token) must stay at or under this.
    s_per_token_p95: windowed p95 of per-request decode seconds per
      generated token must stay at or under this.
    window: completed requests the sliding window holds.
    min_samples: breach checks start only once the window has this
      many records (a single cold-start request is not an incident).
    """

    ttft_p95_s: Optional[float] = None
    s_per_token_p95: Optional[float] = None
    window: int = 256
    min_samples: int = 8

    def __post_init__(self):
        if self.ttft_p95_s is None and self.s_per_token_p95 is None:
            raise ValueError(
                "SLOTarget declares no target: set ttft_p95_s and/or "
                "s_per_token_p95")
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "SLOTarget":
        return cls(**doc)


def _ttft_s(record: dict) -> float:
    return max(0.0, (record["first_token_ns"] - record["submit_ns"]) / 1e9)


def _s_per_token(record: dict) -> float:
    decode_s = max(0.0, (record["done_ns"] - record["first_token_ns"]) / 1e9)
    return decode_s / max(1, int(record.get("decode_tokens", 1)))


class SLOMonitor:
    """Sliding-window SLO judge fed one reqlog record per completed
    request (from the serving loop thread; snapshots may run on any
    thread under the same relaxed-read discipline as the metrics)."""

    def __init__(self, target: SLOTarget, dump_dir: Optional[str] = None):
        if isinstance(target, dict):
            target = SLOTarget.from_json(target)
        self.target = target
        self.dump_dir = dump_dir
        self._ttft: deque = deque(maxlen=target.window)
        self._spt: deque = deque(maxlen=target.window)
        self._ok: deque = deque(maxlen=target.window)  # per-request pass
        self.samples = 0
        self.breaches = 0
        self.breached = False
        self.goodput = 1.0
        self.last_dump: Optional[str] = None

    def observe(self, record: dict) -> bool:
        """Fold one completed-request record in; returns True exactly
        when this record TRIPS a breach (ok -> breached transition) —
        the caller counts it and captures the dump."""
        t = self.target
        ttft = _ttft_s(record)
        spt = _s_per_token(record)
        self._ttft.append(ttft)
        self._spt.append(spt)
        ok = ((t.ttft_p95_s is None or ttft <= t.ttft_p95_s)
              and (t.s_per_token_p95 is None or spt <= t.s_per_token_p95))
        self._ok.append(ok)
        self.samples += 1
        self.goodput = sum(self._ok) / len(self._ok)
        if len(self._ttft) < t.min_samples:
            return False
        over = False
        if t.ttft_p95_s is not None:
            over = over or percentile(list(self._ttft), 0.95) > t.ttft_p95_s
        if t.s_per_token_p95 is not None:
            over = over or percentile(list(self._spt), 0.95) > t.s_per_token_p95
        tripped = over and not self.breached
        self.breached = over
        if tripped:
            self.breaches += 1
        return tripped

    def snapshot(self) -> dict:
        return {
            "target": self.target.to_json(),
            "samples": self.samples,
            "window_samples": len(self._ttft),
            "ttft_p95_s": percentile(list(self._ttft), 0.95),
            "s_per_token_p95": percentile(list(self._spt), 0.95),
            "goodput_ratio": self.goodput,
            "breaches": self.breaches,
            "breached": self.breached,
            "last_dump": self.last_dump,
        }

    # -- breach capture --------------------------------------------------

    def dump(self, reqlog=None, recorder=None,
             metrics: Optional[Callable[[], dict]] = None,
             strategy: Optional[dict] = None,
             compile_snapshot: Optional[dict] = None) -> Optional[str]:
        """Bundle the flight-recorder state into
        `<dump_dir>/breach_NNNN/`: the reqlog tail (JSONL), the span
        recorder's Chrome-trace tail (when one is live), the server
        metrics snapshot, and this monitor's own snapshot — plus, when
        the caller passes them, the active ServeStrategy JSON
        (`strategy.json`) and a compile-tracker snapshot
        (`compile.json`), so the bundle says WHAT configuration was
        breaching and whether recompiles were part of it. Returns the
        bundle dir (None when no dump_dir is configured). Capture must
        never take the server down: a failing snapshot is recorded as
        an error entry in the bundle, not raised into the loop."""
        if not self.dump_dir:
            return None
        bundle = os.path.join(self.dump_dir, f"breach_{self.breaches:04d}")
        os.makedirs(bundle, exist_ok=True)
        tail = reqlog.tail(DUMP_REQLOG_TAIL) if reqlog else []
        _reqlog.dump_jsonl(os.path.join(bundle, "reqlog_tail.jsonl"), tail)
        if recorder is not None:
            doc = recorder.chrome_trace()
            ev = doc.get("traceEvents", [])
            meta = [e for e in ev if e.get("ph") == "M"]
            rest = [e for e in ev if e.get("ph") != "M"]
            doc["traceEvents"] = meta + rest[-DUMP_TRACE_TAIL:]
            with open(os.path.join(bundle, "trace_tail.json"), "w") as f:
                json.dump(doc, f)
        if metrics is not None:
            try:
                snap = metrics()
            except Exception as e:  # capture, don't crash the loop
                snap = {"error": f"{type(e).__name__}: {e}"}
            with open(os.path.join(bundle, "metrics.json"), "w") as f:
                json.dump(snap, f, indent=1, sort_keys=True, default=str)
        if strategy is not None:
            with open(os.path.join(bundle, "strategy.json"), "w") as f:
                json.dump(strategy, f, indent=1, sort_keys=True)
        if compile_snapshot is not None:
            with open(os.path.join(bundle, "compile.json"), "w") as f:
                json.dump(compile_snapshot, f, indent=1, sort_keys=True,
                          default=str)
        with open(os.path.join(bundle, "slo.json"), "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        self.last_dump = bundle
        return bundle
