"""Span recorder — thread-aware, monotonic-clock tracing for the
serving tick loop (counterpart of flexflow_tpu/obs/trace.py; the same
events, request tracks and Chrome-trace export).

Design constraints, in order:

  1. TRUE NO-OP WHEN DISABLED. `obs.span(name)` returns one shared
     `NULL_SPAN` singleton when no recorder is installed: no object is
     allocated per call, `with` enter/exit touch nothing (no torch call
     either), and the span is falsy so call sites guard their attribute
     computation (`if sp: sp.set(live=...)`) — the attrs dict is never
     even built. The decode tick pays one module-global load and an
     `is None` test.
  2. One clock. Spans stamp `time.monotonic_ns()`; request lifecycle
     events convert the `time.monotonic()` stamps _GenRequest already
     carries — same clock, so tick spans and request tracks line up in
     Perfetto without skew correction.
  3. No device read. A span stamps the host clock around work that is
     already enqueued; it never synchronizes the card, so a traced tick
     makes the same synchronizing calls as an untraced one.
  4. Correlate with device traces. When enabled (annotate_device) each
     span also enters `torch.profiler.record_function(name)`, so a
     torch.profiler capture over the same window shows the host span
     names around the kernels they enqueued, and, with a card present,
     a `torch.cuda.nvtx` range of the same name.

Export is Chrome-trace/Perfetto `trace_event` JSON: tick-phase spans as
complete ("X") events on their thread's track, per-request lifecycle as
queued/prefill/decode "X" events on one synthetic track per request
(pid 2), thread/process names as "M" metadata events.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from typing import Dict, List, Optional

import torch

from flexflow_tpu_torch.obs.ledger import TickLedger


class _NullSpan:
    """Falsy no-op span: the disabled-path singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        return None


NULL_SPAN = _NullSpan()


class Span:
    """One live span; created only when a recorder is installed."""

    __slots__ = ("_rec", "name", "attrs", "_t0", "_tid", "_ann", "_nvtx")

    def __init__(self, rec: "TraceRecorder", name: str):
        self._rec = rec
        self.name = name
        self.attrs: Optional[Dict] = None
        self._t0 = 0
        self._tid = 0
        self._ann = None
        self._nvtx = False

    def __bool__(self):
        return True

    def set(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._tid = threading.get_ident()
        rec = self._rec
        if rec.annotate_device:
            try:
                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
            if rec.nvtx:
                torch.cuda.nvtx.range_push(self.name)
                self._nvtx = True
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                pass
        self._rec._finish(self.name, self._t0, t1 - self._t0, self._tid,
                          self.attrs)
        return False


class TraceRecorder:
    """Collects span events in memory (bounded), owns the TickLedger,
    and exports Chrome-trace JSON. Appends happen from the scheduler
    threads while readers may export from another — all mutation is
    list.append / int adds, safe under the GIL, and export snapshots
    with list() first."""

    def __init__(self, max_events: int = 200_000,
                 annotate_device: bool = True):
        self.max_events = int(max_events)
        # (name, ts_ns, dur_ns, tid, attrs) complete events
        self.events: List[tuple] = []
        self.dropped = 0
        # (rid, label, submit_ns, admit_ns, first_ns, done_ns, attrs)
        self.requests: List[tuple] = []
        self._req_seq = 0
        self.ledger = TickLedger()
        self.t0_ns = time.monotonic_ns()
        # record_function ranges for a torch.profiler capture; nvtx ranges
        # only where a card is present (a CPU-only build has no nvtx)
        self.annotate_device = bool(annotate_device)
        self.nvtx = self.annotate_device and torch.cuda.is_available()

    # -- recording -------------------------------------------------------

    def span(self, name: str) -> Span:
        return Span(self, name)

    def _finish(self, name, t0, dur, tid, attrs):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append((name, t0, dur, tid, attrs))

    def instant(self, name: str, **attrs):
        if len(self.events) < self.max_events:
            self.events.append((name, time.monotonic_ns(), 0,
                                threading.get_ident(), attrs or None))

    def record_request(self, submit_t: float, admit_t: Optional[float],
                       first_token_t: Optional[float], done_t: float,
                       label: str = "", attrs: Optional[Dict] = None
                       ) -> int:
        """One completed request's lifecycle from the monotonic-seconds
        stamps _GenRequest carries: queued [submit→admit], prefill
        [admit→first token], decode [first token→done]. Missing stamps
        collapse their phase to zero width at the next known edge."""
        self._req_seq += 1
        rid = self._req_seq
        to_ns = lambda s: int(s * 1e9)  # noqa: E731 — same monotonic clock
        admit = admit_t if admit_t is not None else done_t
        first = first_token_t if first_token_t is not None else done_t
        self.requests.append((rid, label or f"req {rid}", to_ns(submit_t),
                              to_ns(admit), to_ns(first), to_ns(done_t),
                              attrs))
        return rid

    # -- export ----------------------------------------------------------

    @staticmethod
    def _us(ns: int) -> float:
        return ns / 1e3

    def chrome_trace(self) -> Dict:
        """`trace_event` JSON: pid 1 = tick loop threads, pid 2 = one
        synthetic track per request. Loads in chrome://tracing and
        https://ui.perfetto.dev unmodified."""
        ev: List[Dict] = [
            {"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "fftrace: tick loop"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "fftrace: requests"}},
        ]
        tids = set()
        for name, t0, dur, tid, attrs in list(self.events):
            tids.add(tid)
            e = {"name": name, "ph": "X", "cat": "tick", "pid": 1,
                 "tid": tid, "ts": self._us(t0 - self.t0_ns),
                 "dur": self._us(dur)}
            if attrs:
                e["args"] = attrs
            ev.append(e)
        for tid in sorted(tids):
            ev.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": f"loop thread {tid}"}})
        for rid, label, sub, adm, first, done, attrs in list(self.requests):
            ev.append({"ph": "M", "name": "thread_name", "pid": 2,
                       "tid": rid, "args": {"name": label}})
            for phase, a, b in (("queued", sub, adm),
                                ("prefill", adm, first),
                                ("decode", first, done)):
                e = {"name": phase, "ph": "X", "cat": "request", "pid": 2,
                     "tid": rid, "ts": self._us(a - self.t0_ns),
                     "dur": self._us(max(b - a, 0))}
                if phase == "decode" and attrs:
                    e["args"] = attrs
                ev.append(e)
        ev.sort(key=lambda e: (e.get("ts", -1.0), e["pid"]))
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export_chrome_trace(self, path: str) -> str:
        """Write the trace JSON (gzipped when `path` ends in .gz)."""
        doc = self.chrome_trace()
        if path.endswith(".gz"):
            with gzip.open(path, "wt") as f:
                json.dump(doc, f)
        else:
            with open(path, "w") as f:
                json.dump(doc, f)
        return path
