"""Observability of the servers and the training loop (counterpart of
flexflow_tpu/obs/, all of it but the compile tracker):

  * `MetricsRegistry` (obs.metrics): counters, gauges and fixed-bucket
    histograms. Always on — every generation server owns one and feeds
    both the JSON metrics endpoint and the Prometheus text endpoint
    (serving.http_serve). An observe() is a bisect and two adds on the
    host.
  * Span recorder + TickLedger (obs.trace / obs.ledger): opt-in via
    `obs.enable()`. When disabled, `obs.span(name)` returns a shared
    falsy singleton — no allocation and no torch call on the tick path.
    When enabled, each span is also a torch.profiler.record_function
    range (and an nvtx range on the card), so a torch.profiler capture
    over the same window shows the host spans around their kernels.
  * Request log + SLO monitor (obs.reqlog / obs.slo): a bounded flight
    recorder of one record per COMPLETED request (`request_log(0)` is a
    falsy no-op), and the sliding-window SLO judge whose breach events
    dump the recorder state (the span trace's tail included) to disk.

Usage on a hot path:

    from flexflow_tpu_torch import obs
    ...
    with obs.span("decode_tick") as sp:
        if sp:  # only build the attrs dict when someone is recording
            sp.set(live=len(live), width=T)
        ...

Taking a trace:

    obs.enable()
    ... serve traffic ...
    obs.recorder().export_chrome_trace("trace.json")   # Perfetto
    obs.ledger().save("ledger.json")

`obs.calibrate` (imported as a module: it reaches the strategy search)
diffs a saved ledger against the tick time the search prices, per tick
shape: the scales the serving-strategy search takes. The compile tracker
waits for CUDA graphs (ROADMAP.md, queue 1 items 7 and 9).
"""

from __future__ import annotations

from typing import Optional

from flexflow_tpu_torch.obs.ledger import TickLedger, shape_key
from flexflow_tpu_torch.obs.metrics import (
    COUNT_BUCKETS,
    RATIO_BUCKETS,
    TIME_BUCKETS_S,
    Histogram,
    MetricsRegistry,
    flatten_scalars,
)
from flexflow_tpu_torch.obs.reqlog import (
    NULL_REQLOG,
    BoundedRing,
    RequestLog,
    dump_jsonl,
    load_jsonl,
    request_log,
)
from flexflow_tpu_torch.obs.slo import SLOMonitor, SLOTarget
from flexflow_tpu_torch.obs.trace import NULL_SPAN, Span, TraceRecorder

_recorder: Optional[TraceRecorder] = None


def enable(max_events: int = 200_000,
           annotate_device: bool = True) -> TraceRecorder:
    """Install a fresh TraceRecorder (replacing any previous one) and
    return it. Spans and ledger recording start immediately."""
    global _recorder
    _recorder = TraceRecorder(max_events=max_events,
                              annotate_device=annotate_device)
    return _recorder


def disable() -> Optional[TraceRecorder]:
    """Stop recording; returns the recorder so its events/ledger can
    still be exported after the fact."""
    global _recorder
    rec, _recorder = _recorder, None
    return rec


def enabled() -> bool:
    return _recorder is not None


def recorder() -> Optional[TraceRecorder]:
    return _recorder


def ledger() -> Optional[TickLedger]:
    return _recorder.ledger if _recorder is not None else None


def span(name: str):
    """A live Span when enabled, else the falsy no-op singleton."""
    rec = _recorder
    if rec is None:
        return NULL_SPAN
    return Span(rec, name)


__all__ = [
    "COUNT_BUCKETS",
    "BoundedRing",
    "Histogram",
    "MetricsRegistry",
    "NULL_REQLOG",
    "NULL_SPAN",
    "RATIO_BUCKETS",
    "RequestLog",
    "SLOMonitor",
    "SLOTarget",
    "Span",
    "TIME_BUCKETS_S",
    "TickLedger",
    "TraceRecorder",
    "disable",
    "dump_jsonl",
    "enable",
    "enabled",
    "flatten_scalars",
    "ledger",
    "load_jsonl",
    "recorder",
    "request_log",
    "shape_key",
    "span",
]
