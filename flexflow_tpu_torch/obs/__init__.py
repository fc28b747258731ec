"""Observability of the servers (counterpart of flexflow_tpu/obs/, its
metrics, request log and SLO parts):

  * `MetricsRegistry` (obs.metrics): counters, gauges and fixed-bucket
    histograms. Always on — every generation server owns one and feeds
    both the JSON metrics endpoint and the Prometheus text endpoint
    (serving.http_serve). An observe() is a bisect and two adds on the
    host.
  * Request log + SLO monitor (obs.reqlog / obs.slo): a bounded flight
    recorder of one record per COMPLETED request (`request_log(0)` is a
    falsy no-op), and the sliding-window SLO judge whose breach events
    dump the recorder state to disk.

The reference's span tracer, tick ledger, compile tracker and
calibration are not ported yet (ROADMAP.md, queue 1 item 9).
"""

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

__all__ = [
    "COUNT_BUCKETS",
    "BoundedRing",
    "Histogram",
    "MetricsRegistry",
    "NULL_REQLOG",
    "RATIO_BUCKETS",
    "RequestLog",
    "SLOMonitor",
    "SLOTarget",
    "TIME_BUCKETS_S",
    "dump_jsonl",
    "flatten_scalars",
    "load_jsonl",
    "request_log",
]
