"""Metrics registry — counters, gauges, and fixed-bucket histograms
(counterpart of flexflow_tpu/obs/metrics.py; the same names, buckets and
Prometheus text, byte for byte).

One registry instance per server (serving._GenerationServerBase owns
one); the same registry backs BOTH the JSON metrics payload
(`/v2/models/<name>/metrics` → `"histograms"`) and the Prometheus
text-exposition endpoint (`GET /metrics`, `ff_` prefix), so the two
surfaces can never disagree on a number.

Histograms are fixed-bucket (Prometheus-style cumulative `le` buckets):
observe() is a bisect + two increments — cheap enough to run
unconditionally on the decode tick path, unlike the span recorder which
is opt-in. Percentiles are estimated by linear interpolation inside the
owning bucket, the same estimate `histogram_quantile()` computes server
side in PromQL.
"""

from __future__ import annotations

import json
import re
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# exponential latency buckets, 100us .. ~100s
TIME_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0,
)
# small-count buckets (tokens emitted per tick, slots live, tree widths)
COUNT_BUCKETS: Tuple[float, ...] = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
)
# unit-interval buckets (acceptance rates, occupancies)
RATIO_BUCKETS: Tuple[float, ...] = (
    0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)


class Counter:
    """Monotonic counter. Name it `*_total` (Prometheus convention)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with Prometheus `le` semantics: bucket i
    counts observations <= bounds[i]; one implicit +Inf bucket tails."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"bucket bounds must ascend, got {bounds}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)  # [..., +Inf]
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0,1]) by linear interpolation in
        the owning bucket; None when empty. Observations past the last
        bound clamp to it (no upper edge to interpolate toward)."""
        if self.count == 0:
            return None
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]

    def to_json(self) -> Dict:
        return {
            "buckets": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    out = _NAME_OK.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


def flatten_scalars(d: Dict, prefix: str = "") -> Dict[str, float]:
    """Flatten a nested metrics dict to {dotted_name: float}, keeping
    only numeric leaves (lists — per-request records — and None are
    skipped; bools count as 0/1)."""
    out: Dict[str, float] = {}
    for k, v in d.items():
        name = f"{prefix}{k}" if not prefix else f"{prefix}_{k}"
        if isinstance(v, dict):
            out.update(flatten_scalars(v, name))
        elif isinstance(v, bool):
            out[name] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[name] = float(v)
    return out


class MetricsRegistry:
    """Named counters/gauges/histograms; create-or-get accessors so the
    instrumentation sites stay one-liners."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  bounds: Sequence[float] = TIME_BUCKETS_S) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(bounds)
        return h

    # -- export ----------------------------------------------------------

    def to_json(self) -> Dict:
        out: Dict = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[name] = g.value
        for name, h in sorted(self._histograms.items()):
            out[name] = h.to_json()
        return out

    def prometheus_text(self, prefix: str = "ff_",
                        extra_scalars: Optional[Dict[str, float]] = None
                        ) -> str:
        """Prometheus text exposition (version 0.0.4). `extra_scalars`
        (e.g. the flattened server metrics dict) render as gauges —
        except `*_total`/`*_count`/counter-shaped names, which render as
        counters so scrape-side rate() works."""
        lines: List[str] = []

        def emit(name: str, kind: str, body: List[str]):
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(body)

        for name, c in sorted(self._counters.items()):
            n = prefix + _sanitize(name)
            emit(n, "counter", [f"{n} {_fmt(c.value)}"])
        for name, g in sorted(self._gauges.items()):
            n = prefix + _sanitize(name)
            emit(n, "gauge", [f"{n} {_fmt(g.value)}"])
        for name, h in sorted(self._histograms.items()):
            n = prefix + _sanitize(name)
            body = []
            cum = 0
            for bound, cnt in zip(h.bounds, h.counts):
                cum += cnt
                body.append(f'{n}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += h.counts[-1]
            body.append(f'{n}_bucket{{le="+Inf"}} {cum}')
            body.append(f"{n}_sum {_fmt(h.sum)}")
            body.append(f"{n}_count {h.count}")
            emit(n, "histogram", body)
        for name, v in sorted((extra_scalars or {}).items()):
            n = prefix + _sanitize(name)
            kind = ("counter" if n.endswith(("_total", "_served", "_steps",
                                            "_ticks", "_tokens", "_hits",
                                            "_misses", "_evictions"))
                    else "gauge")
            emit(n, kind, [f"{n} {_fmt(v)}"])
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Shortest faithful float rendering (ints stay integral)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def registry_json_roundtrips(reg: MetricsRegistry) -> bool:
    """Debug helper: the JSON export must be json-serializable."""
    json.dumps(reg.to_json())
    return True
