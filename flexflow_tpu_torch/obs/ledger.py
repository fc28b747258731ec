"""TickLedger — measured per-tick wall times keyed by tick shape
(counterpart of flexflow_tpu/obs/ledger.py: plain Python, the same key
format and JSON layout, so either package reads the other's ledgers).

Every scheduler tick records its measured wall time under a *shape key*
("what work did this tick do"), so a calibration can diff each shape's
measured distribution against the time a cost model prices for the same
work. Shape keys:

    decode|b4|c0|w1     — plain decode tick, 4 live slots
    verify|b4|c0|w8     — speculative verify, 8-node trees
    prefill|b2|c64|w1   — chunked prefill, 64 prompt tokens this tick

Per-shape samples are bounded (deque maxlen): a long-running server's
ledger holds the *recent* distribution per shape, not an unbounded
history — calibration wants current conditions anyway.

The ledger also carries a `meta` dict (model name, predicted base step
time, graph token count) stamped by whoever runs the workload, so a
saved ledger.json is self-contained.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Deque, Dict, List, Optional


def shape_key(phase: str, batch: int, chunk: int = 0, width: int = 1) -> str:
    return f"{phase}|b{int(batch)}|c{int(chunk)}|w{int(width)}"


def parse_shape_key(key: str) -> Dict:
    phase, b, c, w = key.split("|")
    return {"phase": phase, "batch": int(b[1:]), "chunk": int(c[1:]),
            "width": int(w[1:])}


def _quantile(sorted_vals: List[float], q: float) -> float:
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (idx - lo)


class TickLedger:
    """Bounded per-shape samples of measured tick wall times (seconds)."""

    def __init__(self, max_samples_per_shape: int = 512):
        self.max_samples = int(max_samples_per_shape)
        self._samples: Dict[str, Deque[float]] = {}
        self._counts: Dict[str, int] = {}
        self.meta: Dict = {}

    def record(self, phase: str, seconds: float, batch: int,
               chunk: int = 0, width: int = 1) -> None:
        key = shape_key(phase, batch, chunk, width)
        d = self._samples.get(key)
        if d is None:
            d = self._samples[key] = deque(maxlen=self.max_samples)
        d.append(float(seconds))
        self._counts[key] = self._counts.get(key, 0) + 1

    def shapes(self) -> List[str]:
        return sorted(self._samples)

    def stats(self, key: str) -> Optional[Dict]:
        d = self._samples.get(key)
        if not d:
            return None
        vals = sorted(d)
        return {
            "count": self._counts[key],
            "sampled": len(vals),
            "mean_s": sum(vals) / len(vals),
            "p50_s": _quantile(vals, 0.50),
            "p95_s": _quantile(vals, 0.95),
            "min_s": vals[0],
            "max_s": vals[-1],
        }

    # -- persistence -------------------------------------------------------

    def to_json(self) -> Dict:
        return {
            "version": 1,
            "max_samples_per_shape": self.max_samples,
            "meta": self.meta,
            "shapes": {
                key: {"count": self._counts[key],
                      "samples": list(self._samples[key])}
                for key in self.shapes()
            },
        }

    @classmethod
    def from_json(cls, doc: Dict) -> "TickLedger":
        led = cls(max_samples_per_shape=doc.get("max_samples_per_shape",
                                                512))
        led.meta = dict(doc.get("meta", {}))
        for key, rec in doc.get("shapes", {}).items():
            d = deque(rec["samples"], maxlen=led.max_samples)
            led._samples[key] = d
            led._counts[key] = int(rec.get("count", len(d)))
        return led

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "TickLedger":
        with open(path) as f:
            return cls.from_json(json.load(f))
