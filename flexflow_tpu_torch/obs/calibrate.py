"""Predicted-vs-measured calibration: diff the TickLedger against the
serving-tick time the search side prices (counterpart of
flexflow_tpu/obs/calibrate.py).

The search stack prices one *full step* of the compiled graph with the
port's per-device event simulator (search/eventsim.step_seconds, whose
native engine is built from csrc/ffsim.cc at first use). A serving tick
runs the same program at a different token count — `batch` rows for a
plain decode tick, `batch * tree_width` scored rows for a speculative
verify, `chunk` prompt tokens for a chunked-prefill tick — so the
prediction for a tick shape is the priced step time scaled by
tick_tokens / graph_tokens. That linear-in-tokens model is crude on
purpose: its per-shape error IS the calibration signal. The report's
ratios (measured / predicted) are exactly the scale factors
`MeasuredCostModel.set_tick_calibration` consumes.

`stamp_ledger_meta(ledger, ff)` embeds the priced base step into the
ledger before it is saved, so `fftrace calibrate ledger.json` runs from
the artifact alone — no model, no card. It also stamps the device the
ticks were measured on (`card`: the GPU's name, or "cpu"): a scale
factor is the ratio of one card's ticks to the machine model, and the
report carries which card that was. Nothing is refused on the stamp;
the staleness window of search/servesearch.load_calibration stays the
only gate, as in the reference. The reference's compile block (the
compile tracker's median per-compile seconds) is written only when a
ledger's meta carries it: the port has no compile tracker yet
(ROADMAP.md, queue 1 item 9).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from flexflow_tpu_torch.obs.ledger import TickLedger, parse_shape_key

# Report schema: v2 added the created-at stamp consumers use for
# staleness (search/servesearch.py refuses reports older than its
# max-age window).
CALIBRATION_SCHEMA_VERSION = 2


def graph_tokens(graph) -> int:
    """Token count of one step of `graph`: product of the first INPUT's
    leading dims (batch × seq for an LM, batch for a flat model)."""
    from flexflow_tpu_torch.ffconst import OpType

    first = next(n for n in graph.nodes if n.op_type == OpType.INPUT)
    dims = first.outputs[0].dims
    toks = dims[0].size
    if len(dims) > 1:
        toks *= dims[1].size
    return max(int(toks), 1)


def predict_step_seconds(ff) -> Dict:
    """Price one forward (inference) step of ff's compiled graph with
    the same model the strategy search uses (search/api._cost_model on
    the compiled mesh's axes: the H100 machine unless the config names
    another) through the event simulator. Returns the priced time plus
    everything calibration needs to scale it per tick shape."""
    from flexflow_tpu_torch.search import eventsim
    from flexflow_tpu_torch.search.api import _cost_model

    graph = ff.graph
    strategy = {n.name: n.sharding for n in graph.nodes
                if n.sharding is not None}
    cost = _cost_model(ff.mesh.axes, ff.config)
    t, mode = eventsim.step_seconds(graph, strategy, cost, training=False)
    return {
        "predicted_step_s": float(t),
        "pricing_mode": mode,
        "graph_tokens": graph_tokens(graph),
    }


def tick_tokens(phase: str, batch: int, chunk: int, width: int) -> int:
    """Token rows one ledger entry of this shape pushes through the
    model. For decode, `width` is the MEGASTEP width — fused inner ticks
    per dispatch (w1 = the one-tick loop), each scoring `batch` rows —
    so `decode|b4|w8` prices 32 rows and the per-shape calibration
    ratios (and MeasuredCostModel.decode_tick_time) stay meaningful
    across megastep configurations."""
    if phase == "prefill":
        return max(int(chunk), 1)
    # decode: one row per live slot per fused tick; verify: one row per
    # tree node per slot
    return max(int(batch) * max(int(width), 1), 1)


def predict_tick_seconds(base_step_s: float, base_tokens: int, phase: str,
                         batch: int, chunk: int = 0, width: int = 1
                         ) -> float:
    toks = tick_tokens(phase, batch, chunk, width)
    return base_step_s * toks / max(int(base_tokens), 1)


def stamp_ledger_meta(ledger: TickLedger, ff, **extra) -> None:
    """Embed the priced base step, the card the ticks ran on, and any
    caller context (e.g. model name) into ledger.meta so the saved
    ledger is self-contained."""
    import torch

    ledger.meta.update(predict_step_seconds(ff))
    dev = torch.device(ff.device)
    ledger.meta["card"] = (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else dev.type)
    ledger.meta.update(extra)


def calibration_report(ledger: TickLedger,
                       predicted: Optional[Dict] = None) -> Dict:
    """Per-shape predicted-vs-measured diff. `predicted` overrides the
    base-step pricing; by default it comes from ledger.meta (stamped by
    stamp_ledger_meta). Raises if neither carries a priced step.

    Report structure:
      version / created_at(_unix): schema + staleness stamp — consumers
                   with a freshness window (servesearch) check these
      shapes:      {key: {measured p50/p95/mean, predicted_s, ratio}}
      tick_scales: {key: ratio}      — MeasuredCostModel.set_tick_calibration
      phases:      {phase: median ratio across that phase's shapes}
      meta:        the ledger's context, the `card` stamp among it
      compile:     {seconds_p50, events} when the ledger's meta carries
                   a compile tracker's median (a reference ledger)
    Ratio > 1 means reality is slower than the model prices; ratio ≈ 1
    means the cost model already prices this shape faithfully.
    """
    src = predicted if predicted is not None else ledger.meta
    if "predicted_step_s" not in src:
        raise ValueError(
            "ledger has no predicted_step_s meta — run stamp_ledger_meta "
            "(or pass predicted=) before calibrating")
    base_s = float(src["predicted_step_s"])
    base_tokens = int(src.get("graph_tokens", 1))

    shapes: Dict[str, Dict] = {}
    by_phase: Dict[str, list] = {}
    for key in ledger.shapes():
        st = ledger.stats(key)
        if st is None:
            continue
        sk = parse_shape_key(key)
        pred = predict_tick_seconds(base_s, base_tokens, sk["phase"],
                                    sk["batch"], sk["chunk"], sk["width"])
        ratio = st["p50_s"] / pred if pred > 0 else float("inf")
        shapes[key] = {
            **sk,
            "count": st["count"],
            "measured_p50_s": st["p50_s"],
            "measured_p95_s": st["p95_s"],
            "measured_mean_s": st["mean_s"],
            "predicted_s": pred,
            "ratio": ratio,
        }
        by_phase.setdefault(sk["phase"], []).append(ratio)

    phases = {}
    for phase, ratios in sorted(by_phase.items()):
        rs = sorted(ratios)
        phases[phase] = rs[len(rs) // 2]
    now = time.time()
    report = {
        "version": CALIBRATION_SCHEMA_VERSION,
        "created_at_unix": float(now),
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)),
        "base": {"predicted_step_s": base_s, "graph_tokens": base_tokens,
                 "pricing_mode": src.get("pricing_mode", "unknown")},
        "meta": {k: v for k, v in ledger.meta.items()
                 if k not in ("predicted_step_s", "graph_tokens",
                              "pricing_mode", "compile_seconds_p50",
                              "compile_events")},
        "shapes": shapes,
        "tick_scales": {k: v["ratio"] for k, v in shapes.items()},
        "phases": phases,
    }
    if "compile_seconds_p50" in ledger.meta:
        report["compile"] = {
            "seconds_p50": float(ledger.meta["compile_seconds_p50"]),
            "events": int(ledger.meta.get("compile_events", 0)),
        }
    return report
