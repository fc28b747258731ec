"""fftrace — trace/metrics tooling for the serving tick loop (obs/),
counterpart of the reference's tools/fftrace.py.

    python -m flexflow_tpu_torch.tools.fftrace <command> ...

Subcommands:

  smoke [--out DIR] [--no-speculate] [--megastep K ...]
        [--device cuda|cpu]
      Build a tiny causal LM, serve a handful of requests through the
      paged scheduler (and the speculative server unless --no-speculate;
      and for each K of --megastep, a decode megastep and a mixed one of
      K ticks, so the ledger holds fused `decode|bN|wK` shapes) with the
      span recorder + tick ledger enabled, then write into DIR
      (default ./fftrace_out):
        trace.json.gz    Chrome-trace / Perfetto trace_event JSON
        ledger.json      TickLedger with the priced base step and the
                         card's name stamped in
        calibration.json predicted-vs-measured report (fftrace calibrate)
        reqlog.jsonl     request-log export (obs.reqlog) — the input to
                         `fftrace replay` and `servesearch search --replay`
      The run is on the card by default: a calibration is the ratio of
      one device's measured ticks to the machine model, so it must be
      measured on the device it will correct (the reference forces its
      CPU here). `--device cpu` runs it on the CPU. The last stdout line
      is a one-line JSON summary.

  replay REQLOG.jsonl [--out DIR] [--seed S] [--slots K] [--max-len L]
         [--page-size P] [--pace[=SPEEDUP]] [--device cuda|cpu]
      Re-serve a recorded request log against the tiny smoke server: the
      log's RecordedProfile replays the recorded arrival order and prompt
      lengths (content re-drawn — logs never hold raw tokens) with each
      request's recorded decode budget, on a speculative server when the
      log recorded drafting. Reports recorded-vs-replayed TTFT/queue-time
      p50/p95 and tokens/s deltas; the default replay is a BURST, --pace
      also replays the recorded interarrival deltas (divided by SPEEDUP).
      The last stdout line is the JSON report.

  calibrate LEDGER [--out FILE]
      Load a saved TickLedger and emit the calibration report: per
      tick-shape measured-vs-predicted ratios (the scale factors
      MeasuredCostModel.set_tick_calibration consumes) plus per-phase
      medians. Runs from the artifact alone — no model, no card. Reports
      carry a schema version + created-at stamp; the serving-strategy
      search refuses reports older than 7 days.

  summarize TRACE
      Per-span-name counts and total/mean durations of a trace written
      by `smoke` (or TraceRecorder.export_chrome_trace), .gz or plain.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
from typing import List, Optional, Sequence

TINY_VOCAB = 128


def build_tiny_ff(device: str = "cuda"):
    """The smoke fixture: a tiny fp32 Llama compiled for serving on
    `device`."""
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

    ff = FFModel(FFConfig(batch_size=1, seed=0, device=device))
    build_llama(ff, LlamaConfig.tiny(vocab=TINY_VOCAB), batch_size=1,
                seq_len=8, dtype=DataType.FLOAT)
    ff.compile()
    return ff


def traced_serve(ff, prompts, out: str, *, max_new: int, speculate=None,
                 megastep: Sequence[int] = (),
                 server_kwargs: Optional[dict] = None, **meta) -> dict:
    """Serve `prompts` through the paged server (and again through the
    speculative one when `speculate` is a SpecConfig, and for each K > 1
    in `megastep` through a K-tick decode megastep and a K-tick mixed
    one) with the span recorder and tick ledger on, then write
    trace.json.gz, ledger.json (priced base step and card stamped),
    calibration.json and reqlog.jsonl into `out`. Returns the summary
    `smoke` prints. The reference serves the first two only; a fused
    tick's wall differs from a one-tick step's on the card (each fused
    tick is enqueued from the host), so its scale has to be measured."""
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.obs import reqlog as reqlog_mod
    from flexflow_tpu_torch.obs.calibrate import (
        calibration_report,
        stamp_ledger_meta,
    )

    os.makedirs(out, exist_ok=True)
    kw = dict(slots=2, max_len=48, page_size=8)
    kw.update(server_kwargs or {})
    rec = obs.enable()
    reqlog_records: List[dict] = []

    def serve(spec=None, **knobs):
        server = ff.serve_generation(paged=True, speculate=spec,
                                     **dict(kw, **knobs))
        try:
            futs = [server.submit(p, max_new_tokens=max_new)
                    for p in prompts]
            for f in futs:
                f.result(timeout=600)
        finally:
            # the plain and speculative passes append to one reqlog.jsonl
            reqlog_records.extend(server.request_log.records())
            server.stop()

    try:
        serve()  # plain paged: decode + prefill tick shapes
        if speculate is not None:
            serve(speculate)  # verify tick shapes
        for ticks in megastep:
            if ticks > 1:  # fused decode|bN|wK shapes
                serve(megastep_ticks=ticks)
                serve(megastep_ticks=ticks, megastep_mixed=True)
    finally:
        obs.disable()

    stamp_ledger_meta(rec.ledger, ff, **meta)
    trace_path = rec.export_chrome_trace(os.path.join(out, "trace.json.gz"))
    ledger_path = rec.ledger.save(os.path.join(out, "ledger.json"))
    report = calibration_report(rec.ledger)
    calib_path = os.path.join(out, "calibration.json")
    with open(calib_path, "w") as f:
        json.dump(report, f, indent=1)
    reqlog_path = os.path.join(out, "reqlog.jsonl")
    n_logged = reqlog_mod.dump_jsonl(reqlog_path, reqlog_records)
    return {
        "trace": trace_path,
        "ledger": ledger_path,
        "calibration": calib_path,
        "reqlog": reqlog_path,
        "reqlog_records": n_logged,
        "schema_version": report["version"],
        "created_at": report["created_at"],
        "card": report["meta"]["card"],
        "events": len(rec.events),
        "requests": len(rec.requests),
        "shapes": sorted(report["tick_scales"]),
        "phases": {k: round(v, 3) for k, v in report["phases"].items()},
    }


def cmd_smoke(args) -> int:
    import numpy as np

    from flexflow_tpu_torch.spec import SpecConfig

    ff = build_tiny_ff(args.device)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, TINY_VOCAB, (rs.randint(4, 13),))
               .astype(np.int32) for _ in range(args.requests)]
    summary = traced_serve(
        ff, prompts, args.out, max_new=args.max_new,
        speculate=SpecConfig(width=2, depth=3) if args.speculate else None,
        megastep=args.megastep, fixture="fftrace smoke")
    print(json.dumps(summary))
    return 0


def cmd_replay(args) -> int:
    import time

    import numpy as np

    from flexflow_tpu_torch.obs.slo import percentile
    from flexflow_tpu_torch.search.traffic import RecordedProfile

    profile = RecordedProfile.from_reqlog(args.log)

    def _stats(records):
        ttfts = [(r["first_token_ns"] - r["submit_ns"]) / 1e9
                 for r in records]
        queues = [max(0.0, (r["admit_ns"] - r["submit_ns"]) / 1e9)
                  for r in records]
        makespan = (max(r["done_ns"] for r in records)
                    - min(r["submit_ns"] for r in records)) / 1e9
        toks = sum(int(r.get("decode_tokens", 0)) for r in records)
        return {
            "requests": len(records),
            "ttft_p50_s": percentile(ttfts, 0.5),
            "ttft_p95_s": percentile(ttfts, 0.95),
            "queue_p50_s": percentile(queues, 0.5),
            "queue_p95_s": percentile(queues, 0.95),
            "decode_tokens": toks,
            "tokens_per_s": toks / makespan if makespan > 0 else 0.0,
        }

    delta_keys = ("ttft_p50_s", "ttft_p95_s", "queue_p50_s",
                  "queue_p95_s", "tokens_per_s")
    recorded = _stats(profile.records)
    ff = build_tiny_ff(args.device)
    speculate = None
    if profile.measured_acceptance() is not None:
        # the log drafted, so the replay drafts: same server family
        from flexflow_tpu_torch.spec import SpecConfig

        speculate = SpecConfig(width=2, depth=3)

    def _serve(pace):
        """One replay pass: pace=None submits in recorded ORDER only (a
        burst); a float sleeps the recorded interarrival deltas divided
        by that speedup, so the percentiles are measured under the
        recorded arrival process."""
        rs = np.random.RandomState(args.seed)
        sampled = profile.sample(rs, vocab=TINY_VOCAB)
        server = ff.serve_generation(
            slots=args.slots, max_len=args.max_len, paged=True,
            page_size=args.page_size, speculate=speculate)
        try:
            budgets = profile.new_tokens_per_request
            submit_ns = [r["submit_ns"] for r in profile.records]
            futs = []
            for i, p in enumerate(sampled.prompts):
                if pace and i > 0:
                    delta = (submit_ns[i % len(submit_ns)]
                             - submit_ns[(i - 1) % len(submit_ns)])
                    if delta > 0:
                        time.sleep(delta / 1e9 / pace)
                futs.append(server.submit(
                    p, max_new_tokens=budgets[i % len(budgets)]))
            for f in futs:
                f.result(timeout=600)
            return _stats(server.request_log.records())
        finally:
            server.stop()

    replayed = _serve(None)
    doc = {
        "log": args.log,
        "profile": profile.name,
        "speculate": speculate is not None,
        "recorded": recorded,
        "replayed": replayed,
        "delta": {k: replayed[k] - recorded[k] for k in delta_keys},
    }
    if args.pace is not None:
        paced = _serve(args.pace)
        doc["paced"] = {
            "speedup": args.pace,
            "replayed": paced,
            "delta": {k: paced[k] - recorded[k] for k in delta_keys},
        }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "replay_report.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        doc["report"] = path
    print(json.dumps(doc))
    return 0


def cmd_calibrate(args) -> int:
    from flexflow_tpu_torch.obs.calibrate import calibration_report
    from flexflow_tpu_torch.obs.ledger import TickLedger

    led = TickLedger.load(args.ledger)
    try:
        report = calibration_report(led)
    except ValueError as e:
        print(f"fftrace calibrate: {e}", file=sys.stderr)
        return 2
    doc = json.dumps(report, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
        print(args.out)
    else:
        print(doc)
    return 0


def cmd_summarize(args) -> int:
    opener = gzip.open if args.trace.endswith(".gz") else open
    with opener(args.trace, "rt") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    by_name = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev["name"].split(":", 1)[0]  # collapse per-request labels
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + float(ev.get("dur", 0.0)))
    width = max((len(n) for n in by_name), default=4)
    print(f"{'span':<{width}}  {'count':>6}  {'total_ms':>10}  {'mean_us':>9}")
    for name, (n, total) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1]):
        print(f"{name:<{width}}  {n:>6}  {total / 1e3:>10.2f}  "
              f"{total / n:>9.1f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fftrace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sm = sub.add_parser("smoke", help="traced tiny-model serving run")
    sm.add_argument("--out", default="fftrace_out")
    sm.add_argument("--requests", type=int, default=4)
    sm.add_argument("--max-new", type=int, default=8)
    sm.add_argument("--no-speculate", dest="speculate", action="store_false")
    sm.add_argument("--megastep", type=int, nargs="*", default=[],
                    help="also serve K-tick decode and mixed megasteps")
    sm.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sm.set_defaults(func=cmd_smoke, speculate=True)

    rp = sub.add_parser("replay", help="re-serve a recorded request log")
    rp.add_argument("log", help="reqlog JSONL export (fftrace smoke / "
                                "server.request_log.export_jsonl)")
    rp.add_argument("--out", default=None,
                    help="also write replay_report.json into this dir")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--slots", type=int, default=2)
    rp.add_argument("--max-len", type=int, default=48)
    rp.add_argument("--page-size", type=int, default=8)
    rp.add_argument("--pace", nargs="?", const=1.0, type=float,
                    default=None, metavar="SPEEDUP",
                    help="ALSO run a paced replay sleeping the recorded "
                         "interarrival deltas (divided by SPEEDUP)")
    rp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    rp.set_defaults(func=cmd_replay)

    ca = sub.add_parser("calibrate", help="predicted-vs-measured report")
    ca.add_argument("ledger")
    ca.add_argument("--out", default=None)
    ca.set_defaults(func=cmd_calibrate)

    su = sub.add_parser("summarize", help="per-span totals of a trace")
    su.add_argument("trace")
    su.set_defaults(func=cmd_summarize)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
