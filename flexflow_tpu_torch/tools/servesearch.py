"""servesearch — search / simulate / explain / apply serving strategies
(search/servesearch.py), counterpart of the reference's
tools/servesearch.py.

    python -m flexflow_tpu_torch.tools.servesearch <command> ...

Subcommands:

  search [--profile NAME | --replay REQLOG.jsonl] [--budget N]
         [--seed S] [--slots K] [--max-len L] [--calibration REPORT.json]
         [--hbm-budget BYTES] [--acceptance-rate A]
         [--mesh-layouts SPEC] [--inner-budget M] [--sim] [--out FILE]
         [--device cuda|cpu]
      Build the tiny smoke model and run the serving-strategy search on
      the H100 machine model against the named traffic profile (smoke,
      shared-system-prompt, mixed-length, long-context-summarization,
      agentic-multiturn) — or, with --replay, against a RECORDED request
      log, whose prompt moments, prefix share, arrival process and spec
      acceptance are then measured (search/traffic.py RecordedProfile).
      Writes the full result JSON (--out) and prints a one-line summary
      last. A fresh `fftrace calibrate` report sharpens the tick prices;
      a stale one is refused with a warning. --mesh-layouts takes
      "data=8;data=2,model=4": candidate serving meshes, each shard-
      searched by the MCMC driver for --inner-budget iterations (priced
      only: serving a mesh of more than one card raises). --sim (with
      --replay) scores every candidate with the event-driven tick
      simulator (search/ticksim.py) instead of the closed form.

  simulate REQLOG.jsonl [--strategy STRATEGY.json] [--slots K]
           [--max-len L] [--seed S] [--calibration REPORT.json]
           [--out TIMELINE.json] [--device cuda|cpu]
      Replay a recorded request log through the tick simulator under one
      strategy: per-request TTFT/queue/decode timelines (--out), burst-
      aware p50/p95, and the closed-form TTFT p95 beside them.

  explain RESULT.json
      Human-readable breakdown of a search result: the winning knobs,
      each objective term (TTFT / throughput / HBM penalty) for the
      searched and default strategies, and the priced tick metrics
      behind them. The reference's compile_cost line (launch-shape
      catalog size x measured seconds a compile) reports "not measured":
      the port has no compile tracker or shape catalog yet.

  apply RESULT.json [--out FILE] [--serve-smoke] [--device cuda|cpu]
      Emit the winning strategy as the JSON `serve_generation(
      serve_strategy=...)` loads. --serve-smoke builds the tiny model,
      serves a few prompts under the strategy and asserts token identity
      with generate().

Pricing needs no device, but the commands that build the model build it
on `--device` (the card by default; `--device cpu` for a machine without
one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from flexflow_tpu_torch.tools.fftrace import TINY_VOCAB, build_tiny_ff


def _parse_layouts(spec):
    """'data=8;data=2,model=4' -> [{'data': 8}, {'data': 2, 'model': 4}]"""
    if not spec:
        return None
    layouts = []
    for part in spec.split(";"):
        axes = {}
        for kv in part.split(","):
            k, v = kv.split("=")
            axes[k.strip()] = int(v)
        layouts.append(axes)
    return layouts


def cmd_search(args) -> int:
    from flexflow_tpu_torch.search.servesearch import (
        ServeObjective,
        search_serve_strategy,
    )

    traffic = args.profile
    if args.replay:
        from flexflow_tpu_torch.search.traffic import RecordedProfile

        traffic = RecordedProfile.from_reqlog(args.replay)
    ff = build_tiny_ff(args.device)
    objective = None
    if args.hbm_budget is not None:
        objective = ServeObjective(hbm_budget_bytes=float(args.hbm_budget))
    res = search_serve_strategy(
        ff, traffic=traffic, budget=args.budget, seed=args.seed,
        slots=args.slots, max_len=args.max_len, objective=objective,
        calibration=args.calibration, acceptance_rate=args.acceptance_rate,
        layouts=_parse_layouts(args.mesh_layouts),
        inner_budget=args.inner_budget, sim=args.sim)
    doc = res.to_json()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    print(json.dumps({
        "profile": res.traffic,
        "backend": res.backend,
        "best": res.best.describe(),
        "best_objective": res.best_objective,
        "default_objective": res.default_objective,
        "improvement": round(res.improvement, 4),
        "trials": res.trials,
        "calibration": res.calibration,
        "acceptance": res.acceptance,
        "arrival": res.arrival,
        "out": args.out,
    }))
    return 0


def load_strategy(path, max_len: int):
    """The strategy a --strategy file names (a bare strategy JSON, or a
    full search result whose `best` it is), or the serve_generation
    default knobs clamped to the serving window."""
    from flexflow_tpu_torch.search.servesearch import ServeStrategy

    if not path:
        s = ServeStrategy()
        return dataclasses.replace(
            s, page_size=min(s.page_size, max_len),
            prefill_chunk=min(s.prefill_chunk, max_len))
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc.get("best"), dict):
        doc = doc["best"]
    return ServeStrategy.from_json(doc)


def simulate(ff, reqlog, strategy, *, slots: int, max_len: int,
             seed: int = 0, calibration=None):
    """(SimResult, closed-form metrics) of `strategy` replaying the
    request log `reqlog` (a path, a RequestLog or records) on ff's
    priced step."""
    from flexflow_tpu_torch.search.servesearch import build_pricer
    from flexflow_tpu_torch.search.ticksim import TickSimulator
    from flexflow_tpu_torch.search.traffic import RecordedProfile

    profile = RecordedProfile.from_reqlog(reqlog)
    pricer = build_pricer(ff, traffic=profile, slots=slots,
                          max_len=max_len, calibration=calibration)
    sim = TickSimulator(pricer).simulate(strategy, profile, seed=seed)
    return sim, pricer.metrics(strategy)


def cmd_simulate(args) -> int:
    strategy = load_strategy(args.strategy, args.max_len)
    ff = build_tiny_ff(args.device)
    sim, closed = simulate(ff, args.reqlog, strategy, slots=args.slots,
                           max_len=args.max_len, seed=args.seed,
                           calibration=args.calibration)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(sim.timeline_json(), f, indent=1, sort_keys=True)
    print(json.dumps({
        "reqlog": args.reqlog,
        "strategy": strategy.describe(),
        "requests": len(sim.records),
        "ticks": sim.ticks,
        "preemptions": sim.preemptions,
        "makespan_s": round(sim.makespan_s, 6),
        "sim_ttft_p95_s": round(sim.metrics["ttft_p95_s"], 6),
        "sim_queue_p95_s": round(sim.metrics["queue_p95_s"], 6),
        "sim_tokens_per_s": round(sim.metrics["tokens_per_s"], 2),
        "closed_form_ttft_p95_s": round(closed["ttft_p95_s"], 6),
        "out": args.out,
    }))
    return 0


def _fmt_metrics(m) -> str:
    return (f"    TTFT p95         {m['ttft_p95_s'] * 1e3:10.4f} ms\n"
            f"    tokens/sec       {m['tokens_per_s']:10.1f}\n"
            f"    HBM resident     {m['hbm_bytes'] / 1e6:10.2f} MB "
            f"({m['pool_pages']:.0f} pool pages, "
            f"occupancy {m['pool_occupancy']:.2f})\n"
            f"    padding waste    {m['padding_waste_ratio']:10.3f}\n"
            f"    roundtrips/token {m['host_roundtrips_per_token']:10.3f}\n"
            f"    accepted/step    {m['expected_accepted_per_step']:10.2f}, "
            f"fused ticks {m['expected_fused_ticks']:.2f}")


def cmd_explain(args) -> int:
    from flexflow_tpu_torch.search.servesearch import ServeSearchResult

    with open(args.result) as f:
        res = ServeSearchResult.from_json(json.load(f))
    print(f"profile: {res.traffic}  (slots={res.slots}, "
          f"max_len={res.max_len}, budget={res.budget}, seed={res.seed}, "
          f"{res.trials} strategies priced)")
    cal = res.calibration
    if cal and cal.get("used"):
        print(f"calibration: fftrace report v{cal.get('version')} from "
              f"{cal.get('created_at')} ({cal.get('shapes')} tick shapes, "
              f"measured on {cal.get('card')})")
    elif cal:
        print(f"calibration: NOT used ({cal.get('reason')})")
    else:
        print("calibration: none supplied (analytic tick prices)")
    for lay in res.layouts:
        print(f"layout {lay['mesh']}: step {lay['step_s'] * 1e3:.4f} ms "
              f"({lay['pricing_mode']}), kv {lay['kv_token_bytes']} B/token")
    for label, strat, obj, m in (
            ("searched", res.best, res.best_objective, res.best_metrics),
            ("default ", res.default, res.default_objective,
             res.default_metrics)):
        terms = res.objective.breakdown(m)
        print(f"\n{label}: {strat.describe()}")
        print(f"  objective {obj:.6f}  =  ttft {terms['ttft_term']:.6f} "
              f"+ throughput {terms['throughput_term']:.6f} "
              f"+ hbm penalty {terms['hbm_penalty']:.6f}")
        print(_fmt_metrics(m))
        print("    compile_cost     not measured (no compile tracker)")
    print(f"\nimprovement over default: {res.improvement * 100:.1f}%")
    return 0


def cmd_apply(args) -> int:
    from flexflow_tpu_torch.search.servesearch import ServeSearchResult

    with open(args.result) as f:
        res = ServeSearchResult.from_json(json.load(f))
    strategy = res.best.to_json()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(strategy, f, indent=1, sort_keys=True)
    if args.serve_smoke:
        import numpy as np

        ff = build_tiny_ff(args.device)
        rs = np.random.RandomState(0)
        prompts = [rs.randint(0, TINY_VOCAB, (n,)).astype(np.int32)
                   for n in (3, 11, 5)]
        want = [ff.generate(p[None, :], max_new_tokens=4)[0]
                for p in prompts]
        server = ff.serve_generation(slots=res.slots, max_len=res.max_len,
                                     serve_strategy=strategy)
        try:
            futs = [server.submit(p, max_new_tokens=4) for p in prompts]
            got = [f.result(timeout=600) for f in futs]
        finally:
            server.stop()
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
    print(json.dumps({
        "serve_strategy": strategy,
        "describe": res.best.describe(),
        "out": args.out,
        "serve_smoke": "token-identical" if args.serve_smoke else None,
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="servesearch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    se = sub.add_parser("search", help="search the serving-strategy space")
    se.add_argument("--profile", default="smoke")
    se.add_argument("--replay", default=None, metavar="REQLOG_JSONL",
                    help="score against a recorded request log (overrides "
                         "--profile; supplies measured prompt/arrival/"
                         "acceptance stats)")
    se.add_argument("--budget", type=int, default=200)
    se.add_argument("--seed", type=int, default=0)
    se.add_argument("--slots", type=int, default=4)
    se.add_argument("--max-len", type=int, default=64)
    se.add_argument("--calibration", default=None,
                    help="fftrace calibrate report (<= 7 days old)")
    se.add_argument("--hbm-budget", type=float, default=None,
                    help="HBM budget in bytes (default: the machine model)")
    se.add_argument("--acceptance-rate", type=float, default=None,
                    help="spec acceptance prior (default: measured from "
                         "--replay's log when it drafted, else 0.6)")
    se.add_argument("--mesh-layouts", default=None,
                    help='candidate meshes, e.g. "data=8;data=2,model=4"')
    se.add_argument("--inner-budget", type=int, default=0,
                    help="mcmc budget per candidate mesh layout")
    se.add_argument("--sim", action="store_true",
                    help="score candidates with the event-driven tick "
                         "simulator replaying --replay's arrivals (falls "
                         "back to the closed form with a warning without "
                         "one)")
    se.add_argument("--out", default=None)
    se.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    se.set_defaults(func=cmd_search)

    si = sub.add_parser("simulate",
                        help="replay a recorded reqlog through the "
                             "event-driven tick simulator")
    si.add_argument("reqlog", metavar="REQLOG_JSONL")
    si.add_argument("--strategy", default=None,
                    help="strategy JSON to simulate (servesearch apply "
                         "--out, or a full search result); default: the "
                         "serve_generation default knobs")
    si.add_argument("--slots", type=int, default=4)
    si.add_argument("--max-len", type=int, default=64)
    si.add_argument("--seed", type=int, default=0)
    si.add_argument("--calibration", default=None,
                    help="fftrace calibrate report (<= 7 days old)")
    si.add_argument("--out", default=None, metavar="TIMELINE_JSON")
    si.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    si.set_defaults(func=cmd_simulate)

    ex = sub.add_parser("explain", help="break down a search result")
    ex.add_argument("result")
    ex.set_defaults(func=cmd_explain)

    apl = sub.add_parser("apply", help="emit the winning strategy JSON")
    apl.add_argument("result")
    apl.add_argument("--out", default=None)
    apl.add_argument("--serve-smoke", action="store_true",
                     help="serve the strategy on the tiny model and "
                          "assert token identity with generate()")
    apl.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    apl.set_defaults(func=cmd_apply)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
