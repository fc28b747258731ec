"""The port's tick simulator held to the JAX package's on the CPU: the
same arrival sequence (recorded and synthetic), the same SimResult
timeline at a fixed seed (rel 1e-12) over strategies that take every
branch of the walk (chunked and unpacked prefill, megasteps, the
universal megastep, speculation, preemption under pool pressure, the
host tier's spills and fetches), the same winner of the ticksim-backed
search, the same closed-form fallback without an arrival trace; then the
two command-line tools round-tripped on the CPU (fftrace smoke ->
calibrate -> servesearch search --replay --sim -> explain -> apply ->
simulate)."""

import json
import logging
import os
import subprocess
import sys

import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu.search import cost_model as jcm  # noqa: E402
from flexflow_tpu.search import machine_model as jmm  # noqa: E402
from flexflow_tpu.search import servesearch as jss  # noqa: E402
from flexflow_tpu.search import ticksim as jts  # noqa: E402
from flexflow_tpu.search import traffic as jtraffic  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models import llama  # noqa: E402
from flexflow_tpu_torch.obs.ledger import parse_shape_key  # noqa: E402
from flexflow_tpu_torch.search import cost_model as cm  # noqa: E402
from flexflow_tpu_torch.search import machine_model as mm  # noqa: E402
from flexflow_tpu_torch.search import servesearch as ss  # noqa: E402
from flexflow_tpu_torch.search import ticksim as ts  # noqa: E402
from flexflow_tpu_torch.search import traffic  # noqa: E402
from flexflow_tpu_torch.tools import fftrace  # noqa: E402
from flexflow_tpu_torch.tools import servesearch as servesearch_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMELINE_RTOL = 1e-12
PRICE_RTOL = 1e-9


def _layout(mod):
    return mod.PricedLayout(axis_sizes={}, strategy={}, step_s=1e-3,
                            base_tokens=256, mem_bytes=1e6,
                            kv_token_bytes=512, mode="test",
                            kv_token_elems=128, kv_scale_elems=16)


def _rec(i, sub_s, prompt, decode, chain=()):
    return {"rid": i, "submit_ns": int(sub_s * 1e9),
            "first_token_ns": int((sub_s + 0.1) * 1e9),
            "done_ns": int((sub_s + 0.2 + 0.05 * decode) * 1e9),
            "prompt_tokens": prompt, "decode_tokens": decode,
            "cached_prefill_tokens": 8 if chain else 0,
            "prefill_tokens": prompt - (8 if chain else 0),
            "prefix_chain": list(chain), "page_size": 8,
            "spec_draft_tokens": 4, "spec_accepted_tokens": 2}


# bursts of shared-prefix and private requests, then a trickle: pool
# pressure preempts and spills
RECORDS = ([_rec(i, 0.0, 12 + i, 6 + i % 3, ("sys",)) for i in range(6)]
           + [_rec(6 + i, 0.002 * i, 30 + 3 * i, 9) for i in range(4)]
           + [_rec(10 + i, 0.05 + 0.01 * i, 20, 5, ("sys",))
              for i in range(4)])
# the shared prefix's requests, private ones that push it out of the
# pool, then the prefix again a second later: a host tier fetches it back
TIER_RECORDS = ([_rec(i, 0.0, 12 + i, 6 + i % 3, ("sys",))
                 for i in range(3)]
                + [_rec(3 + i, 0.02 + 0.002 * i, 30 + 3 * i, 9)
                   for i in range(6)]
                + [_rec(9 + i, 1.0 + 0.01 * i, 20, 5, ("sys",))
                   for i in range(3)])

SIM_STRATEGIES = [
    {"page_size": 8, "prefill_chunk": 16},
    {"page_size": 8, "prefill_chunk": 16, "ragged_pack": False},
    {"page_size": 16, "prefill_chunk": 32, "megastep_ticks": 8},
    {"page_size": 8, "prefill_chunk": 16, "megastep_ticks": 4,
     "megastep_mixed": True, "overlap_dispatch": True},
    {"page_size": 8, "prefill_chunk": 16, "megastep_ticks": 4,
     "megastep_mixed": True, "spec_width": 2, "spec_depth": 2},
    {"page_size": 8, "prefill_chunk": 32, "spec_width": 2,
     "spec_depth": 4},
    {"page_size": 8, "prefill_chunk": 16, "pool_fraction": 0.25,
     "host_tier_pages": 12},
    {"page_size": 8, "prefill_chunk": 16, "pool_fraction": 0.5,
     "host_tier_pages": 64},
    {"page_size": 8, "prefill_chunk": 16, "pool_fraction": 0.25},
]


def _assert_close(a, b, rtol, where=""):
    """Equal structure; floats to rtol, everything else exactly."""
    if isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _assert_close(a[k], b[k], rtol, f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, rtol, f"{where}[{i}]")
    elif isinstance(b, float):
        assert a == pytest.approx(b, rel=rtol, abs=0.0), where
    else:
        assert a == b, where


@pytest.mark.parametrize("records", [RECORDS, TIER_RECORDS, None],
                         ids=["bursty", "tiered", "synthetic"])
def test_simulator_timeline_matches_the_reference(records):
    """TickSimulator.simulate at seed 0 and 3: the same per-request
    timelines, tick count, preemptions, spills and fetches and merged
    metrics as the reference's, for every strategy above, on two
    recorded logs (two slots, so requests queue; the bursty one
    preempts and spills, the tiered one fetches a spilled prefix back)
    and on a synthetic profile (all at t=0)."""
    recorded = records is not None
    if recorded:
        jp = jtraffic.RecordedProfile(records, name="recorded")
        tp = traffic.RecordedProfile(records, name="recorded")
    else:
        jp = jtraffic.get_profile("shared-system-prompt", requests=9)
        tp = traffic.get_profile("shared-system-prompt", requests=9)
    assert ts.has_arrival_trace(tp) == jts.has_arrival_trace(jp) == recorded
    jpr = jss.ServePricer([_layout(jss)], jp.prompt_stats(), slots=2,
                          max_len=64, acceptance_rate=0.5)
    tpr = ss.ServePricer([_layout(ss)], tp.prompt_stats(), slots=2,
                         max_len=64, acceptance_rate=0.5)
    seen = {"preempt": 0, "spill": 0, "fetch": 0}
    # the pool-pressure strategies only against the recorded logs: two
    # slots of a quarter pool cannot hold the synthetic burst's prompts
    for kw in SIM_STRATEGIES if recorded else SIM_STRATEGIES[:6]:
        for seed in (0, 3):
            ja = [vars(r) for r in jts.arrivals_from_profile(
                jp, seed=seed, max_len=64)]
            ta = [vars(r) for r in ts.arrivals_from_profile(
                tp, seed=seed, max_len=64)]
            assert ta == ja
            j = jts.TickSimulator(jpr).simulate(jss.ServeStrategy(**kw), jp,
                                                seed=seed)
            t = ts.TickSimulator(tpr).simulate(ss.ServeStrategy(**kw), tp,
                                               seed=seed)
            assert all(r["done_s"] is not None for r in t.records)
            _assert_close(t.timeline_json(), j.timeline_json(),
                          TIMELINE_RTOL, str(kw))
            seen["preempt"] += t.preemptions
            seen["spill"] += t.metrics["sim_spilled_pages"]
            seen["fetch"] += t.metrics["sim_fetched_pages"]
    if records is RECORDS:
        assert seen["preempt"] > 0 and seen["spill"] > 0, seen
    if records is TIER_RECORDS:
        assert seen["fetch"] > 0, seen


def test_simulator_fails_where_the_reference_fails():
    """A known defect kept for parity (ROADMAP.md open items): when an
    admission's own page budget reclaims the resident prefix it is about
    to attach, the reference's walk raises KeyError on the attach; the
    port's copy raises the same error at the same point."""
    errs = []
    for mod, tmod in ((jss, jtraffic), (ss, traffic)):
        prof = tmod.get_profile("shared-system-prompt", requests=9)
        pricer = mod.ServePricer([_layout(mod)], prof.prompt_stats(),
                                 slots=2, max_len=64, acceptance_rate=0.5)
        sim = (jts if mod is jss else ts).TickSimulator(pricer)
        with pytest.raises(KeyError) as e:
            sim.simulate(mod.ServeStrategy(page_size=8, prefill_chunk=16,
                                           pool_fraction=0.25), prof, seed=0)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.fixture(scope="module")
def graphs():
    kw = dict(vocab_size=512, dim=64, layers=2, heads=4, kv_heads=2,
              hidden=128, rope_theta=10000.0)
    jff = JFFModel(JFFConfig(batch_size=4, num_devices=1))
    jllama.build_llama(jff, jllama.LlamaConfig(**kw), batch_size=4,
                       seq_len=64, dtype=JDataType.FLOAT)
    jff.graph.infer_shapes()
    ff = FFModel(FFConfig(batch_size=4, device="cpu"))
    llama.build_llama(ff, llama.LlamaConfig(**kw), batch_size=4,
                      seq_len=64, dtype=DataType.FLOAT)
    ff.graph.infer_shapes()
    return jff.graph, ff.graph


def _costs():
    axes = {"data": 2, "model": 4}
    return (jcm.CostModel(jmm.TPUMachineModel.make("v5e", 8), dict(axes)),
            cm.CostModel(mm.TPUMachineModel.make("v5e", 8), dict(axes)))


def test_ticksim_search_matches_the_reference(graphs, caplog):
    """search_serve_strategy(sim=True, seed=0, budget=24) on a recorded
    log scores with the simulator in both packages and picks the same
    best, at the same value (rel 1e-9); on a named profile (no arrival
    trace) both fall back to the closed form with a warning and pick the
    closed-form winner."""
    jg, tg = graphs
    kw = dict(budget=24, seed=0, slots=4, max_len=128, sim=True)
    jc, tc = _costs()
    j = jss.search_serve_strategy(
        graph=jg, cost=jc, traffic=jtraffic.RecordedProfile(RECORDS), **kw)
    t = ss.search_serve_strategy(
        graph=tg, cost=tc, traffic=traffic.RecordedProfile(RECORDS), **kw)
    assert t.backend == j.backend == "ticksim"
    assert t.best.to_json() == j.best.to_json()
    assert t.best_objective == pytest.approx(j.best_objective,
                                             rel=PRICE_RTOL)
    assert t.default_objective == pytest.approx(j.default_objective,
                                                rel=PRICE_RTOL)
    assert t.acceptance == j.acceptance
    assert t.acceptance["source"] == "measured"
    with caplog.at_level(logging.WARNING):
        fb = ss.search_serve_strategy(graph=tg, cost=_costs()[1],
                                      traffic="smoke", **kw)
    assert "falling back to the closed-form" in caplog.text
    plain = ss.search_serve_strategy(graph=tg, cost=_costs()[1],
                                     traffic="smoke",
                                     **dict(kw, sim=False))
    assert fb.backend == plain.backend == "closed-form"
    assert fb.best == plain.best


def test_cli_round_trip_on_the_cpu(tmp_path, capsys):
    """fftrace smoke (--device cpu, with 4-tick decode and mixed
    megasteps) -> calibrate -> servesearch search
    --replay --sim --calibration -> explain -> apply --serve-smoke ->
    simulate, and fftrace summarize, in process; `python -m` runs a
    tool as a module."""
    out = str(tmp_path / "ft")

    def run(main, argv):
        assert main(argv) == 0
        return capsys.readouterr().out

    smoke = json.loads(run(fftrace.main, [
        "smoke", "--device", "cpu", "--out", out, "--requests", "3",
        "--max-new", "4", "--megastep", "4"]).splitlines()[-1])
    assert smoke["card"] == "cpu" and smoke["reqlog_records"] == 12
    assert any(s.startswith("verify|") for s in smoke["shapes"])
    assert any(s.startswith("decode|") and parse_shape_key(s)["width"] > 1
               for s in smoke["shapes"])
    cal_path = str(tmp_path / "cal.json")
    run(fftrace.main, ["calibrate", smoke["ledger"], "--out", cal_path])
    with open(cal_path) as f:
        report = json.load(f)
    assert report["meta"]["card"] == "cpu" and report["tick_scales"]
    assert "queued" in run(fftrace.main, ["summarize", smoke["trace"]])
    res_path = str(tmp_path / "res.json")
    summary = json.loads(run(servesearch_cli.main, [
        "search", "--device", "cpu", "--replay", smoke["reqlog"], "--sim",
        "--budget", "12", "--max-len", "48", "--slots", "2",
        "--calibration", cal_path, "--out", res_path]).splitlines()[-1])
    assert summary["backend"] == "ticksim"
    assert summary["calibration"]["used"] and \
        summary["calibration"]["card"] == "cpu"
    text = run(servesearch_cli.main, ["explain", res_path])
    assert "measured on cpu" in text and "not measured" in text
    strat_path = str(tmp_path / "strategy.json")
    applied = json.loads(run(servesearch_cli.main, [
        "apply", res_path, "--device", "cpu", "--serve-smoke", "--out",
        strat_path]).splitlines()[-1])
    assert applied["serve_smoke"] == "token-identical"
    sim = json.loads(run(servesearch_cli.main, [
        "simulate", smoke["reqlog"], "--device", "cpu", "--strategy",
        strat_path, "--max-len", "48", "--slots", "2"]).splitlines()[-1])
    assert sim["requests"] == 12 and sim["sim_ttft_p95_s"] > 0
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.tools.servesearch",
         "explain", res_path], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "improvement over default" in proc.stdout
