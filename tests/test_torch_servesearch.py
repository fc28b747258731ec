"""The port's serving-strategy search held to the JAX package's on the
CPU: traffic profiles (samples and stats, exact), ServeStrategy's JSON
form, fingerprint and validation (exact, errors alike), ServePricer's
metrics on the same graph and machine model (rel 1e-9), the search's
winner and value (rel 1e-9), the calibration report and the priced base
step (rel 1e-9), calibration freshness, and a searched strategy served
token for token like the JAX package's server. Graphs come from each
package's own builders with the same calls; the machine priced in the
parity legs is the reference's TPU model, which the port keeps for
exactly this (search/machine_model.py)."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu.obs import calibrate as jcal  # noqa: E402
from flexflow_tpu.obs.ledger import TickLedger as JTickLedger  # noqa: E402
from flexflow_tpu.obs import reqlog as jreqlog  # noqa: E402
from flexflow_tpu.search import cost_model as jcm  # noqa: E402
from flexflow_tpu.search import machine_model as jmm  # noqa: E402
from flexflow_tpu.search import servesearch as jss  # noqa: E402
from flexflow_tpu.search import traffic as jtraffic  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models import llama  # noqa: E402
from flexflow_tpu_torch.obs import calibrate as cal  # noqa: E402
from flexflow_tpu_torch.obs.ledger import TickLedger  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.search import api  # noqa: E402
from flexflow_tpu_torch.search import cost_model as cm  # noqa: E402
from flexflow_tpu_torch.search import machine_model as mm  # noqa: E402
from flexflow_tpu_torch.search import servesearch as ss  # noqa: E402
from flexflow_tpu_torch.search import traffic  # noqa: E402

# the same formulas on the same numbers
PRICE_RTOL = 1e-9
TINY = dict(vocab_size=512, dim=64, layers=2, heads=4, kv_heads=2,
            hidden=128, rope_theta=10000.0)
AXES = {"data": 2, "model": 4}


@pytest.fixture(scope="module")
def graphs():
    """The same shape-inferred Llama graph (batch 4, seq 64) from each
    package, as the reference's own servesearch tests build it."""
    jff = JFFModel(JFFConfig(batch_size=4, num_devices=1))
    jllama.build_llama(jff, jllama.LlamaConfig(**TINY), batch_size=4,
                       seq_len=64, dtype=JDataType.FLOAT)
    jff.graph.infer_shapes()
    ff = FFModel(FFConfig(batch_size=4, device="cpu"))
    llama.build_llama(ff, llama.LlamaConfig(**TINY), batch_size=4,
                      seq_len=64, dtype=DataType.FLOAT)
    ff.graph.infer_shapes()
    return jff.graph, ff.graph


def costs(axes=AXES):
    return (jcm.CostModel(jmm.TPUMachineModel.make("v5e", 8), dict(axes)),
            cm.CostModel(mm.TPUMachineModel.make("v5e", 8), dict(axes)))


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model carrying the JAX weights): the tiny fp32
    GQA Llama (seed 7), compiled once for the module."""
    jff = JFFModel(JFFConfig(batch_size=1, seed=7))
    jllama.build_llama(jff, jllama.LlamaConfig(**TINY), batch_size=1,
                       seq_len=8, dtype=JDataType.FLOAT)
    jff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = FFModel(FFConfig(batch_size=1, seed=7, device="cpu"))
    llama.build_llama(tff, llama.LlamaConfig(**TINY), batch_size=1,
                      seq_len=8, dtype=DataType.FLOAT)
    jtr, jntr = jff._params
    tff.compile(params=params_from_numpy(
        {k: {n: np.asarray(a) for n, a in w.items()}
         for k, w in jtr.items()},
        {k: {n: np.asarray(a) for n, a in w.items()}
         for k, w in jntr.items()}, device="cpu"))
    return jff, tff


# ---------------------------------------------------------------------------
# traffic profiles: exact


def _record(i, sub_s, prompt, decode, chain, cached=0, drafted=0,
            accepted=0):
    return {"rid": i, "submit_ns": int(sub_s * 1e9),
            "admit_ns": int((sub_s + 0.01) * 1e9),
            "first_token_ns": int((sub_s + 0.1) * 1e9),
            "done_ns": int((sub_s + 0.2 + 0.03 * decode) * 1e9),
            "prompt_tokens": prompt, "decode_tokens": decode,
            "cached_prefill_tokens": cached,
            "prefill_tokens": prompt - cached, "prefix_chain": list(chain),
            "page_size": 4, "spec_draft_tokens": drafted,
            "spec_accepted_tokens": accepted}


RECORDS = [_record(0, 0.0, 9, 4, ("aa", "bb")),
           _record(1, 0.05, 12, 6, ("aa", "bb", "cc"), cached=8,
                   drafted=6, accepted=4),
           _record(2, 0.4, 10, 3, ("aa", "bb"), cached=8, drafted=3,
                   accepted=1)]


def _profile_pairs(tmp_path):
    for name in jtraffic.PROFILES:
        for kw in ({}, {"requests": 9, "new_tokens": 5}):
            yield (jtraffic.get_profile(name, **kw),
                   traffic.get_profile(name, **kw))
    path = str(tmp_path / "recorded.jsonl")
    jreqlog.dump_jsonl(path, RECORDS)
    yield (jtraffic.RecordedProfile.from_reqlog(path),
           traffic.RecordedProfile.from_reqlog(path))


def test_traffic_profiles_sample_and_stats_match_the_reference(tmp_path):
    """Every named profile (at its defaults and re-parameterized) and a
    RecordedProfile read from a request log: the same seeded samples,
    prompt_stats, arrival_stats, measured acceptance and names."""
    assert set(traffic.PROFILES) == set(jtraffic.PROFILES)
    n = 0
    for jp, tp in _profile_pairs(tmp_path):
        assert tp.name == jp.name
        assert tp.prompt_stats() == jp.prompt_stats()
        for seed in (0, 3):
            for req in (None, 7):
                js = jp.sample(np.random.RandomState(seed), 64, req)
                ts = tp.sample(np.random.RandomState(seed), 64, req)
                assert len(ts.prompts) == len(js.prompts)
                for a, b in zip(ts.prompts, js.prompts):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                if js.shared_prefix is None:
                    assert ts.shared_prefix is None
                else:
                    np.testing.assert_array_equal(ts.shared_prefix,
                                                  js.shared_prefix)
        if isinstance(jp, jtraffic.RecordedProfile):
            assert tp.arrival_stats() == jp.arrival_stats()
            assert tp.measured_acceptance() == jp.measured_acceptance()
            assert tp.new_tokens_per_request == jp.new_tokens_per_request
            assert tp.sample(np.random.RandomState(0), 64).shared_prefix \
                is not None
        n += 1
    assert n == 2 * len(jtraffic.PROFILES) + 1


def test_traffic_errors_raise_alike():
    for mod in (jtraffic, traffic):
        with pytest.raises(KeyError, match="unknown traffic profile"):
            mod.get_profile("chat")
        with pytest.raises(ValueError, match="at least one record"):
            mod.RecordedProfile([])
        with pytest.raises(ValueError, match="bad suffix range"):
            mod.TrafficProfile(name="x", description="", suffix_lens=((5, 5),))
        rec = mod.RecordedProfile(RECORDS)
        with pytest.raises(ValueError, match="measured"):
            mod.get_profile(rec, requests=2)


# ---------------------------------------------------------------------------
# ServeStrategy: exact


STRATEGIES = [
    {},
    {"page_size": 8, "prefill_chunk": 16},
    {"spec_width": 2, "spec_depth": 4, "kv_dtype": "int8"},
    {"megastep_ticks": 8, "megastep_mixed": True, "overlap_dispatch": True},
    {"pool_fraction": 0.25, "host_tier_pages": 1024, "ragged_pack": False},
    {"mesh": (("data", 2), ("model", 4)), "kv_dtype": "bf16"},
]
BAD = [
    {"page_size": 0}, {"prefill_chunk": 0}, {"megastep_ticks": 0},
    {"pool_fraction": 0.0}, {"pool_fraction": 1.5},
    {"host_tier_pages": -1}, {"spec_width": 2},
    {"overlap_dispatch": True},
    {"spec_width": 2, "spec_depth": 2, "megastep_ticks": 4},
    {"kv_dtype": "int4"}, {"page_size": 256},
]


def test_strategy_json_fingerprint_and_validate_match_the_reference():
    """to_json, from_json (of either package's JSON), fingerprint,
    describe and to_server_kwargs agree exactly; every invalid
    combination raises the same error with the same message."""
    for kw in STRATEGIES:
        j, t = jss.ServeStrategy(**kw), ss.ServeStrategy(**kw)
        assert json.dumps(t.to_json(), sort_keys=True) == json.dumps(
            j.to_json(), sort_keys=True)
        assert t.fingerprint() == j.fingerprint()
        assert t.describe() == j.describe()
        assert ss.ServeStrategy.from_json(j.to_json()) == t
        assert jss.ServeStrategy.from_json(t.to_json()) == j
        tk = t.to_server_kwargs(slots=4, max_len=128)
        jk = j.to_server_kwargs(slots=4, max_len=128)
        spec_t, spec_j = tk.pop("speculate"), jk.pop("speculate")
        assert tk == jk
        assert (spec_t is None) == (spec_j is None)
        if spec_t is not None:
            assert (spec_t.width, spec_t.depth, spec_t.max_nodes) == (
                spec_j.width, spec_j.depth, spec_j.max_nodes)
    for kw in BAD:
        errs = []
        for mod in (jss, ss):
            with pytest.raises(ValueError) as e:
                mod.ServeStrategy(**kw).validate(max_len=128)
            errs.append(str(e.value))
        assert errs[0] == errs[1], kw


# ---------------------------------------------------------------------------
# pricing and the search: rel 1e-9


def _grid(n=48, seed=0):
    """Strategies drawn from the searched space: every knob, valid
    combinations only, plus the second mesh layout."""
    space = ss.default_space(max_len=128)
    rs = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        kv = {k: v[rs.randint(len(v))] for k, v in space.items()}
        w, d = kv.pop("spec")
        mixed, overlap = kv.pop("fuse")
        mesh = (("data", 8),) if rs.randint(2) else ()
        kw = dict(kv, spec_width=w, spec_depth=d, megastep_mixed=mixed,
                  overlap_dispatch=overlap, mesh=mesh)
        try:
            ss.ServeStrategy(**kw).validate(max_len=128)
        except ValueError:
            continue
        out.append(kw)
    return out


def test_pricer_metrics_match_the_reference(graphs):
    """price_layouts on two mesh layouts (the compiled one and data=8,
    the DP default) gives the same step, memory and KV bills; then
    ServePricer.metrics agrees key for key at rel 1e-9 over a grid that
    covers every knob, for two profiles and with a tick-scale."""
    jg, tg = graphs
    jc, tc = costs()
    layouts = [dict(AXES), {"data": 8}]
    jl = jss.price_layouts(jg, jc, layouts)
    tl = ss.price_layouts(tg, tc, layouts)
    for a, b in zip(tl, jl):
        assert a.mode == b.mode == "eventsim"
        assert (a.base_tokens, a.kv_token_bytes, a.kv_token_elems,
                a.kv_scale_elems) == (b.base_tokens, b.kv_token_bytes,
                                      b.kv_token_elems, b.kv_scale_elems)
        assert a.step_s == pytest.approx(b.step_s, rel=PRICE_RTOL)
        assert a.mem_bytes == pytest.approx(b.mem_bytes, rel=PRICE_RTOL)
    grid = _grid()
    assert {k for kw in grid for k, v in kw.items()
            if v != getattr(ss.ServeStrategy(), k)} == {
        f.name for f in dataclasses.fields(ss.ServeStrategy)}
    scale = {"decode|*": 3.0, "prefill|*": 1.5, "verify|*": 2.0}
    for name in ("shared-system-prompt", "mixed-length"):
        stats = traffic.get_profile(name).prompt_stats()
        for tick_scale in (None, scale):
            fns = [None, None] if tick_scale is None else [
                lambda phase, *a, **k: tick_scale[f"{phase}|*"]] * 2
            jp = jss.ServePricer(jl, stats, slots=4, max_len=128,
                                 tick_scale=fns[0])
            tp = ss.ServePricer(tl, stats, slots=4, max_len=128,
                                tick_scale=fns[1])
            for kw in grid:
                jm = jp.metrics(jss.ServeStrategy(**kw))
                tm = tp.metrics(ss.ServeStrategy(**kw))
                assert set(tm) == set(jm)
                for k in jm:
                    assert tm[k] == pytest.approx(jm[k], rel=PRICE_RTOL), \
                        (kw, k)


@pytest.mark.parametrize("profile", ["smoke", "shared-system-prompt",
                                     "long-context-summarization"])
def test_search_winner_matches_the_reference(graphs, profile):
    """search_serve_strategy(seed=0, budget=24) on the closed-form
    backend: the same best strategy, value (rel 1e-9), default value and
    trial count; with two candidate layouts too."""
    jg, tg = graphs
    for layouts in (None, [dict(AXES), {"data": 8}]):
        jc, tc = costs()
        kw = dict(traffic=profile, budget=24, seed=0, slots=4,
                  max_len=128, layouts=layouts)
        j = jss.search_serve_strategy(graph=jg, cost=jc, **kw)
        t = ss.search_serve_strategy(graph=tg, cost=tc, **kw)
        assert t.backend == j.backend == "closed-form"
        assert t.best.to_json() == j.best.to_json()
        assert t.best.fingerprint() == j.best.fingerprint()
        assert t.best_objective == pytest.approx(j.best_objective,
                                                 rel=PRICE_RTOL)
        assert t.default_objective == pytest.approx(j.default_objective,
                                                    rel=PRICE_RTOL)
        assert t.trials == j.trials
        assert t.stats == j.stats and t.acceptance == j.acceptance


def test_port_prices_the_h100_by_default(models):
    """On a compiled port model the search prices the H100 machine (its
    80 GB are the pool's HBM budget) through the event simulator, and a
    mesh of more than one card is priced but refused for serving."""
    _, tff = models
    res = ss.search_serve_strategy(tff, traffic="smoke", budget=8, seed=0,
                                   slots=2, max_len=32)
    assert res.objective.hbm_budget_bytes == 80e9
    assert res.layouts[0]["pricing_mode"] == "eventsim"
    assert res.best.validate(max_len=32) is None
    two = ss.ServeStrategy(page_size=8, mesh=(("data", 2),))
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        tff.serve_generation(slots=2, max_len=32, serve_strategy=two)


# ---------------------------------------------------------------------------
# calibration


def _ledgers():
    out = []
    for cls in (JTickLedger, TickLedger):
        led = cls()
        rs = np.random.RandomState(1)
        for _ in range(40):
            led.record("decode", float(rs.uniform(1e-3, 3e-3)), batch=2)
            led.record("decode", float(rs.uniform(4e-3, 9e-3)), batch=2,
                       width=8)
            led.record("prefill", float(rs.uniform(2e-3, 5e-3)), batch=1,
                       chunk=16)
            led.record("verify", float(rs.uniform(3e-3, 6e-3)), batch=2,
                       width=7)
        led.meta.update(predicted_step_s=2.5e-4, graph_tokens=8,
                        pricing_mode="eventsim")
        out.append(led)
    return out


def test_calibration_report_matches_the_reference():
    """calibration_report of the same ledger samples: the same shapes,
    ratios, tick scales, phase medians and base, and a v2 stamp; the
    reports feed set_tick_calibration to the same tick scales."""
    from flexflow_tpu.search.measured import MeasuredCostModel as JMCM
    from flexflow_tpu_torch.search.measured import MeasuredCostModel

    jl, tl = _ledgers()
    jr, tr = jcal.calibration_report(jl), cal.calibration_report(tl)
    for k in ("version", "base", "meta", "shapes", "tick_scales", "phases"):
        assert tr[k] == jr[k], k
    assert tr["version"] == cal.CALIBRATION_SCHEMA_VERSION == 2
    jm = JMCM(jmm.TPUMachineModel.make("v5e", 1), {"data": 1})
    tm = MeasuredCostModel(mm.TPUMachineModel.make("v5e", 1), {"data": 1},
                           device="cpu")
    assert tm.set_tick_calibration(tr) == jm.set_tick_calibration(jr) == 4
    for shape in (("decode", 2), ("decode", 2, 0, 8), ("prefill", 1, 16),
                  ("verify", 3, 0, 7), ("decode", 5)):
        assert tm.tick_scale(*shape) == jm.tick_scale(*shape)
    with pytest.raises(ValueError, match="predicted_step_s"):
        cal.calibration_report(TickLedger())


def test_predict_step_seconds_and_card_stamp(models, monkeypatch):
    """predict_step_seconds on the same machine model (the reference's
    v5e at its compiled mesh) prices the same step through the event
    simulator; stamp_ledger_meta adds the device the ticks ran on."""
    jff, tff = models
    axes = dict(zip(jff.mesh.axis_names, jff.mesh.devices.shape))
    monkeypatch.setattr(api, "_cost_model", lambda a, c: cm.CostModel(
        mm.TPUMachineModel.make("v5e", int(np.prod(list(axes.values())))),
        dict(axes)))
    j, t = jcal.predict_step_seconds(jff), cal.predict_step_seconds(tff)
    assert t["pricing_mode"] == j["pricing_mode"] == "eventsim"
    assert t["graph_tokens"] == j["graph_tokens"] == 8
    assert t["predicted_step_s"] == pytest.approx(j["predicted_step_s"],
                                                  rel=PRICE_RTOL)
    led = TickLedger()
    led.record("decode", 1e-3, batch=1)
    cal.stamp_ledger_meta(led, tff, fixture="test")
    assert led.meta["card"] == "cpu" and led.meta["fixture"] == "test"
    assert cal.calibration_report(led)["meta"]["card"] == "cpu"


def _report(age_s=0.0, stamped=True):
    now = 1_700_000_000.0
    rep = {"version": 2, "tick_scales": {}, "phases": {"decode": 1.5}}
    if stamped:
        rep["created_at_unix"] = now - age_s
        rep["created_at"] = "stamped"
    return rep, now


@pytest.mark.parametrize("age_s,stamped,max_age,fresh", [
    (3600.0, True, None, True), (8 * 86400.0, True, None, False),
    (0.0, False, None, False), (8 * 86400.0, True, 30 * 86400.0, True)])
def test_load_calibration_freshness_matches_the_reference(
        age_s, stamped, max_age, fresh):
    """A fresh report loads, a stale or unstamped one is refused (None),
    and max_age_s widens the window, in both packages alike."""
    rep, now = _report(age_s, stamped)
    for mod in (jss, ss):
        got = mod.load_calibration(rep, max_age_s=max_age, now=now)
        assert (got is rep) if fresh else (got is None)


def test_search_consumes_and_refuses_calibrations_alike(graphs):
    """A fresh report scales the tick prices the same way in both
    packages (same winner and value); a stale one is refused and the
    result says so."""
    jg, tg = graphs
    jl, tl = _ledgers()
    reps = (jcal.calibration_report(jl), cal.calibration_report(tl))
    kw = dict(traffic="smoke", budget=24, seed=0, slots=4, max_len=128)
    jc, tc = costs()
    j = jss.search_serve_strategy(graph=jg, cost=jc, calibration=reps[0],
                                  **kw)
    t = ss.search_serve_strategy(graph=tg, cost=tc, calibration=reps[1],
                                 **kw)
    assert t.calibration["used"] and t.calibration["shapes"] == 4
    assert t.best == ss.ServeStrategy.from_json(j.best.to_json())
    assert t.best_objective == pytest.approx(j.best_objective,
                                             rel=PRICE_RTOL)
    stale = dict(reps[1], created_at_unix=0.0)
    t2 = ss.search_serve_strategy(graph=tg, cost=costs()[1],
                                  calibration=stale, **kw)
    assert t2.calibration == {"used": False, "reason": "stale-or-unstamped"}


# ---------------------------------------------------------------------------
# serving a strategy


def test_searched_strategy_serves_the_reference_tokens(models, tmp_path):
    """serve_generation(search_budget=24) searches on the H100 model and
    serves the winner; the winner's JSON, loaded by the JAX package's
    serve_generation, serves the same greedy tokens, token for token, as
    the port serving the strategy object, its JSON dict and the search.
    Records carry the strategy's fingerprint."""
    jff, tff = models
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, TINY["vocab_size"], (n,)).astype(np.int32)
               for n in (3, 6, 5)]

    def serve(ff, **kw):
        server = ff.serve_generation(slots=2, max_len=32, **kw)
        try:
            got = [np.asarray(f.result(timeout=300)) for f in
                   [server.submit(p, max_new_tokens=8) for p in prompts]]
            return got, server.metrics(), server.request_log.records()
        finally:
            server.stop()

    searched, m, recs = serve(tff, search_budget=24)
    best = ss.ServeStrategy.from_json(m["strategy"]["knobs"])
    assert m["strategy"]["fingerprint"] == best.fingerprint()
    assert {r["strategy"] for r in recs} == {best.fingerprint()}
    path = tmp_path / "strategy.json"
    path.write_text(json.dumps(best.to_json()))
    want, _, _ = serve(jff, serve_strategy=json.loads(path.read_text()))
    for got in (searched, serve(tff, serve_strategy=best)[0],
                serve(tff, serve_strategy=json.loads(path.read_text()))[0]):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
