"""The port's span tracer, tick ledger and fit's profiler capture, held to
the JAX reference on the CPU.

The recorder and ledger contracts are the reference's own tests
(tests/test_obs.py) run against the port's obs package; a traced paged
server (the tiny GQA Llama of tests/test_paged.py with the JAX weights
carried over, every request queued before the first tick) must record
the same span names and the same ledger shape keys as the JAX server on
the same requests. The spans also land in a torch.profiler capture as
record_function ranges, the SLO breach bundle carries the trace's tail,
and fit under FFConfig(profiler_trace_dir=...) writes a Chrome trace that
loads.
"""

import glob
import gzip
import json
import os
import threading
import tracemalloc

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType as JLossType  # noqa: E402
from flexflow_tpu import obs as jobs  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.obs.ledger import TickLedger as JTickLedger  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
    obs,
)
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.obs.ledger import (  # noqa: E402
    TickLedger,
    parse_shape_key,
    shape_key,
)
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.spec import SpecConfig  # noqa: E402

VOCAB = 512
_MODELS = []


def _models():
    """(JAX model, port model carrying the JAX weights), built once."""
    if not _MODELS:
        kw = dict(vocab_size=VOCAB, dim=64, layers=2, heads=4, kv_heads=2,
                  hidden=128, rope_theta=10000.0)
        jff = JFFModel(JFFConfig(batch_size=1, seed=7))
        jbuild_llama(jff, JLlamaConfig(**kw), batch_size=1, seq_len=8,
                     dtype=JDataType.FLOAT)
        jff.compile(loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        tff = FFModel(FFConfig(batch_size=1, seed=7, device="cpu"))
        build_llama(tff, LlamaConfig(**kw), batch_size=1, seq_len=8,
                    dtype=DataType.FLOAT)
        jtr, jntr = jff._params
        tff.compile(params=params_from_numpy(
            {k: {n: np.asarray(a) for n, a in w.items()}
             for k, w in jtr.items()},
            {k: {n: np.asarray(a) for n, a in w.items()}
             for k, w in jntr.items()}, device="cpu"))
        _MODELS.append((jff, tff))
    return _MODELS[0]


@pytest.fixture(autouse=True)
def _recorders_off():
    yield
    obs.disable()
    jobs.disable()


def _prompts(seed=3, lens=(3, 6, 4)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# the recorder


def test_span_nesting_and_threads(tmp_path):
    rec = obs.enable()
    with obs.span("tick") as sp:
        assert sp
        sp.set(live=2)
        with obs.span("inner"):
            pass

    def other():
        with obs.span("worker") as w:
            w.set(idx=1)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    rec.instant("mark", why="test")
    assert obs.disable() is rec and not obs.enabled()

    names = [e[0] for e in rec.events]
    assert names == ["inner", "tick", "worker", "mark"]  # inner closes first
    tids = {e[0]: e[3] for e in rec.events}
    assert tids["tick"] == tids["inner"] != tids["worker"]
    by = {e[0]: e for e in rec.events}
    assert by["tick"][1] <= by["inner"][1]
    assert (by["inner"][1] + by["inner"][2]
            <= by["tick"][1] + by["tick"][2])
    assert by["tick"][4] == {"live": 2} and by["mark"][4] == {"why": "test"}

    doc = rec.chrome_trace()
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} <= {"X", "M"}
    xs = [e for e in evs if e["ph"] == "X"]
    assert [e["ts"] for e in xs] == sorted(e["ts"] for e in xs)
    assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(xs[0])
    assert xs[0]["ts"] >= 0.0
    assert sum(1 for e in evs
               if e["ph"] == "M" and e["name"] == "thread_name"
               and e["pid"] == 1) == 2
    p = rec.export_chrome_trace(str(tmp_path / "t.json.gz"))
    with gzip.open(p, "rt") as f:
        assert len(json.load(f)["traceEvents"]) == len(evs)
    p = rec.export_chrome_trace(str(tmp_path / "t.json"))
    assert json.load(open(p)) == json.loads(json.dumps(doc))


def test_request_lifecycle_tracks():
    """The port's request tracks are the reference recorder's, event for
    event, from the same stamps."""
    t = 1000.0
    docs = []
    for mod in (obs, jobs):
        rec = mod.enable()
        rec.t0_ns = 0
        rec.record_request(t, t + 0.5, t + 0.7, t + 1.2, label="req 1",
                           attrs={"generated_tokens": 5})
        rec.record_request(t, None, None, t + 0.1, label="req 2", attrs={})
        mod.disable()
        docs.append(rec.chrome_trace())
    assert docs[0] == docs[1]
    reqs = [e for e in docs[0]["traceEvents"]
            if e["ph"] == "X" and e["pid"] == 2]
    assert {"queued", "prefill", "decode"} <= {e["name"] for e in reqs}
    r1 = [e for e in reqs if e["tid"] == 1]
    assert sum(e["dur"] for e in r1) == pytest.approx(1.2e6, rel=1e-3)


def test_disabled_mode_is_free(monkeypatch):
    """Disabled, obs.span is the shared falsy singleton: no allocation in
    the obs package per call, and no torch call at all."""
    assert not obs.enabled()
    sp = obs.span("decode_tick")
    assert sp is obs.span("other") is obs.NULL_SPAN
    assert not sp
    with sp as inner:
        assert inner is obs.NULL_SPAN

    def refuse(*a, **k):
        raise AssertionError("a disabled span called torch")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    obs_dir = obs.__file__.rsplit("/", 1)[0]
    iters = 2000

    def tick():
        with obs.span("decode_tick") as s:
            if s:
                s.set(live=3)

    for _ in range(16):
        tick()
    tracemalloc.start()
    s1 = tracemalloc.take_snapshot()
    for _ in range(iters):
        tick()
    s2 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    new_allocs = sum(
        d.count_diff for d in s2.compare_to(s1, "filename")
        if d.traceback[0].filename.startswith(obs_dir) and d.count_diff > 0)
    assert new_allocs < iters // 100


def test_recorder_drops_beyond_max_events():
    rec = obs.enable(max_events=4)
    for _ in range(10):
        with obs.span("e"):
            pass
    rec.instant("past the bound")
    obs.disable()
    assert len(rec.events) == 4
    assert rec.dropped == 6
    assert rec.chrome_trace()["otherData"]["dropped_events"] == 6


def test_spans_are_profiler_ranges():
    """Enabled, a span is a torch.profiler.record_function range: a
    capture over the same window names it beside the ops it ran."""
    rec = obs.enable()
    x = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("decode_tick"):
            torch.mm(x, x)
    obs.disable()
    names = {e.key for e in prof.key_averages()}
    assert "decode_tick" in names and "aten::mm" in names
    assert [e[0] for e in rec.events] == ["decode_tick"]
    assert rec.nvtx is torch.cuda.is_available()
    off = obs.enable(annotate_device=False)
    assert off.nvtx is False
    obs.disable()


# ---------------------------------------------------------------------------
# the tick ledger


def test_shape_key_roundtrip():
    k = shape_key("verify", batch=3, chunk=0, width=7)
    assert k == "verify|b3|c0|w7"
    assert parse_shape_key(k) == {"phase": "verify", "batch": 3,
                                  "chunk": 0, "width": 7}


def test_ledger_stats_bounding_and_roundtrip(tmp_path):
    """Bounded samples, true counts and stats; the JSON round trip, and a
    ledger saved by either package loads in the other with equal
    stats."""
    led = TickLedger(max_samples_per_shape=8)
    for i in range(20):
        led.record("decode", 0.01 * (i + 1), batch=2)
    led.record("prefill", 0.5, batch=1, chunk=32)
    st = led.stats("decode|b2|c0|w1")
    assert st["count"] == 20 and st["sampled"] == 8
    assert st["min_s"] == pytest.approx(0.13)
    assert st["max_s"] == pytest.approx(0.20)
    assert led.stats("nope|b1|c0|w1") is None
    led.meta["note"] = "x"
    led2 = TickLedger.from_json(json.loads(json.dumps(led.to_json())))
    assert led2.shapes() == led.shapes()
    assert led2.stats("decode|b2|c0|w1") == st
    assert led2.meta["note"] == "x"
    p = led.save(str(tmp_path / "led.json"))
    assert TickLedger.load(p).stats("prefill|b1|c32|w1")["count"] == 1
    jled = JTickLedger.load(p)
    for key in led.shapes():
        assert jled.stats(key) == led.stats(key)
    assert json.dumps(jled.to_json(), sort_keys=True) == json.dumps(
        led.to_json(), sort_keys=True)


# ---------------------------------------------------------------------------
# traced servers


def _traced(mod, ff, prompts, new, **kw):
    rec = mod.enable()
    srv = ff.serve_generation(slots=2, max_len=32, paged=True, page_size=4,
                              defer_start=True, **kw)
    try:
        futs = [srv.submit(p, max_new_tokens=new) for p in prompts]
        srv.start()
        toks = [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        srv.stop()
        mod.disable()
    return toks, rec, srv


def test_traced_paged_server_matches_reference(tmp_path):
    """The same requests through the JAX paged server and the port's
    under obs.enable(): equal tokens, the same span names, the same
    ledger shape keys with the same counts, one request track a request;
    the trace exports and loads, a request's track has its three
    phases, and the ledger saves and loads."""
    jff, tff = _models()
    prompts = _prompts()
    got, rec, srv = _traced(obs, tff, prompts, 4)
    jgot, jrec, _ = _traced(jobs, jff, prompts, 4)
    for a, b in zip(got, jgot):
        np.testing.assert_array_equal(a, b)
    # idle_wait spans the loop's waits for work, which depend on when
    # the caller's stop() lands, not on the requests
    names = {e[0] for e in rec.events} - {"idle_wait"}
    assert names == {e[0] for e in jrec.events} - {"idle_wait"}
    assert {"tick_prep", "admit_pending", "prefill_tick",
            "decode_tick"} <= names
    assert rec.ledger.shapes() == jrec.ledger.shapes()
    for key in rec.ledger.shapes():
        assert rec.ledger.stats(key)["count"] == \
            jrec.ledger.stats(key)["count"], key
    assert len(rec.requests) == len(jrec.requests) == len(prompts)
    assert [r[1] for r in rec.requests] == [r[1] for r in jrec.requests]
    # the ledger's decode ticks are the server's decode ticks
    assert sum(rec.ledger.stats(k)["count"] for k in rec.ledger.shapes()
               if k.startswith("decode")) == \
        srv.registry.histogram("tick_latency_s").count
    doc = json.load(open(rec.export_chrome_trace(str(tmp_path / "t.json"))))
    track = [e for e in doc["traceEvents"] if e["ph"] == "X"
             and e["pid"] == 2 and e["tid"] == 1]
    assert [e["name"] for e in track] == ["queued", "prefill", "decode"]
    assert track[-1]["args"]["decode_tokens"] == 4
    led = TickLedger.load(rec.ledger.save(str(tmp_path / "ledger.json")))
    assert led.shapes() == rec.ledger.shapes()


def test_traced_megastep_and_speculative_servers():
    """The megastep, the universal megastep and the speculative tick
    record their spans and ledger records (megastep widths, verify at the
    tree's width) with the tokens of the untraced servers."""
    _, tff = _models()
    prompts = _prompts()
    plain, _, _ = _traced(obs, tff, prompts, 6)
    for kw, span, key in (
            (dict(megastep_ticks=4), "megastep", "decode"),
            (dict(megastep_ticks=4, megastep_mixed=True,
                  overlap_dispatch=True), "overlap_admit", "decode"),
            (dict(speculate=SpecConfig(width=2, depth=3)), "verify",
             "verify")):
        got, rec, srv = _traced(obs, tff, prompts, 6, **kw)
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a, b)
        names = {e[0] for e in rec.events}
        assert span in names, (kw, names)
        keys = [parse_shape_key(k) for k in rec.ledger.shapes()]
        assert any(k["phase"] == key for k in keys), (kw, keys)
        if "speculate" in kw:
            assert {"draft", "verify", "commit"} <= names
            assert any(k["width"] == kw["speculate"].max_nodes
                       for k in keys if k["phase"] == "verify")
        else:
            assert any(k["width"] > 1 for k in keys), keys


def test_traced_dense_server_and_train_step():
    """The dense server's admit and decode_tick spans and its decode
    ledger records, and the executor's named train_step span."""
    _, tff = _models()
    rec = obs.enable()
    srv = tff.serve_generation(slots=2, max_len=32)
    try:
        got = srv.generate(_prompts()[0], 3, timeout=120)
    finally:
        srv.stop()
    tff2 = FFModel(FFConfig(batch_size=2, seed=0, device="cpu"))
    build_llama(tff2, LlamaConfig.tiny(), batch_size=2, seq_len=8)
    tff2.compile(optimizer=AdamOptimizer(lr=1e-3),
                 loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    x = np.random.RandomState(0).randint(0, 64, (2, 8)).astype(np.int32)
    tff2.fit(x, x, verbose=False)
    obs.disable()
    assert len(got) == 3
    names = [e[0] for e in rec.events]
    assert {"admit", "decode_tick", "train_step"} <= set(names)
    assert names.count("train_step") == 1
    assert any(k.startswith("decode|") for k in rec.ledger.shapes())
    assert len(rec.requests) == 1


def test_slo_breach_bundle_carries_trace_tail(tmp_path):
    """Under obs.enable() a paged server's SLO breach dumps a bundle
    whose trace_tail.json holds the tick spans and request tracks."""
    _, tff = _models()
    obs.enable()
    srv = tff.serve_generation(
        slots=2, max_len=32, paged=True, page_size=4,
        slo=obs.SLOTarget(ttft_p95_s=1e-9, window=4, min_samples=1),
        slo_dump_dir=str(tmp_path))
    try:
        srv.generate(_prompts()[0], 3, timeout=120)
        m = srv.metrics()
    finally:
        srv.stop()
        obs.disable()
    bundle = m["slo"]["last_dump"]
    assert bundle and m["slo"]["breaches"] >= 1
    trace = json.load(open(os.path.join(bundle, "trace_tail.json")))
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"decode_tick", "prefill_tick"} <= names


def test_fit_profiler_trace_dir_writes_trace(tmp_path):
    """FFConfig(profiler_trace_dir=...) is taken (no longer refused, as in
    the reference), and fit under it writes a Chrome trace that loads and
    names the step's ops; it combines with transfer_guard; a second fit
    writes a second trace."""
    d = str(tmp_path / "prof")
    ff = FFModel(FFConfig(batch_size=2, seed=0, device="cpu",
                          profiler_trace_dir=d, transfer_guard="log"))
    assert ff.config.profiler_trace_dir == d
    build_llama(ff, LlamaConfig.tiny(), batch_size=2, seq_len=8)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    x = np.random.RandomState(0).randint(0, 64, (4, 8)).astype(np.int32)
    m = ff.fit(x, x, verbose=False)
    assert m.train_all == 4
    files = sorted(glob.glob(os.path.join(d, "*.json")))
    assert len(files) == 1
    doc = json.load(open(files[0]))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    ff.fit(x, x, verbose=False)
    assert len(glob.glob(os.path.join(d, "*.json"))) == 2
