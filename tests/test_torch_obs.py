"""The port's copies of the reference's observability modules
(flexflow_tpu_torch/obs: metrics, reqlog, slo), held to the cases of
tests/test_obs.py that touch them and, for the Prometheus text, to the
JAX registry itself: the same observations give the same bytes."""

import json
import tracemalloc

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference package

from flexflow_tpu.obs import metrics as jmetrics  # noqa: E402
from flexflow_tpu.obs import reqlog as jreqlog  # noqa: E402
from flexflow_tpu.obs import slo as jslo  # noqa: E402
from flexflow_tpu_torch import obs  # noqa: E402
from flexflow_tpu_torch.obs import reqlog as reqlog_mod  # noqa: E402
from flexflow_tpu_torch.obs.metrics import (  # noqa: E402
    COUNT_BUCKETS,
    RATIO_BUCKETS,
    TIME_BUCKETS_S,
    Histogram,
    MetricsRegistry,
    flatten_scalars,
)

# ---------------------------------------------------------------------------
# metrics: histogram bucket math + Prometheus text


def test_bucket_sets_equal_the_reference():
    assert TIME_BUCKETS_S == jmetrics.TIME_BUCKETS_S
    assert COUNT_BUCKETS == jmetrics.COUNT_BUCKETS
    assert RATIO_BUCKETS == jmetrics.RATIO_BUCKETS


def test_histogram_bucket_math():
    h = Histogram([0.1, 1.0, 10.0])
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    # per-bucket counts: le 0.1 -> 1, le 1.0 -> 2, le 10.0 -> 1, +Inf -> 1
    assert h.counts == [1, 2, 1, 1]
    assert h.count == 5
    assert h.sum == pytest.approx(56.05)
    d = h.to_json()
    assert d["count"] == 5
    assert 0.1 <= d["p50"] <= 1.0          # 3rd of 5 samples sits in (0.1, 1]
    assert d["p95"] >= 10.0                # tail clamps at/past the last bound
    # boundary values land in the bucket whose le bound they equal
    h2 = Histogram([1.0, 2.0])
    h2.observe(1.0)
    assert h2.counts == [1, 0, 0]


def test_histogram_rejects_bad_bounds():
    with pytest.raises(ValueError):
        Histogram([1.0, 0.5])
    with pytest.raises(ValueError):
        Histogram([])


def test_flatten_scalars_nested():
    flat = flatten_scalars(
        {"a": 1, "b": {"c": 2.5, "d": True, "skip": [1, 2], "n": None}},
        "g")
    assert flat == {"g_a": 1.0, "g_b_c": 2.5, "g_b_d": 1.0}


def test_registry_prometheus_text():
    reg = MetricsRegistry()
    reg.counter("requests_total").inc(3)
    reg.gauge("live_slots").set(2)
    h = reg.histogram("tick_latency_s")
    h.observe(0.002)
    h.observe(0.2)
    text = reg.prometheus_text(extra_scalars={"decode_steps": 7.0,
                                              "pool_pages_free": 5.0})
    assert "# TYPE ff_requests_total counter" in text
    assert "ff_requests_total 3" in text
    assert "# TYPE ff_live_slots gauge" in text
    assert "# TYPE ff_tick_latency_s histogram" in text
    assert 'ff_tick_latency_s_bucket{le="+Inf"} 2' in text
    assert "ff_tick_latency_s_count 2" in text
    assert "ff_tick_latency_s_sum" in text
    # extra scalars: *_steps renders as a counter, the rest as gauges
    assert "# TYPE ff_decode_steps counter" in text
    assert "# TYPE ff_pool_pages_free gauge" in text
    # buckets are cumulative and non-decreasing
    vals = [int(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
            if ln.startswith("ff_tick_latency_s_bucket")]
    assert vals == sorted(vals) and vals[-1] == 2


def test_registry_json_roundtrip():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.histogram("h", COUNT_BUCKETS).observe(3)
    doc = json.loads(json.dumps(reg.to_json()))
    assert doc["c"] == 1
    assert doc["h"]["count"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_and_json_byte_equal_to_the_reference(seed):
    """Seeded counters, gauges, histograms on all three bucket sets (the
    serving histograms' names, values on and between the bounds, past
    the last, integral and not) and extra scalars of every rendered kind,
    fed to both registries: the Prometheus text is byte-equal, and so is
    the JSON export."""
    rs = np.random.RandomState(seed)
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    hists = (("tick_latency_s", None), ("ttft_s", None),
             ("tokens_per_tick", "COUNT_BUCKETS"),
             ("spec_acceptance", "RATIO_BUCKETS"))
    obs_vals = {
        "tick_latency_s": np.concatenate([
            10.0 ** rs.uniform(-5, 2.5, 40), TIME_BUCKETS_S[:5]]),
        "ttft_s": rs.exponential(0.3, 25),
        "tokens_per_tick": rs.randint(0, 300, 30).astype(float),
        "spec_acceptance": np.round(rs.rand(20), 1),
    }
    scalars = {"generation_requests_served": float(rs.randint(100)),
               "generation_decode_steps": float(rs.randint(1000)),
               "generation_pool_occupancy": float(rs.rand()),
               "generation_prefix_cache_hits": 3.0,
               "generation_megastep_breaks_finish": 2.0,
               "server_requests_served": 7.0, "weird-name.x": 1.5,
               "9lives": 2.0}
    rows = int(rs.randint(1000))
    for reg, mod in zip(regs, (obs.metrics, jmetrics)):
        reg.counter("launch_rows_total").inc(rows)
        reg.counter("idle_wait_seconds_total").inc(0.003294944999652216)
        reg.gauge("padding_waste_ratio").set(0.375)
        reg.gauge("goodput_ratio").set(1.0 / 3.0)
        for name, bounds in hists:
            h = (reg.histogram(name) if bounds is None
                 else reg.histogram(name, getattr(mod, bounds)))
            for v in obs_vals[name]:
                h.observe(float(v))
    texts = [reg.prometheus_text(extra_scalars=scalars) for reg in regs]
    assert texts[0].encode() == texts[1].encode()
    assert json.dumps(regs[0].to_json(), sort_keys=True) == json.dumps(
        regs[1].to_json(), sort_keys=True)


# ---------------------------------------------------------------------------
# reqlog: bounded retention, the null discipline, JSONL


def test_bounded_ring_retention_and_drop_count():
    ring = obs.BoundedRing(3)
    assert ring.capacity == 3
    for i in range(5):
        ring.append(i)
    assert ring.snapshot() == [2, 3, 4]    # keep-newest
    assert ring.dropped == 2               # ...and COUNT what fell off
    assert len(ring) == 3
    assert ring.tail(2) == [3, 4]
    assert ring.tail(0) == []
    assert ring.tail(99) == [2, 3, 4]
    assert list(ring) == [2, 3, 4]
    with pytest.raises(ValueError):
        obs.BoundedRing(0)


def test_request_log_factory_null_discipline():
    live = obs.request_log(None)
    assert live and live.capacity == 4096
    assert obs.request_log(7).capacity == 7
    null = obs.request_log(0)
    assert null is obs.NULL_REQLOG and not null
    null.log({"x": 1})                     # no-op, never raises
    assert len(null) == 0 and null.records() == [] and null.tail(5) == []
    assert null.dropped == 0 and null.capacity == 0
    assert null.export_jsonl("/nonexistent/never-written") == 0

    log = obs.RequestLog(capacity=2)
    for i in range(3):
        log.log({"rid": i})
    assert [r["rid"] for r in log.records()] == [1, 2]
    assert log.dropped == 1


def test_disabled_reqlog_is_free():
    """The disabled emit-site pattern (`if rl: rl.log(...)`) allocates
    nothing per call inside the obs package."""
    rl = obs.request_log(0)
    obs_dir = obs.__file__.rsplit("/", 1)[0]
    iters = 2000

    def emit():
        if rl:
            rl.log({"rid": 1})

    for _ in range(16):
        emit()
    tracemalloc.start()
    s1 = tracemalloc.take_snapshot()
    for _ in range(iters):
        emit()
    s2 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    new_allocs = sum(
        d.count_diff for d in s2.compare_to(s1, "filename")
        if d.traceback[0].filename.startswith(obs_dir) and d.count_diff > 0)
    assert new_allocs < iters // 100


def test_reqlog_jsonl_roundtrip_and_the_reference_reads_it(tmp_path):
    records = [{"submit_ns": 10 * i, "rid": i, "prompt_tokens": 4,
                "prefix_chain": ["aa", "bb"]} for i in range(3)]
    for name in ("log.jsonl", "log.jsonl.gz"):
        p = str(tmp_path / name)
        assert reqlog_mod.dump_jsonl(p, records) == 3
        assert reqlog_mod.load_jsonl(p) == records
        # the same schema: either package reads the other's export
        assert jreqlog.load_jsonl(p) == records
        jp = str(tmp_path / ("j_" + name))
        jreqlog.dump_jsonl(jp, records)
        assert reqlog_mod.load_jsonl(jp) == records
    assert reqlog_mod.SCHEMA == jreqlog.SCHEMA == "ff.reqlog/v1"
    first = open(str(tmp_path / "log.jsonl")).readline()
    assert json.loads(first) == {"schema": reqlog_mod.SCHEMA}
    assert open(str(tmp_path / "log.jsonl")).read() == open(
        str(tmp_path / "j_log.jsonl")).read()
    bare = str(tmp_path / "bare.jsonl")
    with open(bare, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    assert reqlog_mod.load_jsonl(bare) == records
    alien = str(tmp_path / "alien.jsonl")
    with open(alien, "w") as f:
        f.write(json.dumps({"schema": "somebody.else/v9"}) + "\n")
    with pytest.raises(ValueError, match="somebody.else/v9"):
        reqlog_mod.load_jsonl(alien)


# ---------------------------------------------------------------------------
# SLO monitor: percentile math, latching, breach dumps


def _slo_rec(i, ttft_s, decode_s=0.0, decode_tokens=1):
    sub = i * 10**9
    first = sub + int(ttft_s * 1e9)
    return {"submit_ns": sub, "first_token_ns": first,
            "done_ns": first + int(decode_s * 1e9),
            "decode_tokens": decode_tokens}


def test_slo_percentile_nearest_rank():
    from flexflow_tpu_torch.obs.slo import percentile

    assert percentile([], 0.95) == 0.0
    assert percentile([3.0, 1.0, 2.0], 0.5) == 2.0
    assert percentile(list(range(1, 11)), 0.95) == 10  # ceil(9.5) = 10th
    assert percentile([1.0, 2.0, 3.0], 0.95) == 3.0    # ceil(2.85) = 3rd
    assert percentile([5.0], 0.95) == 5.0
    rs = np.random.RandomState(0)
    for n in (1, 7, 64):
        vals = list(rs.rand(n))
        for q in (0.5, 0.95, 0.99):
            assert percentile(vals, q) == jslo.percentile(vals, q)


def test_slo_target_validation_and_roundtrip():
    with pytest.raises(ValueError, match="declares no target"):
        obs.SLOTarget()
    with pytest.raises(ValueError):
        obs.SLOTarget(ttft_p95_s=0.1, window=0)
    t = obs.SLOTarget(ttft_p95_s=0.1, s_per_token_p95=0.02, window=16,
                      min_samples=4)
    assert obs.SLOTarget.from_json(
        json.loads(json.dumps(t.to_json()))) == t
    assert t.to_json() == jslo.SLOTarget(
        ttft_p95_s=0.1, s_per_token_p95=0.02, window=16,
        min_samples=4).to_json()


def test_slo_monitor_latches_per_excursion():
    """observe() returns True exactly on the ok -> breached transition,
    stays latched while the window p95 is over, and unlatches on
    recovery so the next excursion counts again; the same stream through
    the reference's monitor gives the same snapshots."""
    mon = obs.SLOMonitor(obs.SLOTarget(ttft_p95_s=0.1, window=4,
                                       min_samples=2))
    jmon = jslo.SLOMonitor(jslo.SLOTarget(ttft_p95_s=0.1, window=4,
                                          min_samples=2))
    i = iter(range(100))

    def feed(ttft):
        rec = _slo_rec(next(i), ttft)
        got = mon.observe(rec)
        assert got == jmon.observe(rec)
        return got

    assert feed(0.01) is False  # < min_samples
    assert feed(0.01) is False  # p95 .01 ok
    assert feed(1.0) is True    # trip: p95 1.0
    assert mon.breaches == 1 and mon.breached
    assert feed(1.0) is False   # still breached
    assert mon.breaches == 1
    for _ in range(4):          # flush the window
        feed(0.01)
    assert not mon.breached     # recovered
    assert feed(2.0) is True    # new excursion
    assert mon.breaches == 2
    assert mon.goodput == pytest.approx(3 / 4)
    snap = mon.snapshot()
    assert snap["breaches"] == 2 and snap["breached"]
    assert snap["ttft_p95_s"] == pytest.approx(2.0)
    assert snap == jmon.snapshot()


def test_slo_monitor_s_per_token_axis():
    mon = obs.SLOMonitor(obs.SLOTarget(s_per_token_p95=0.01, window=8,
                                       min_samples=1))
    # 0.4 s of decode for 80 tokens = 5 ms/token: ok
    assert mon.observe(_slo_rec(0, 0.0, decode_s=0.4,
                                decode_tokens=80)) is False
    # 0.4 s for 10 tokens = 40 ms/token: trips
    assert mon.observe(_slo_rec(1, 0.0, decode_s=0.4,
                                decode_tokens=10)) is True


def test_slo_breach_dump_bundle(tmp_path):
    """A breach dump is the flight-recorder bundle: reqlog tail, metrics
    snapshot, SLO snapshot (no trace tail without a recorder, which the
    port's servers never pass); a failing metrics callable is captured
    as an error entry, never raised."""
    mon = obs.SLOMonitor(obs.SLOTarget(ttft_p95_s=0.1, min_samples=1),
                         dump_dir=str(tmp_path / "dumps"))
    log = obs.RequestLog(capacity=8)
    for i in range(5):
        rec = _slo_rec(i, 1.0 if i == 4 else 0.01)
        log.log(rec)
        mon.observe(rec)
    assert mon.breaches == 1
    bundle = mon.dump(reqlog=log, metrics=lambda: {"requests_served": 5})
    assert bundle == str(tmp_path / "dumps" / "breach_0001")
    tail = reqlog_mod.load_jsonl(bundle + "/reqlog_tail.jsonl")
    assert len(tail) == 5 and tail[-1]["first_token_ns"] > 0
    assert not (tmp_path / "dumps" / "breach_0001" / "trace_tail.json"
                ).exists()
    assert json.load(open(bundle + "/metrics.json")) == {
        "requests_served": 5}
    slo_doc = json.load(open(bundle + "/slo.json"))
    assert slo_doc["breaches"] == 1 and slo_doc["breached"]
    assert mon.last_dump == bundle

    def boom():
        raise RuntimeError("scrape died")

    mon.breaches += 1
    b2 = mon.dump(reqlog=log, metrics=boom)
    assert "scrape died" in json.load(open(b2 + "/metrics.json"))["error"]
    assert obs.SLOMonitor(obs.SLOTarget(ttft_p95_s=1.0)).dump() is None


def test_obs_exports_the_metrics_reqlog_and_slo_names_only():
    """The port's obs exports the metrics, reqlog and SLO names and, since
    the span tracer and tick ledger are ported, theirs: the reference's
    __all__ but the compile tracker (which waits for CUDA graphs)."""
    assert set(obs.__all__) == {
        "COUNT_BUCKETS", "BoundedRing", "Histogram", "MetricsRegistry",
        "NULL_REQLOG", "RATIO_BUCKETS", "RequestLog", "SLOMonitor",
        "SLOTarget", "TIME_BUCKETS_S", "dump_jsonl", "flatten_scalars",
        "load_jsonl", "request_log", "NULL_SPAN", "Span", "TickLedger",
        "TraceRecorder", "disable", "enable", "enabled", "ledger",
        "recorder", "shape_key", "span"}
    from flexflow_tpu import obs as jobs

    assert set(obs.__all__) == set(jobs.__all__) - {"CompileTracker"}
    for name in obs.__all__:
        assert hasattr(obs, name), name
    assert not hasattr(obs, "CompileTracker")
