"""The port's batch serving surface and the generation servers'
observability, on the CPU: the cases of tests/test_serving.py on the port
(serve equals predict, concurrent batching and chunking, the KServe-v2
routes, health after stop, the generation server's JSON and Prometheus
metrics, bounded retention and its drop count), the reqlog record held
to the JAX server's for the same requests on the same tiny Llama weights,
and an SLO breach dump end to end. HTTP servers bind port 0 and read
their port from `server_address`."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import SGDOptimizer as JSGD  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    DataType,
    FFConfig,
    FFModel,
    LossType,
    SGDOptimizer,
    obs,
)
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.serving import (  # noqa: E402
    ModelInstance,
    http_serve,
    serve,
    serve_onnx,
)

# fp32 on the CPU, the same forward at two batch shapes: summation order
TOL = 1e-5


def _np_params(ff):
    return [{k: {n: np.asarray(a) for n, a in w.items()}
             for k, w in t.items()} for t in ff._params]


def _mlp(two_inputs=False):
    """The reference test's MLP (x (8, 16) -> dense 32 -> relu -> dense 4
    -> softmax) in both packages, the port carrying the JAX weights;
    with `two_inputs` a second input z (8, 4) is added before the
    softmax."""

    def build(ff):
        x = ff.create_tensor((8, 16), name="x")
        t = ff.dense(ff.relu(ff.dense(x, 32, name="d0"), name="r0"), 4,
                     name="d1")
        if two_inputs:
            t = ff.add(t, ff.create_tensor((8, 4), name="z"), name="plus")
        ff.softmax(t, name="sm")

    jff = JFFModel(JFFConfig(batch_size=8, num_devices=1))
    build(jff)
    jff.compile(optimizer=JSGD(),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = FFModel(FFConfig(batch_size=8, device="cpu"))
    build(tff)
    tff.compile(optimizer=SGDOptimizer(),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                params=params_from_numpy(*_np_params(jff), device="cpu"))
    return jff, tff


_LMS = {}


def _lms():
    """(JAX, port) tiny Llama (LlamaConfig.tiny(), fp32, seq 8) on the same
    weights, built once."""
    if not _LMS:
        jff = JFFModel(JFFConfig(batch_size=1, seed=7))
        jbuild_llama(jff, JLlamaConfig.tiny(), batch_size=1, seq_len=8,
                     dtype=JDataType.FLOAT)
        jff.compile(loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        tff = FFModel(FFConfig(batch_size=1, seed=7, device="cpu"))
        build_llama(tff, LlamaConfig.tiny(), batch_size=1, seq_len=8,
                    dtype=DataType.FLOAT)
        tff.compile(params=params_from_numpy(*_np_params(jff),
                                             device="cpu"))
        _LMS["pair"] = (jff, tff)
    return _LMS["pair"]


def _prompts(seed, lens, vocab=512):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.headers, r.read()


# ---------------------------------------------------------------------------
# the dynamic batcher


def test_serve_matches_predict():
    jff, tff = _mlp()
    server = tff.serve(batch_sizes=(1, 4, 8), max_delay_ms=1.0)
    try:
        x = np.random.RandomState(0).randn(3, 16).astype(np.float32)
        got = server.predict(x)
        assert got.shape == (3, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, tff.predict(x), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, np.asarray(jff.predict(x))[:3],
                                   rtol=TOL, atol=TOL)
    finally:
        server.stop()


def test_serve_batches_concurrent_requests():
    """4 requests of 2 rows from 4 threads at once inside one 30 ms
    window: one batch of 8, split back per request."""
    _, tff = _mlp()
    server = tff.serve(batch_sizes=(8,), max_delay_ms=30.0)
    runs = []
    real_run = server.instance.run
    server.instance.run = lambda xs: runs.append(xs[0].shape[0]) \
        or real_run(xs)
    try:
        rs = np.random.RandomState(1)
        xs = [rs.randn(2, 16).astype(np.float32) for _ in range(4)]
        futs = [None] * 4
        go = threading.Barrier(4)

        def client(i):
            go.wait()
            futs[i] = server.submit(xs[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        outs = [f.result(timeout=60) for f in futs]
        np.testing.assert_allclose(np.concatenate(outs),
                                   tff.predict(np.concatenate(xs)),
                                   rtol=TOL, atol=TOL)
        assert server.requests_served == 4
        assert runs == [8]
    finally:
        server.stop()


def test_serve_pads_by_repeating_the_last_row_and_chunks_past_the_largest():
    """3 rows on sizes (1, 4) run as one batch of 4 whose last row repeats
    row 3; 11 rows run as chunks of 4, 4 and 4 (the last padded), and the
    answer is predict's."""
    _, tff = _mlp()
    server = tff.serve(batch_sizes=(4, 1), max_delay_ms=1.0)
    seen = []
    real_run = server.instance.run
    server.instance.run = lambda xs: seen.append(xs[0].copy()) \
        or real_run(xs)
    try:
        rs = np.random.RandomState(2)
        x3 = rs.randn(3, 16).astype(np.float32)
        np.testing.assert_allclose(server.predict(x3), tff.predict(x3),
                                   rtol=TOL, atol=TOL)
        assert len(seen) == 1 and seen[0].shape == (4, 16)
        np.testing.assert_array_equal(seen[0][3], x3[2])
        seen.clear()
        x11 = rs.randn(11, 16).astype(np.float32)
        got = server.predict(x11)
        assert got.shape == (11, 4)
        np.testing.assert_allclose(got, tff.predict(x11), rtol=TOL,
                                   atol=TOL)
        assert [s.shape[0] for s in seen] == [4, 4, 4]
        np.testing.assert_array_equal(seen[-1][3], x11[10])
    finally:
        server.stop()


def test_serve_failure_reaches_every_client_and_stop_drains():
    _, tff = _mlp()
    server = serve(tff, batch_sizes=(8,), max_delay_ms=30.0, warmup=False)

    def boom(xs):
        raise RuntimeError("forward failed")

    server.instance.run = boom
    x = np.zeros((2, 16), np.float32)
    futs = [server.submit(x) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="forward failed"):
            f.result(timeout=60)
    assert server.requests_served == 0
    server.stop()
    assert not server._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(x)


def test_warmup_runs_zeros_of_every_size_at_the_declared_dtypes():
    _, tff = _lms()
    inst = ModelInstance(tff, (4, 1, 2, 2))
    assert inst.batch_sizes == (1, 2, 4)
    assert [inst.pick_batch(n) for n in (1, 2, 3, 4, 9)] == [1, 2, 4, 4, 4]
    seen = []
    real_run = inst.run
    inst.run = lambda xs: seen.append((xs[0].shape, xs[0].dtype)) \
        or real_run(xs)
    inst.warmup()
    assert seen == [((b, 8), np.dtype("int32")) for b in (1, 2, 4)]


def test_serve_onnx_is_refused_by_item():
    with pytest.raises(NotImplementedError, match=r"queue 1 item 10\)"):
        serve_onnx("model.onnx")


# ---------------------------------------------------------------------------
# the HTTP endpoint


def _post(base, model, payload):
    req = urllib.request.Request(f"{base}/v2/models/{model}/infer",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def test_http_endpoint_kserve_v2():
    """Health, metadata, an infer round trip through the batcher with the
    tensors named in another order than the graph's inputs (bound by
    name), and the error codes: 400 for a request it cannot decode, 503
    for a failed inference, 404 for an unknown path."""
    _, tff = _mlp(two_inputs=True)
    server = serve(tff, batch_sizes=(1, 4), warmup=False)
    httpd = http_serve(server, port=0, model_name="mlp")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert json.loads(_get(f"{base}/v2/health/ready")[1])["ready"]
        meta = json.loads(_get(f"{base}/v2/models/mlp")[1])
        assert meta == {"name": "mlp", "platform": "flexflow_tpu_torch",
                        "requests_served": 0}
        rs = np.random.RandomState(0)
        x = rs.randn(2, 16).astype(np.float32)
        z = rs.randn(2, 4).astype(np.float32)
        out = _post(base, "mlp", {"inputs": [
            {"name": "z", "shape": [2, 4], "datatype": "FP32",
             "data": z.reshape(-1).tolist()},
            {"name": "x", "shape": [2, 16], "datatype": "FP32",
             "data": x.reshape(-1).tolist()}]})
        assert out["model_name"] == "mlp"
        (o,) = out["outputs"]
        assert o["name"] == "output0" and o["datatype"] == "FP32"
        got = np.asarray(o["data"], np.float32).reshape(o["shape"])
        np.testing.assert_allclose(got, tff.predict([x, z])[:2], rtol=TOL,
                                   atol=1e-6)
        m = json.loads(_get(f"{base}/v2/models/mlp/metrics")[1])
        assert m == {"server": {"requests_served": 1}}
        for bad, code in (({"inputs": [{"shape": [1], "data": "x"}]}, 400),
                          ({"inputs": [{"shape": [1], "data": [1],
                                        "datatype": "BF16"}]}, 400),
                          ({"inputs": [{"name": "x", "shape": [1, 3],
                                        "datatype": "FP32",
                                        "data": [1, 2, 3]}]}, 503)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, "mlp", bad)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/v2/models/other")
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        server.stop()


def test_http_ready_degrades_after_stop():
    _, tff = _mlp()
    server = serve(tff, batch_sizes=(1,), warmup=False)
    httpd = http_serve(server, port=0, model_name="m")
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert json.loads(_get(f"{base}/v2/health/ready")[1])["ready"]
        server.stop()
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/v2/health/ready")
        assert e.value.code == 503
        assert json.loads(e.value.read()) == {"ready": False}
    finally:
        httpd.shutdown()


def _prometheus_samples(text):
    """{sample name with labels: value} of a Prometheus text exposition,
    checking every line's form: a `# TYPE name kind` line before each
    family, then `name{labels} value` samples of that family."""
    out, family = {}, None
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, family, kind = ln.split(" ")
            assert kind in ("counter", "gauge", "histogram")
            continue
        name, value = ln.rsplit(" ", 1)
        base = name.split("{")[0]
        assert base == family or base.startswith(family + "_"), ln
        out[name] = float(value)
    return out


def test_http_generation_metrics_json_and_prometheus():
    """A paged generation server behind http_serve: the JSON metrics carry
    the pool, the prefix cache and per-request TTFT, JSON-serializable;
    /metrics is Prometheus text off the same registry (its histograms and
    the flattened scalars), and the two agree."""
    _, tff = _lms()
    fwd = serve(tff, batch_sizes=(1,), warmup=False)
    gen = tff.serve_generation(slots=2, max_len=32, paged=True, page_size=4)
    httpd = http_serve(fwd, port=0, model_name="lm", generation_server=gen)
    try:
        (prompt,) = _prompts(4, (9,))
        gen.generate(prompt, max_new_tokens=4, timeout=120)
        gen.generate(prompt, max_new_tokens=4, timeout=120)  # cache hit
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        m = json.loads(_get(f"{base}/v2/models/lm/metrics")[1])
        g = m["generation"]
        assert g["requests_served"] == 2
        assert 0.0 <= g["pool_occupancy"] <= 1.0
        assert 0.0 <= g["fragmentation"] <= 1.0
        pc = g["prefix_cache"]
        assert pc["enabled"] and pc["hit_tokens"] >= 8 and pc["hits"] >= 1
        assert pc["hit_tokens"] + pc["miss_tokens"] == pc["lookup_tokens"]
        for r in g["requests"]:
            assert r["ttft_s"] >= 0.0 and r["first_compile_s"] == 0.0
            assert r["ttft_excl_compile_s"] == r["ttft_s"]
        assert g["requests"][1]["cached_prefill_tokens"] >= 8
        assert g["histograms"]["ttft_s"]["count"] == 2
        json.dumps(m)
        headers, body = _get(f"{base}/metrics")
        assert headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        s = _prometheus_samples(text)
        assert "# TYPE ff_generation_requests_served counter" in text
        assert s["ff_generation_requests_served"] == 2
        assert "# TYPE ff_generation_pool_occupancy gauge" in text
        assert "# TYPE ff_tick_latency_s histogram" in text
        assert s["ff_ttft_s_count"] == gen.registry.histogram(
            "ttft_s").count == 2
        buckets = [v for k, v in s.items()
                   if k.startswith("ff_tick_latency_s_bucket")]
        assert buckets == sorted(buckets) and buckets[-1] >= 1
        # the paged server's registry counters, summed on the host
        gm = gen.metrics()
        assert s["ff_launch_rows_total"] == gm["launch_rows"] > 0
        assert s["ff_padded_rows_total"] == gm["padded_rows"]
        assert s["ff_host_roundtrips_total"] == gm["megastep"][
            "host_roundtrips"] > 0
        assert s["ff_decode_tokens_total"] == gm["megastep"][
            "decode_tokens"] == 6
        assert 0.0 <= s["ff_padding_waste_ratio"] <= 1.0
        assert s["ff_host_roundtrips_per_token"] == pytest.approx(
            gm["megastep"]["host_roundtrips_per_token"])
        assert s["ff_server_requests_served"] == 0
    finally:
        httpd.shutdown()
        fwd.stop()
        gen.stop()


def test_megastep_and_speculative_registry_series():
    """The megastep histogram and break counters of a megastep_ticks=4
    server, and the speculative server's acceptance histogram."""
    from flexflow_tpu_torch.spec import SpecConfig
    from flexflow_tpu_torch.spec.fixtures import make_token_cyclic

    _, tff = _lms()
    (prompt,) = _prompts(5, (6,))
    srv = tff.serve_generation(slots=2, max_len=32, paged=True, page_size=4,
                               megastep_ticks=4)
    try:
        srv.generate(prompt, max_new_tokens=9, timeout=120)
        m = srv.metrics()
        h = srv.registry.histogram("megastep_ticks")
        assert h.count == m["megastep"]["dispatches"] > 0
        assert sum(srv.registry.counter(f"megastep_break_{r}_total").value
                   for r in m["megastep"]["breaks"]) == h.count
    finally:
        srv.stop()
    cyc = FFModel(FFConfig(batch_size=1, seed=7, device="cpu"))
    build_llama(cyc, LlamaConfig.tiny(), batch_size=1, seq_len=8,
                dtype=DataType.FLOAT)
    cyc.compile()
    make_token_cyclic(cyc)
    srv = cyc.serve_generation(slots=2, max_len=64, paged=True, page_size=4,
                               speculate=SpecConfig(width=2, depth=3))
    try:
        srv.generate(prompt, max_new_tokens=30, timeout=120)
        h = srv.registry.histogram("spec_acceptance")
        assert h.count > 0 and h.sum > 0
        assert srv.metrics()["histograms"]["spec_acceptance"]["count"] \
            == h.count
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# bounded retention, the request log, the SLO monitor


def test_request_metric_retention_is_bounded():
    _, tff = _lms()
    server = tff.serve_generation(slots=2, max_len=32, paged=True,
                                  page_size=4, request_record_limit=2)
    try:
        for p in _prompts(6, (3, 5, 4)):
            server.generate(p, max_new_tokens=3, timeout=120)
        m = server.metrics()
        assert m["requests_served"] == 3          # counters: unaffected
        assert len(m["requests"]) == 2            # records: bounded
        assert m["request_records_dropped"] == 1
        assert [r["prefill_tokens"] + r["cached_prefill_tokens"]
                for r in m["requests"]] == [5, 4]
        assert m["histograms"]["ttft_s"]["count"] == 3
    finally:
        server.stop()
    for kw in ({}, {"paged": True, "page_size": 4}):
        with pytest.raises(ValueError, match="request_record_limit"):
            tff.serve_generation(slots=1, max_len=16,
                                 request_record_limit=0, **kw)


def test_v2_metrics_reports_bounded_retention_drops():
    _, tff = _lms()
    fwd = serve(tff, batch_sizes=(1,), warmup=False)
    gen = tff.serve_generation(slots=2, max_len=32, paged=True, page_size=4,
                               request_record_limit=2, reqlog_capacity=2)
    httpd = http_serve(fwd, port=0, model_name="lm", generation_server=gen)
    try:
        for p in _prompts(8, (3, 5, 4)):
            gen.generate(p, max_new_tokens=3, timeout=120)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        g = json.loads(_get(f"{base}/v2/models/lm/metrics")[1])["generation"]
        assert g["requests_served"] == 3
        assert len(g["requests"]) == 2
        assert g["request_records_dropped"] == 1
        assert g["reqlog"] == {"enabled": True, "records": 2,
                               "capacity": 2, "dropped": 1}
        assert [r["prompt_tokens"]
                for r in gen.request_log.records()] == [5, 4]
    finally:
        httpd.shutdown()
        fwd.stop()
        gen.stop()


def _serve_records(ff, prompts, max_new=4, **kw):
    """Serve the prompts one after another (so admission order and
    prefix-cache state are the same in both packages) and return the
    request log's records and the server's metrics."""
    srv = ff.serve_generation(slots=2, max_len=32, **kw)
    try:
        for p in prompts:
            srv.submit(p, max_new_tokens=max_new).result(timeout=300)
        return srv.request_log.records(), srv.metrics()
    finally:
        srv.stop()


@pytest.mark.parametrize("paged", [True, False])
def test_reqlog_records_match_the_jax_servers(paged, tmp_path):
    """The same requests on the same weights through the JAX server and
    the port's: the records carry the reference's keys, the same content
    fields (prompt length, tokens, the sha1 page-block prefix chain, kv
    dtype, page size, prefill split, preemptions, the speculative counts,
    the tier and router defaults, and on the paged server the
    fingerprint of the ServeStrategy both derive from their knobs) and
    ordered lifecycle stamps; the JSONL export reads back equal."""
    jff, tff = _lms()
    shared = _prompts(9, (4,))[0]
    prompts = [np.concatenate([shared, p]) for p in _prompts(10, (1, 4, 2))]
    kw = {"paged": True, "page_size": 4} if paged else {}
    jrecs, jm = _serve_records(jff, prompts, **kw)
    trecs, tm = _serve_records(tff, prompts, **kw)
    assert len(trecs) == len(jrecs) == len(prompts)
    assert tm["reqlog"] == jm["reqlog"] == {
        "enabled": True, "records": 3, "capacity": 4096, "dropped": 0}
    content = ("rid", "label", "prompt_tokens", "prefix_chain",
               "temperature", "max_new_tokens", "kv_dtype", "decode_tokens",
               "prefill_tokens", "cached_prefill_tokens", "preemptions",
               "spec_steps", "spec_draft_tokens", "spec_accepted_tokens",
               "spilled_pages", "fetched_pages", "routed_to", "page_size",
               "strategy")
    for t, j in zip(trecs, jrecs):
        assert set(t) == set(j)
        assert set(t["phases"]) == set(j["phases"]) == {
            "queue_s", "prefill_s", "decode_s"}
        assert {k: t.get(k) for k in content} == {k: j.get(k)
                                                  for k in content}
        assert (t["submit_ns"] <= t["admit_ns"] <= t["first_token_ns"]
                <= t["done_ns"])
        assert all(v >= 0.0 for v in t["phases"].values())
    if paged:
        assert trecs[0]["page_size"] == 4
        assert len({r["prefix_chain"][0] for r in trecs}) == 1
        assert len(trecs[0]["strategy"]) == 12
    else:
        assert trecs[0]["kv_dtype"] == "dense"
    from flexflow_tpu_torch.obs import reqlog as reqlog_mod

    p = str(tmp_path / "run.jsonl")
    srv = tff.serve_generation(slots=1, max_len=32, reqlog_capacity=8, **kw)
    try:
        srv.generate(prompts[0], 2, timeout=120)
        assert srv.request_log.export_jsonl(p) == 1
        assert reqlog_mod.load_jsonl(p) == srv.request_log.records()
    finally:
        srv.stop()


def test_reqlog_disabled_on_server():
    _, tff = _lms()
    recs, m = _serve_records(tff, _prompts(10, (3, 5)), paged=True,
                             page_size=4, reqlog_capacity=0)
    assert recs == [] and m["reqlog"]["enabled"] is False
    assert m["reqlog"] == {"enabled": False, "records": 0, "capacity": 0,
                           "dropped": 0}


@pytest.mark.parametrize("paged", [True, False])
def test_slo_breach_capture_end_to_end(paged, tmp_path):
    """A served run with an unmeetable declared SLO trips the monitor
    from inside the serving loop: ff_slo_breaches_total counts the one
    excursion, goodput falls to 0, the metrics carry the SLO snapshot,
    and the dump bundle holds the reqlog tail, the metrics (taken
    mid-loop: they already count the tripping request) and the SLO
    snapshot."""
    _, tff = _lms()
    dump_dir = str(tmp_path / "dumps")
    kw = {"paged": True, "page_size": 4} if paged else {}
    recs, m = _serve_records(
        tff, _prompts(11, (3, 5, 4)),
        slo={"ttft_p95_s": 1e-9, "window": 8, "min_samples": 1},
        slo_dump_dir=dump_dir, **kw)
    slo = m["slo"]
    assert slo["breaches"] == 1 and slo["breached"]
    assert slo["goodput_ratio"] == 0.0
    assert slo["target"]["ttft_p95_s"] == 1e-9
    bundle = slo["last_dump"]
    assert bundle == dump_dir + "/breach_0001"
    for name in ("reqlog_tail.jsonl", "metrics.json", "slo.json"):
        assert (tmp_path / "dumps" / "breach_0001" / name).exists(), name
    dumped = json.load(open(bundle + "/metrics.json"))
    assert dumped["reqlog"]["records"] >= 1
    assert dumped["slo"]["breaches"] == 1
    assert len(obs.load_jsonl(bundle + "/reqlog_tail.jsonl")) == 1
    assert len(recs) == 3


def test_slo_prometheus_series_gated_on_target():
    _, tff = _lms()
    (p,) = _prompts(12, (4,))
    mon = obs.SLOMonitor(obs.SLOTarget(ttft_p95_s=1e-9, min_samples=1))
    srv = tff.serve_generation(slots=1, max_len=32, paged=True, page_size=4,
                               slo=mon)
    try:
        srv.generate(p, max_new_tokens=2, timeout=120)
        text = srv.registry.prometheus_text()
        assert srv.slo_monitor is mon
    finally:
        srv.stop()
    assert "# TYPE ff_slo_breaches_total counter" in text
    assert "ff_slo_breaches_total 1" in text
    assert "# TYPE ff_goodput_ratio gauge" in text
    assert "ff_goodput_ratio 0" in text
    srv = tff.serve_generation(slots=1, max_len=32)
    try:
        text = srv.registry.prometheus_text()
        assert srv.slo_monitor is None
    finally:
        srv.stop()
    assert "slo_breaches" not in text and "goodput" not in text


def test_serve_generation_refuses_the_search_arguments_by_item():
    """The serving-strategy search is ported: serve_strategy (a JSON
    dict here) and search_budget serve, and what the reference refuses
    the port refuses with the reference's errors — a strategy beside an
    explicit speculate (ValueError), an unknown traffic profile
    (KeyError naming it), a strategy mesh of more than one card (the
    port's multi-card refusal, queue 1 item 12)."""
    from flexflow_tpu_torch.spec import SpecConfig

    _, tff = _lms()
    prompt = _prompts(0, [5])[0]
    for kw in ({"serve_strategy": {"page_size": 4, "prefill_chunk": 8}},
               {"search_budget": 4, "traffic": "mixed-length"}):
        srv = tff.serve_generation(slots=1, max_len=16, **kw)
        try:
            assert len(srv.generate(prompt, 3)) == 3
            assert srv.metrics()["strategy"]["fingerprint"] == \
                srv.strategy_fingerprint
        finally:
            srv.stop()
    with pytest.raises(ValueError, match="speculation"):
        tff.serve_generation(slots=1, max_len=16,
                             serve_strategy={"page_size": 4},
                             speculate=SpecConfig(width=2, depth=2))
    with pytest.raises(KeyError, match="chat"):
        tff.serve_generation(slots=1, max_len=16, search_budget=4,
                             traffic="chat")
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        tff.serve_generation(slots=1, max_len=16, serve_strategy={
            "page_size": 4, "mesh": [["data", 2]]})
