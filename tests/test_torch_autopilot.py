"""The port's drain-and-swap and ServingAutopilot on the CPU, held to the
JAX package: a swap under continuous submits drops nothing, its greedy
streams equal the JAX package's generate token for token, the pool is
adopted when the geometry matches, and the request log spans the swap
segmented by strategy fingerprint; the controller's step() holds for the
reference's reasons in the reference's order; the SLO breach bundle
carries the serving strategy. The JAX model is built once and its
weights carried over (runtime/weights.params_from_numpy)."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models import llama  # noqa: E402
from flexflow_tpu_torch.obs import SLOTarget  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.search.servesearch import ServeStrategy  # noqa: E402
from flexflow_tpu_torch.serving_autopilot import ServingAutopilot  # noqa: E402

TINY = dict(vocab_size=512, dim=64, layers=2, heads=4, kv_heads=2,
            hidden=128, rope_theta=10000.0)
NEW = 8


@pytest.fixture(scope="module")
def setup():
    """The port model carrying the JAX weights, four prompts of one
    length (one JAX generate shape) and the JAX package's greedy
    generate of each."""
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
    rs = np.random.RandomState(5)
    pool = [rs.randint(0, TINY["vocab_size"], (5,)).astype(np.int32)
            for _ in range(4)]
    want = [np.asarray(jff.generate(p[None, :], max_new_tokens=NEW)[0])
            for p in pool]
    return tff, pool, want


def test_hot_swap_under_continuous_submits(setup):
    """swap_to from page 8 / chunk 32 to chunk 16 while a thread keeps
    submitting: every future resolves to the JAX generate stream, at
    least one in-flight request is carried, the same-geometry pool is
    adopted, the warm-up loaded nothing (on the CPU the plain version
    runs), the reqlog holds
    both strategies' records, and metrics() report one swap and the new
    fingerprint. Post-swap traffic matches too."""
    tff, pool, want = setup
    ap = ServingAutopilot(tff, ServeStrategy(page_size=8, prefill_chunk=32),
                          slots=2, max_len=32)
    futs, done = [], threading.Event()

    def submitter():
        i = 0
        while not done.is_set():
            if sum(1 for _, f in futs if not f.done()) < 6:
                futs.append((i % 4, ap.submit(pool[i % 4],
                                              max_new_tokens=NEW)))
                i += 1
            else:
                time.sleep(0.002)

    try:
        fp_old = ap.strategy_fingerprint
        for k in range(2):  # served wholly by the old strategy
            np.testing.assert_array_equal(
                ap.generate(pool[k], NEW), want[k])
        for k in range(4):  # in flight when the swap lands
            futs.append((k, ap.submit(pool[k], max_new_tokens=NEW)))
        feeder = threading.Thread(target=submitter)
        feeder.start()
        alt = dataclasses.replace(ap.strategy, prefill_chunk=16)
        swap = ap.swap_to(alt)
        time.sleep(0.05)
        done.set()
        feeder.join(timeout=60)
        assert not feeder.is_alive()
        for k, f in futs:
            np.testing.assert_array_equal(np.asarray(f.result(timeout=120)),
                                          want[k])
        assert swap["carried"] >= 1
        assert swap["pool_adopted"] is True
        assert swap["from"] == fp_old
        assert swap["to"] == alt.fingerprint() != fp_old
        assert swap["warmed"] == []
        for k in range(4):
            np.testing.assert_array_equal(ap.generate(pool[k], NEW),
                                          want[k])
        stamps = [r.get("strategy") for r in ap.request_log.records()]
        assert set(stamps) == {fp_old, alt.fingerprint()}
        assert len(stamps) == 2 + len(futs) + 4
        m = ap.metrics()
        assert m["autopilot"]["swaps"] == 1
        assert m["strategy"]["fingerprint"] == alt.fingerprint()
        assert m["strategy"]["knobs"] == alt.to_json()
    finally:
        done.set()
        ap.stop()


def test_swap_to_another_geometry_recomputes_and_matches(setup):
    """A swap to another page size (and an int8-free speculative
    strategy) cannot adopt the pool: carried requests recompute their
    prefix on the successor's fresh pool and still finish with the JAX
    generate stream."""
    tff, pool, want = setup
    ap = ServingAutopilot(tff, ServeStrategy(page_size=8, prefill_chunk=32),
                          slots=2, max_len=32)
    try:
        futs = [(k, ap.submit(pool[k], max_new_tokens=NEW))
                for k in range(4)]
        swap = ap.swap_to(ServeStrategy(page_size=16, prefill_chunk=16,
                                        spec_width=2, spec_depth=2))
        for k, f in futs:
            np.testing.assert_array_equal(np.asarray(f.result(timeout=120)),
                                          want[k])
        assert swap["pool_adopted"] is False
        assert swap["warmed"] == []
    finally:
        ap.stop()


def test_step_holds_for_the_reference_reasons(setup):
    """The reference's controller sequence (its tests/test_ticksim.py):
    an empty window holds on insufficient-window; a full window searches
    with the ticksim backend (the window is an arrival trace) and holds
    below the improvement threshold (or already optimal); the unchanged
    window then holds on no-drift at drift 0 without searching. Every
    record carries the fingerprint; start()/stop() run step() on a
    thread."""
    tff, pool, _ = setup
    ap = ServingAutopilot(tff, ServeStrategy(page_size=8, prefill_chunk=32),
                          slots=2, max_len=32, min_window=4,
                          improvement=1e9, budget=24)
    try:
        d = ap.step()
        assert (d["action"], d["reason"]) == ("hold", "insufficient-window")
        for f in [ap.submit(p, max_new_tokens=6) for p in pool]:
            f.result(timeout=120)
        fp = ap.strategy_fingerprint
        assert all(r.get("strategy") == fp
                   for r in ap.request_log.records())
        d = ap.step(force=True)
        assert d["action"] == "hold"
        assert d["reason"] in ("below-threshold", "already-optimal")
        assert d["backend"] == "ticksim" and d["window"] == 4
        d = ap.step()
        assert d["reason"] == "no-drift" and d["drift"] == 0.0
        m = ap.metrics()["autopilot"]
        assert (m["steps"], m["swaps"], m["holds"]) == (3, 0, 3)
        assert [x["reason"] for x in m["decisions"]][::2] == [
            "insufficient-window", "no-drift"]
        assert m["window_records"] == 4
        assert m["predicted_ttft_p95_s"] > 0
        assert m["measured_ttft_p95_s"] > 0
        ap.start(interval_s=0.01)
        with pytest.raises(RuntimeError, match="already started"):
            ap.start()
        deadline = time.monotonic() + 30
        while ap.steps < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ap.steps >= 5
    finally:
        ap.stop()


def test_slo_breach_bundle_carries_the_strategy(setup, tmp_path):
    """A server serving a strategy writes strategy.json into its SLO
    breach bundle (the strategy's JSON form); a hand-built paged server
    derives its strategy from its knobs and stamps it the same way."""
    tff, pool, _ = setup
    s = ServeStrategy(page_size=8, prefill_chunk=16, megastep_ticks=4)
    srv = tff.serve_generation(
        slots=2, max_len=32, serve_strategy=s,
        slo=SLOTarget(ttft_p95_s=1e-9, min_samples=1),
        slo_dump_dir=str(tmp_path))
    try:
        srv.generate(pool[0], 4)
    finally:
        srv.stop()
    bundle = srv.slo_monitor.last_dump
    with open(os.path.join(bundle, "strategy.json")) as f:
        assert json.load(f) == s.to_json()
    srv = tff.serve_generation(slots=2, max_len=32, paged=True, page_size=8,
                               prefill_chunk=16, megastep_ticks=4)
    try:
        assert srv.serve_strategy == s
        srv.generate(pool[1], 4)
        assert srv.request_log.records()[-1]["strategy"] == s.fingerprint()
    finally:
        srv.stop()
