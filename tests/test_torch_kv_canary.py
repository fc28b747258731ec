"""The port's kv_quant_canary shadow cache and FF_TPU_KV_QUANT_DEBUG mode
held to the JAX reference, on the CPU, and the port's numerics budget
catalog held equal to the reference's.

The scenarios are the reference's own (tests/test_quantized_kv.py,
tests/test_megastep.py) on the tiny GQA Llama of tests/test_paged.py
with the JAX weights carried over. Every request is queued before the
first tick (defer_start), so which admissions open a window is a
function of the tokens alone and the window counts must equal the JAX
server's. The canary only observes: tokens are identical with and
without it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.analysis import num_budgets as jbudgets  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.analysis import num_budgets  # noqa: E402
from flexflow_tpu_torch.disagg import HostTier  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.spec import SpecConfig  # noqa: E402

VOCAB = 512
SHADOW_DELTA = num_budgets.tolerance("kv-canary-shadow-delta")  # abs
# |port kv_quant_error - JAX kv_quant_error|: both are the max abs
# probability delta of the same int8 pool (the same grow-only scales and
# rounding) against the same fp32 shadow; fp32 compute on the CPU differs
# in summation order only, so the two maxima agree far inside this (the
# errors themselves are ~1e-4)
ERR_AGREE = 1e-5
_MODELS = []


def _models():
    """(JAX model, port model carrying the JAX weights), built once."""
    if not _MODELS:
        kw = dict(vocab_size=VOCAB, dim=64, layers=2, heads=4, kv_heads=2,
                  hidden=128, rope_theta=10000.0)
        jff = JFFModel(JFFConfig(batch_size=1, seed=7))
        jbuild_llama(jff, JLlamaConfig(**kw), batch_size=1, seq_len=8,
                     dtype=JDataType.FLOAT)
        jff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
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


def _prompts(seed=1, lens=(8, 8, 8, 8)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]


def _serve(ff, prompts, max_new, slots=2, max_len=32, **kw):
    srv = ff.serve_generation(slots=slots, max_len=max_len, paged=True,
                              page_size=4, defer_start=True, **kw)
    try:
        futs = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
        srv.start()
        toks = [np.asarray(f.result(timeout=120)) for f in futs]
        m = srv.metrics()
    finally:
        srv.stop()
    srv.pool.check_invariants(owners={})
    return toks, m


def _equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"request {i}")


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("FF_TPU_KV_QUANT_DEBUG", raising=False)
    monkeypatch.delenv("FF_TPU_KV_QUANT_CANARY", raising=False)


def test_budget_catalog_equals_reference():
    """The port's catalog is the reference's entry for entry (value,
    kind, consumers, description), with the same required bands and
    lookups; a missing name raises KeyError in both."""
    assert set(num_budgets.BUDGETS) == set(jbudgets.BUDGETS)
    for name, b in num_budgets.BUDGETS.items():
        assert b.to_json() == jbudgets.BUDGETS[name].to_json(), name
        assert num_budgets.tolerance(name) == jbudgets.tolerance(name)
    assert num_budgets.REQUIRED_BUDGETS == jbudgets.REQUIRED_BUDGETS
    assert num_budgets.KINDS == jbudgets.KINDS
    assert num_budgets.validate_catalog() == {} == jbudgets.validate_catalog()
    with pytest.raises(KeyError, match="no numerics budget"):
        num_budgets.budget("no-such-band")


@pytest.mark.parametrize("every", [1, 2])
def test_kv_quant_canary_samples_windows(every):
    """kv_quant_canary=N opens a shadow window on every Nth admission:
    the window count equals the JAX server's on the same admissions, the
    kv_quant_error gauge populates below the catalog's band and within
    ERR_AGREE of the JAX server's, no breach is counted, the windows are
    closed once every request has left, and the tokens equal the
    canary-less int8 run's and the JAX canary run's."""
    jff, tff = _models()
    prompts = _prompts()
    plain, _ = _serve(tff, prompts, 6, kv_dtype="int8")
    got, m = _serve(tff, prompts, 6, kv_dtype="int8", kv_quant_canary=every)
    jgot, jm = _serve(jff, prompts, 6, kv_dtype="int8",
                      kv_quant_canary=every)
    _equal(got, plain)
    _equal(got, jgot)
    can, jcan = m["kv_quant_canary"], jm["kv_quant_canary"]
    assert can["windows"] == jcan["windows"] >= 1
    for key in ("every", "debug_mode", "window_open", "threshold",
                "breaches"):
        assert can[key] == jcan[key], key
    assert can["every"] == every and can["window_open"] is False
    assert can["threshold"] == SHADOW_DELTA and can["breaches"] == 0
    assert 0.0 < m["kv_quant_error"] < SHADOW_DELTA
    assert abs(m["kv_quant_error"] - jm["kv_quant_error"]) <= ERR_AGREE, (
        m["kv_quant_error"], jm["kv_quant_error"])


def test_kv_quant_debug_mode_matches_reference(monkeypatch):
    """FF_TPU_KV_QUANT_DEBUG=1 on an int8 pool: the shadow watches every
    launch of the server's life (the window stays open), megasteps are
    forced off, the tokens are the plain int8 run's, and kv_quant_error
    agrees with the JAX server's under the same flag."""
    jff, tff = _models()
    prompts = _prompts()
    plain, _ = _serve(tff, prompts, 6, kv_dtype="int8")
    monkeypatch.setenv("FF_TPU_KV_QUANT_DEBUG", "1")
    got, m = _serve(tff, prompts, 6, kv_dtype="int8", megastep_ticks=8,
                    megastep_mixed=True, overlap_dispatch=True)
    jgot, jm = _serve(jff, prompts, 6, kv_dtype="int8")
    _equal(got, plain)
    _equal(got, jgot)
    assert m["megastep"]["ticks_max"] == 1
    assert m["megastep"]["mixed"] is False
    assert m["megastep"]["overlap_dispatch"] is False
    assert m["megastep"]["dispatches"] == 0
    can = m["kv_quant_canary"]
    assert can["debug_mode"] is True and can["window_open"] is True
    assert can["every"] == 0 and can["windows"] == 0
    assert 0.0 < m["kv_quant_error"] < SHADOW_DELTA
    assert abs(m["kv_quant_error"] - jm["kv_quant_error"]) <= ERR_AGREE, (
        m["kv_quant_error"], jm["kv_quant_error"])


def test_metrics_read_the_device_only_after_a_shadow_launch():
    """metrics() reads kv_quant_error from the device only once a shadow
    launch has run: a server that never opened a window answers 0.0
    without touching it (an SLO breach calls metrics() inside a tick,
    where a device read would add a synchronizing call)."""
    _, tff = _models()

    class Unreadable:
        def __float__(self):
            raise AssertionError("metrics() read the device")

    for kw in ({}, {"kv_dtype": "int8", "kv_quant_canary": 4}):
        srv = tff.serve_generation(slots=1, max_len=16, paged=True,
                                   page_size=4, **kw)
        try:
            srv.generate(_prompts(lens=(5,))[0], 3, timeout=120)
            srv._quant_err_dev = Unreadable()
            m = srv.metrics()
        finally:
            srv.stop()
        assert m["kv_quant_error"] == 0.0 and srv.shadow_steps == 0


def test_kv_quant_canary_env_and_debug_precedence(monkeypatch):
    """FF_TPU_KV_QUANT_CANARY sets the rate without code changes;
    FF_TPU_KV_QUANT_DEBUG=1 takes precedence and disables sampling; the
    debug flag means nothing on a pool that is not quantized; a negative
    rate raises the reference's ValueError, and the dense server refuses
    the canary."""
    _, tff = _models()
    monkeypatch.setenv("FF_TPU_KV_QUANT_CANARY", "2")
    srv = tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4,
                               kv_dtype="int8")
    try:
        assert srv.metrics()["kv_quant_canary"]["every"] == 2
    finally:
        srv.stop()
    monkeypatch.setenv("FF_TPU_KV_QUANT_DEBUG", "1")
    srv = tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4,
                               kv_dtype="int8", kv_quant_canary=3)
    try:
        can = srv.metrics()["kv_quant_canary"]
        assert can["every"] == 0 and can["debug_mode"] is True
        assert can["window_open"] is True
    finally:
        srv.stop()
    srv = tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4,
                               kv_quant_canary=3)
    try:
        can = srv.metrics()["kv_quant_canary"]
        assert can["every"] == 3 and can["debug_mode"] is False
        assert can["window_open"] is False
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="kv_quant_canary"):
        tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4,
                             kv_dtype="int8", kv_quant_canary=-1)
    with pytest.raises(ValueError, match="paged"):
        tff.serve_generation(slots=1, max_len=16, kv_quant_canary=1)


def test_host_tier_with_quant_debug_raises(monkeypatch):
    """The all-launches shadow cannot observe pages a tier fetch restores
    behind its back: host_tier and FF_TPU_KV_QUANT_DEBUG=1 are refused
    together, with the reference's message; the sampled canary is not
    (its window closes on a fetch)."""
    _, tff = _models()
    monkeypatch.setenv("FF_TPU_KV_QUANT_DEBUG", "1")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4,
                             kv_dtype="int8", host_tier=HostTier(8))
    monkeypatch.delenv("FF_TPU_KV_QUANT_DEBUG")
    srv = tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4,
                               kv_dtype="int8", host_tier=8,
                               kv_quant_canary=1)
    srv.stop()


def test_canary_window_closes_on_tier_fetch():
    """A tier fetch rewrites pool content behind the shadow: a window
    open on one request closes when another request's admission fetches
    spilled pages, and the next admission opens a fresh one; the tokens
    stay those of the run without the canary."""
    _, tff = _models()
    prompts = _prompts(5, (9, 11, 6, 5))
    kw = dict(slots=2, max_len=32, num_pages=8, kv_dtype="int8",
              host_tier=64)

    def run(**extra):
        srv = tff.serve_generation(paged=True, page_size=4, **kw, **extra)
        closed = []
        write = srv._tier_write_page

        def watch(page, payload):
            was_open = srv._canary_req is not None
            write(page, payload)
            closed.append(was_open and srv._canary_req is None)

        srv.pool._tier_write = watch
        try:
            # three prompts one at a time (the first's pages spill), then
            # a fresh prompt (its window opens) beside the first again
            # (its admission fetches)
            got = [np.asarray(srv.submit(p, 5).result(timeout=120))
                   for p in prompts[:3]]
            futs = [srv.submit(p, 5) for p in (prompts[3], prompts[0])]
            got += [np.asarray(f.result(timeout=120)) for f in futs]
            m = srv.metrics()
        finally:
            srv.stop()
        srv.pool.check_invariants(owners={})
        return got, m, closed

    plain, _, _ = run()
    got, m, closed = run(kv_quant_canary=1)
    _equal(got, plain)
    assert m["host_tier"]["fetched_pages"] > 0
    assert any(closed), closed
    assert m["kv_quant_canary"]["windows"] >= 4
    assert m["kv_quant_canary"]["window_open"] is False


@pytest.mark.parametrize("mixed", [False, True], ids=["decode", "mixed"])
def test_megastep_canary_stand_down_dynamic(mixed):
    """A canary window opens on any admission mid-serve, so both megastep
    flavors stand down dynamically: with canary=1 the window is open for
    the whole request, every dispatch takes the one-tick path, no fused
    break is recorded, and the tokens are the plain server's."""
    _, tff = _models()
    p = _prompts(26, (5,))[0]
    want, _ = _serve(tff, [p], 10, max_len=64)
    kw = dict(megastep_ticks=8, megastep_mixed=mixed)
    got, m = _serve(tff, [p], 10, max_len=64, prefill_chunk=8,
                    kv_quant_canary=1, **kw)
    _equal(got, want)
    assert m["kv_quant_canary"]["windows"] == 1
    ms = m["megastep"]
    assert sum(ms["breaks"].values()) == 0 and ms["dispatches"] == 0
    assert ms["decode_tokens"] > 0
    assert m["kv_quant_error"] < SHADOW_DELTA


def test_kv_quant_canary_with_megastep():
    """An open window forces the one-tick path; between windows the
    megastep fuses as always, and the tokens equal the canary-less
    megastep run's."""
    _, tff = _models()
    prompts = _prompts()
    # one slot: every second request decodes with its window open, the
    # others fuse their ticks
    plain, _ = _serve(tff, prompts, 8, slots=1, kv_dtype="int8",
                      megastep_ticks=8)
    got, m = _serve(tff, prompts, 8, slots=1, kv_dtype="int8",
                    megastep_ticks=8, kv_quant_canary=2)
    _equal(got, plain)
    assert m["kv_quant_canary"]["windows"] == 2
    assert m["kv_quant_error"] > 0.0
    assert m["megastep"]["dispatches"] > 0


def test_canary_on_speculative_server():
    """The speculative server's verify launches replay against the shadow
    and its accepted-path commit lands in the shadow too: tokens equal
    the canary-less speculative run's and the error stays in band."""
    _, tff = _models()
    prompts = _prompts(3, (6, 8, 5))
    spec = SpecConfig(width=2, depth=3)
    plain, _ = _serve(tff, prompts, 8, kv_dtype="int8", speculate=spec)
    got, m = _serve(tff, prompts, 8, kv_dtype="int8", speculate=spec,
                    kv_quant_canary=1)
    _equal(got, plain)
    assert m["speculative"]["steps"] > 0
    assert m["kv_quant_canary"]["windows"] >= 1
    assert 0.0 < m["kv_quant_error"] < SHADOW_DELTA
