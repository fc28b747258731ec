"""The port's whole paged server held to the JAX reference, on the CPU:
prefix caching with copy-on-write, preemption (requeue and resume that
re-attaches cached pages), defrag under shared pages, and int8 and
mixed-dtype pools.

Each scenario is one of the reference's own (tests/test_paged.py,
tests/test_quantized_kv.py): the same prompts and server settings drive
the JAX paged server and the port's, the port's greedy tokens must equal
the JAX server's exactly (and ff.generate's, for the fp pools), and the
port's counters must meet the reference's bounds. Every drain leaves the
port's pool with no page referenced and its invariants intact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402

# fp32 on the CPU, same weights: summation order only
TOL = 1e-5
VOCAB = 512
_MODELS = []


def _models():
    """(JAX model, port model carrying the JAX weights): the tiny GQA
    causal LM of tests/test_paged.py (seed 7), built once."""
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


def _rand(rs, n):
    return rs.randint(0, VOCAB, (n,)).astype(np.int32)


def _shared(seed, sys_len, tails):
    """A system prompt of sys_len tokens, then one prompt per tail
    length: the system prompt + its own tokens."""
    rs = np.random.RandomState(seed)
    sys_prompt = _rand(rs, sys_len)
    return [np.concatenate([sys_prompt, _rand(rs, n)]) for n in tails]


# -- how a scenario submits its prompts ------------------------------------

def _concurrent(server, prompts, new):
    futs = [server.submit(p, max_new_tokens=new) for p in prompts]
    return [f.result(timeout=120) for f in futs]


def _sequential(server, prompts, new):
    return [server.submit(p, max_new_tokens=new).result(timeout=120)
            for p in prompts]


def _warm_then_concurrent(server, prompts, new, defrag=False):
    """The first prompt alone (its pages publish to the prefix cache),
    then the rest at once; with defrag, a compaction while they run."""
    first = server.submit(prompts[0], max_new_tokens=new).result(
        timeout=120)
    futs = [server.submit(p, max_new_tokens=new) for p in prompts[1:]]
    if defrag:
        server.request_defrag()
    return [first] + [f.result(timeout=120) for f in futs]


def _serve(ff, kw, drive, prompts, new):
    server = ff.serve_generation(paged=True, page_size=4, **kw)
    try:
        got = drive(server, prompts, new)
        m = server.metrics()
    finally:
        server.stop()
    return [np.asarray(g) for g in got], m, server


# -- the reference's counter bounds, read off the port's metrics ----------

def _check_shared_prefix(m, prompts):  # tests/test_paged.py:476
    later = [r for r in m["requests"] if r["cached_prefill_tokens"] > 0]
    assert len(later) >= 3, m["requests"]
    for r in later:
        assert r["cached_prefill_tokens"] / (
            r["cached_prefill_tokens"] + r["prefill_tokens"]) >= 0.5, r
    assert m["prefix_cache"]["hit_tokens"] >= 3 * 8


def _check_cache_off(m, prompts):
    assert not m["prefix_cache"]["enabled"]
    assert m["prefix_cache"]["hit_tokens"] == 0
    assert all(r["cached_prefill_tokens"] == 0 for r in m["requests"])


def _check_cow(m, prompts):  # :524
    reqs = m["requests"]
    assert reqs[1]["cached_prefill_tokens"] >= 6, reqs[1]
    assert reqs[2]["cached_prefill_tokens"] >= 5, reqs[2]


def _check_resume(m, prompts):  # :556
    assert m["preemptions"] > 0
    preempted = [r for r in m["requests"] if r["preemptions"] > 0]
    assert preempted, m["requests"]
    for r in preempted:
        assert r["cached_prefill_tokens"] >= 4, r
        assert r["prefill_tokens"] < (r["preemptions"] + 1) * 5 + \
            r["decode_tokens"], r


def _check_requeue(m, prompts):  # :345
    assert m["preemptions"] > 0
    assert m["requests_served"] == len(prompts)
    assert sum(r["preemptions"] for r in m["requests"]) == m["preemptions"]
    for r in m["requests"]:
        assert r["queue_time_s"] >= 0 and r["decode_tokens"] == 6
        assert r["pages_held_peak"] >= 1


def _check_defrag_shared(m, prompts):  # :621
    assert m["defrags"] >= 1
    assert m["prefix_cache"]["hit_tokens"] >= 2 * 8


def _cow_prompts():
    rs = np.random.RandomState(12)
    base = _rand(rs, 6)  # 1.5 pages
    ext = np.concatenate([base, _rand(rs, 3)])
    return [base, ext, base]  # donor, COW + diverge, donor rows intact


def _requeue_prompts():
    rs = np.random.RandomState(2)
    return [_rand(rs, n) for n in (5, 6, 4, 7)]


def _resume_prompts():
    rs = np.random.RandomState(13)
    return [_rand(rs, 5) for _ in range(2)]


# name: (prompts, new tokens, server kwargs, how it submits, check)
SCENARIOS = {
    "shared_prefix": (lambda: _shared(11, 8, [3] * 4), 6,
                      dict(slots=4, max_len=32), _warm_then_concurrent,
                      _check_shared_prefix),
    "shared_prefix_cache_off": (
        lambda: _shared(11, 8, [3] * 4), 6,
        dict(slots=4, max_len=32, prefix_cache=False),
        _warm_then_concurrent, _check_cache_off),
    "cow_divergence": (_cow_prompts, 5, dict(slots=2, max_len=32),
                       _sequential, _check_cow),
    "preempted_resume_reattaches": (
        _resume_prompts, 8, dict(slots=2, max_len=16, num_pages=6),
        _concurrent, _check_resume),
    "preemption_requeue": (
        _requeue_prompts, 6, dict(slots=2, max_len=16, num_pages=6),
        _concurrent, _check_requeue),
    "defrag_shared_pages": (
        lambda: _shared(15, 8, [2] * 3), 8, dict(slots=3, max_len=32),
        lambda s, p, n: _warm_then_concurrent(s, p, n, defrag=True),
        _check_defrag_shared),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_server_scenario_matches_jax_server_and_generate(name):
    jff, tff = _models()
    make, new, kw, drive, check = SCENARIOS[name]
    prompts = make()
    want = [jff.generate(p[None, :], max_new_tokens=new)[0] for p in prompts]
    jgot, _, _ = _serve(jff, kw, drive, prompts, new)
    got, m, server = _serve(tff, kw, drive, prompts, new)
    for i, (w, j, g) in enumerate(zip(want, jgot, got)):
        np.testing.assert_array_equal(j, w, err_msg=f"JAX request {i}")
        np.testing.assert_array_equal(g, j, err_msg=f"port request {i}")
    check(m, prompts)
    assert m["pages_in_use"] == 0
    server.pool.check_invariants(owners={})


def _int8_cow(server, prompts, new):
    """tests/test_quantized_kv.py:340: the system prompt alone warms the
    cache (one new token), then two requests share its quantized pages
    and diverge."""
    server.submit(prompts[0][:8], max_new_tokens=1).result(timeout=120)
    futs = [server.submit(p, max_new_tokens=new) for p in prompts]
    return [f.result(timeout=120) for f in futs]


@pytest.mark.parametrize("name,drive", [
    ("cow_quantized_shared_pages", _int8_cow),  # test_quantized_kv.py:340
    ("defrag_shared_quantized_pages",           # :370
     lambda s, p, n: _warm_then_concurrent(s, p, n, defrag=True)),
])
def test_int8_server_scenario_matches_jax_int8_server(name, drive):
    """The int8 pool through COW clones and defrag permutations (scales
    move with their pages): token-identical to the JAX int8 server.
    prefill_chunk == page_size, as in the reference, so cached pages
    quantize identically whichever request wrote them."""
    jff, tff = _models()
    prompts = _shared(15, 8, [2] * (2 if name.startswith("cow") else 3))
    kw = dict(slots=3, max_len=32, prefill_chunk=4, kv_dtype="int8")
    jgot, jm, _ = _serve(jff, kw, drive, prompts, 8)
    got, m, server = _serve(tff, kw, drive, prompts, 8)
    for i, (j, g) in enumerate(zip(jgot, got)):
        np.testing.assert_array_equal(g, j, err_msg=f"request {i}")
    assert m["kv_cache_dtype"] == jm["kv_cache_dtype"] == "int8"
    assert m["prefix_cache"]["hit_tokens"] >= 2 * 8
    if name.startswith("defrag"):
        assert m["defrags"] >= 1
    assert m["pages_in_use"] == 0
    server.pool.check_invariants(owners={})


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_ragged_step_with_int8_and_mixed_dtype_pools_matches_jax(kv_dtype):
    """The fp32 model's ragged step over an int8 pool (scales in the same
    per-node dict, carried through cache_out) and over a bf16 pool (the
    mixed-dtype route): two packed steps — two prompt chunks beside a
    pad entry, then a decode row and a chunk piece — give the reference's
    probabilities within TOL and its pools (and scales) exactly."""
    jff, tff = _models()
    jex, tex = jff.executor, tff.executor
    P, N, MAXP = 4, 16, 6
    from flexflow_tpu.paged.quant import resolve_kv_dtype as jresolve
    from flexflow_tpu_torch.paged.quant import resolve_kv_dtype
    jcaches = jex.init_paged_kv_cache(N, P, dtype=jresolve(kv_dtype))
    tcaches = tex.init_paged_kv_cache(N, P, dtype=resolve_kv_dtype(kv_dtype))
    names = {"int8": ["k", "v", "k_scale", "v_scale"],
             "bf16": ["k", "v"]}[kv_dtype]
    assert all(sorted(b) == sorted(names) for b in tcaches.values())
    tables = np.zeros((3, MAXP), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :4] = [2, 9, 5, 11]
    rs = np.random.RandomState(4)
    launches = [
        (np.array([0, 0, 0], np.int32), np.array([5, 6, 0], np.int32),
         rs.randint(0, VOCAB, (3, 6)).astype(np.int32)),
        (np.array([5, 6, 0], np.int32), np.array([1, 8, 0], np.int32),
         rs.randint(0, VOCAB, (3, 8)).astype(np.int32)),
    ]
    jstep = jex.ragged_step_fn()
    for pos, qls, ids in launches:
        W = ids.shape[1]
        deps = np.tile(np.arange(W, dtype=np.int32), (3, 1))
        anc = np.tile(np.tril(np.ones((W, W), bool)), (3, 1, 1))
        desc = (tables, pos, qls, deps, anc, ids)
        jprobs, jcaches = jstep(*jff._params, jcaches,
                                *[jnp.asarray(a) for a in desc])
        tprobs, tcaches = tex.ragged_step_fn(
            *tff._params, tcaches, *[torch.from_numpy(a) for a in desc])
        jp, tp = np.asarray(jprobs), tprobs.numpy()
        for b in range(3):
            n = int(qls[b])
            np.testing.assert_allclose(tp[b, :n], jp[b, :n], atol=TOL,
                                       rtol=TOL)
        live = sorted(set(tables[:2].ravel()) - {0})
        for key in jcaches:
            for name in names:
                got = tcaches[key][name].float().numpy()[live]
                want = np.asarray(
                    jcaches[key][name].astype(jnp.float32))[live]
                _pool_close(got, want, name, kv_dtype)


def _pool_close(got, want, name, kv_dtype):
    """The K/V rows entering the pools differ by fp32 summation order
    (~1e-7 relative) through the projections, so a stored value may sit
    on the other side of a rounding boundary: scales within 1e-6
    relative; int8 bytes off by at most 1, bf16 values by at most one
    bf16 step (2^-7 relative), each at under 1% of the elements."""
    if name.endswith("_scale"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        return
    step = 1.0 if kv_dtype == "int8" else 2.0 ** -7 * np.abs(want)
    off = got != want
    assert (np.abs(got - want) <= step).all(), name
    assert off.mean() < 0.01, (name, int(off.sum()), off.size)


def test_chip_smoke_phase7_traffic_preempts_hits_and_defrags():
    """chip_smoke.py's phase 7 (Llama-3-8B on the card) at a narrow width
    on the CPU: its page counts are host arithmetic, the same at any
    width, so its pool size must already give what the card run checks —
    every request's tokens, the 8 shared pages hit by the four requests
    admitted first, at least one preemption, a defrag, and a pool whose
    invariants hold after the drain."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = LlamaConfig(vocab_size=VOCAB, dim=32, layers=1, heads=2,
                      kv_heads=1, hidden=64, rope_theta=10000.0)
    ff = FFModel(FFConfig(batch_size=1, seed=0, device="cpu"))
    build_llama(ff, cfg, batch_size=1, seq_len=8, dtype=DataType.FLOAT)
    ff.compile()
    r = cs.serve_int8_traffic(ff, VOCAB, seed=0)
    m = r["metrics"]
    assert [len(o) for o in r["outs"]] == [cs.SERVE7_NEW] * 8
    assert m["kv_cache_dtype"] == "int8"
    assert m["prefix_cache"]["hit_tokens"] >= 4 * cs.SYS_LEN
    assert m["preemptions"] >= 1 and m["defrags"] >= 1, m
    assert m["peak_active"] == cs.SERVE7["slots"]
    assert m["pages_in_use"] == 0
