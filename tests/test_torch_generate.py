"""The port's dense KV-cache path held to the JAX reference on the CPU:
the MHA lowering's dense-cache branch (cached_attention, against
jax_ops.cached_attention at a scalar and at a per-row position, GQA and
rope, to OP_TOL), the executor's dense caches, FFModel.generate (a tiny
Llama, a tiny GPT-2 with its position-table guard, a ring-built Llama
decoding through the MHA cache branch), the dense GenerationServer
(serve_generation's default) and the draft-model drafter. Greedy tokens
are compared exactly; sampled tokens match JAX in distribution only
(torch.Generator is not jax.random), so they are held to the port's own
determinism. Weights go across with runtime.weights.params_from_numpy.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from flexflow_tpu.models.gpt2 import build_gpt2 as jbuild_gpt2  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.spec import SpecConfig as JSpecConfig  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.serving import GenerationServer  # noqa: E402
from flexflow_tpu_torch.spec import (  # noqa: E402
    DraftModelDrafter,
    SpecConfig,
)

OP_TOL = 1e-5  # fp32, same inputs: summation order only
VOCAB = 512


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


def _carry(jff, tff):
    """Compile the port's model with the JAX model's weights."""
    return tff.compile(params=params_from_numpy(
        *map(_np_tree, jff._params), device="cpu"))


def _llama_pair(seed=7, mesh_shape=None, ring=False, seq_len=8):
    """The tiny GQA Llama of tests/test_megastep.py in each package (fp32,
    vocab 512, dim 64, 2 layers, 4 / 2 heads), the port's carrying the
    JAX weights; `ring` builds it with use_ring_attention."""
    kw = dict(vocab_size=VOCAB, dim=64, layers=2, heads=4, kv_heads=2,
              hidden=128, rope_theta=10000.0)
    jff = JFFModel(JFFConfig(batch_size=1, seed=seed, mesh_shape=mesh_shape))
    jbuild_llama(jff, JLlamaConfig(**kw), batch_size=1, seq_len=seq_len,
                 dtype=JDataType.FLOAT, use_ring_attention=ring)
    jff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = FFModel(FFConfig(batch_size=1, seed=seed, device="cpu",
                           mesh_shape=mesh_shape))
    build_llama(tff, LlamaConfig(**kw), batch_size=1, seq_len=seq_len,
                dtype=DataType.FLOAT, use_ring_attention=ring)
    return jff, _carry(jff, tff)


@pytest.fixture(scope="module")
def lm():
    return _llama_pair()


def _prompts(seed, lens, vocab=VOCAB):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# the lowering's dense-cache branch


def _cache_case(pos, S, seed, B=2, T=16, H=4, Hkv=2, D=8):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    ck, cv = (rs.standard_normal((B, T, Hkv, D)).astype(np.float32)
              for _ in range(2))
    return q, k, v, ck, cv


@pytest.mark.parametrize("pos,S", [(0, 5), (6, 1), (13, 4),
                                   ("vector", 1), ("vector", 3)],
                         ids=["prefill", "decode", "clamped", "vec_decode",
                              "vec_chunk"])
def test_cached_attention_matches_jax(pos, S):
    """Rope at absolute positions, the K/V write (a scalar position, the
    start clamped where the rows would run past the buffer, or per-row
    positions) and the masked attention over the whole buffer, with GQA,
    against jax_ops.cached_attention: output and both caches."""
    q, k, v, ck, cv = _cache_case(pos, S, seed=S)
    if pos == "vector":
        jpos, tpos = jnp.asarray([2, 9], jnp.int32), torch.tensor(
            [2, 9], dtype=torch.int32)
    else:
        jpos, tpos = pos, pos
    want = jax_ops.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ck),
        jnp.asarray(cv), jpos, scale=0.3, rope_theta=10000.0)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = torch_ops.cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tck, tcv, tpos, scale=0.3, rope_theta=10000.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OP_TOL,
                                   rtol=OP_TOL)
    assert got[1] is tck and got[2] is tcv  # written in place


def test_init_kv_cache_matches_jax(lm):
    """One (batch, max_len, Hkv, D) "k"/"v" pair per attention node under
    the reference's node keys, at the activation dtype unless given."""
    jff, tff = lm
    want = jff.executor.init_kv_cache(3, 20)
    got = tff.executor.init_kv_cache(3, 20)
    assert sorted(got) == sorted(want)
    for key, bufs in want.items():
        assert sorted(got[key]) == ["k", "v"]
        for name, w in bufs.items():
            assert tuple(got[key][name].shape) == tuple(w.shape)
            assert got[key][name].dtype == torch.float32
            assert not got[key][name].any()
    bf = tff.executor.init_kv_cache(1, 4, dtype=torch.bfloat16)
    assert all(b.dtype == torch.bfloat16 for bufs in bf.values()
               for b in bufs.values())


# ---------------------------------------------------------------------------
# FFModel.generate


def test_generate_llama_matches_jax(lm):
    """Greedy tokens of a batch of two prompts equal JAX generate's; a
    sampled run is a function of its seed."""
    jff, tff = lm
    x = np.stack(_prompts(1, (7, 7)))
    want = np.asarray(jff.generate(x, max_new_tokens=10))
    got = tff.generate(x, max_new_tokens=10)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2, 10)
    s1 = tff.generate(x, max_new_tokens=6, temperature=0.9, seed=4)
    s2 = tff.generate(x, max_new_tokens=6, temperature=0.9, seed=4)
    np.testing.assert_array_equal(s1, s2)
    assert ((0 <= s1) & (s1 < VOCAB)).all()
    with pytest.raises(ValueError, match="max_new_tokens"):
        tff.generate(x, max_new_tokens=0)


def test_generate_gpt2_matches_jax_and_guards_positions():
    """A tiny GPT-2 (learned position table of 32 rows): greedy tokens
    equal JAX generate's through the table's scalar-position rows, and a
    request past the table raises as the reference's does."""
    jff = JFFModel(JFFConfig(batch_size=1, seed=3))
    jbuild_gpt2(jff, JGPT2Config.tiny(256), batch_size=1, seq_len=32,
                dtype=JDataType.FLOAT)
    jff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = FFModel(FFConfig(batch_size=1, seed=3, device="cpu"))
    build_gpt2(tff, GPT2Config.tiny(256), batch_size=1, seq_len=32,
               dtype=DataType.FLOAT)
    _carry(jff, tff)
    for n in (5, 12):
        x = _prompts(n, (n,), vocab=256)[0][None]
        np.testing.assert_array_equal(
            tff.generate(x, max_new_tokens=8),
            np.asarray(jff.generate(x, max_new_tokens=8)))
    for ff in (jff, tff):
        with pytest.raises(ValueError, match="position table"):
            ff.generate(np.zeros((1, 30), np.int32), max_new_tokens=3)


def test_generate_ring_llama_matches_jax():
    """A Llama built with ring attention on a {"seq": 4} mesh decodes
    through the MHA lowering's dense-cache branch in both packages: the
    greedy tokens are equal."""
    jff, tff = _llama_pair(seed=3, mesh_shape={"seq": 4}, ring=True,
                           seq_len=32)
    x = _prompts(8, (9,))[0][None]
    np.testing.assert_array_equal(
        tff.generate(x, max_new_tokens=6),
        np.asarray(jff.generate(x, max_new_tokens=6)))


# ---------------------------------------------------------------------------
# the dense GenerationServer


def _serve_all(server, prompts, new, temps=None, deferred=False):
    """Submit every prompt, start the loop of a server built with
    defer_start=True, and return the tokens."""
    temps = temps or [0.0] * len(prompts)
    try:
        futs = [server.submit(p, max_new_tokens=new, temperature=t)
                for p, t in zip(prompts, temps)]
        if deferred:
            server.start()
        return [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        server.stop()


def test_dense_server_matches_jax(lm):
    """serve_generation() at its defaults is the dense GenerationServer;
    its greedy tokens (more requests than slots, prompts of 3..14 tokens)
    equal the JAX dense server's and generate's, and a sampled request
    rides the same ticks."""
    jff, tff = lm
    prompts = _prompts(3, (3, 9, 5, 14, 6))
    server = tff.serve_generation(slots=3, max_len=64, defer_start=True)
    assert isinstance(server, GenerationServer)
    got = _serve_all(server, prompts + [prompts[0]], 8,
                     [0.0] * 5 + [0.8], deferred=True)
    jserver = jff.serve_generation(slots=3, max_len=64)
    try:
        want = [np.asarray(f.result(timeout=120)) for f in
                [jserver.submit(p, max_new_tokens=8) for p in prompts]]
    finally:
        jserver.stop()
    for w, g, p in zip(want, got, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, np.asarray(jff.generate(p[None], max_new_tokens=8)[0]))
    assert len(got[5]) == 8
    m = server.metrics()
    assert m["requests_served"] == 6


def test_dense_server_eos_and_refusals(lm):
    """An eos ends a request at that token, as in the paged server; the
    reference's paged-only knobs refuse the dense server with its
    ValueErrors."""
    _, tff = lm
    p = _prompts(4, (6,))[0]
    free = tff.generate(p[None], max_new_tokens=8)[0]
    server = tff.serve_generation(slots=2, max_len=32, eos_id=int(free[3]))
    got = _serve_all(server, [p], 8)[0]
    np.testing.assert_array_equal(got, free[:list(free).index(free[3]) + 1])
    for kw, match in (({"kv_dtype": "int8"}, "kv_dtype"),
                      ({"kv_quant_canary": 2}, "paged"),
                      ({"host_tier": 8}, "paged"),
                      ({"megastep_ticks": 4}, "paged"),
                      ({"speculate": SpecConfig()}, "paged")):
        with pytest.raises(ValueError, match=match):
            tff.serve_generation(slots=2, max_len=32, **kw)
    server = GenerationServer(tff, slots=2, max_len=8)
    try:
        with pytest.raises(ValueError, match="max_len"):
            server.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the draft-model drafter


def test_draft_model_drafter_matches_jax(lm):
    """A second tiny Llama (seed 11) drafts for the speculative server
    through its dense generate: its chains equal the JAX drafter's, and
    the served greedy tokens equal the JAX speculative server's and the
    target's generate; the target drafting for itself has every draft
    accepted."""
    jff, tff = lm
    jdraft, tdraft = _llama_pair(seed=11)
    ctx = _prompts(5, (9,))[0]
    from flexflow_tpu.spec.drafter import DraftModelDrafter as JDrafter

    np.testing.assert_array_equal(
        DraftModelDrafter(tdraft).draft(ctx, 2, 3)[0],
        JDrafter(jdraft).draft(ctx, 2, 3)[0])
    prompts = _prompts(6, (4, 7))
    got = _serve_all(tff.serve_generation(
        paged=True, slots=2, max_len=64, page_size=4, defer_start=True,
        speculate=SpecConfig(drafter="model", draft_model=tdraft, depth=3)),
        prompts, 6, deferred=True)
    jserver = jff.serve_generation(
        paged=True, slots=2, max_len=64, page_size=4,
        speculate=JSpecConfig(drafter="model", draft_model=jdraft, depth=3))
    want = _serve_all(jserver, prompts, 6)
    for w, g, p in zip(want, got, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, np.asarray(jff.generate(p[None], max_new_tokens=6)[0]))
    server = tff.serve_generation(
        paged=True, slots=2, max_len=64, page_size=4, defer_start=True,
        speculate=SpecConfig(drafter=DraftModelDrafter(tff), depth=3))
    _serve_all(server, prompts, 6, deferred=True)
    spec = server.metrics()["speculative"]
    assert spec["accepted_tokens"] >= spec["steps"] > 0
    with pytest.raises(ValueError, match="COMPILED"):
        DraftModelDrafter(object())
