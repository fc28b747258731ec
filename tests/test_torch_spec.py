"""The port's speculative decoding (flexflow_tpu_torch.spec) held to the
JAX reference (flexflow_tpu.spec), on the CPU.

Unit level: SpecConfig, the token trie, the ancestor masks, the greedy
accept walk and the n-gram drafter against the reference's functions on
the same seeded numpy inputs (exact); the accepted-path commit against
JAX's paged_commit_fn on the same pools, tables and rows (fp pools exact;
int8 pools byte- and scale-exact, as tests/test_torch_quant.py holds the
append); the tree-verify step against JAX's verify_fn (probabilities and
pools to TOL). End to end: the port's SpeculativePagedServer emits the
JAX SpeculativePagedServer's greedy tokens exactly (GQA, MHA, an int8
pool, a tight pool that preempts), reaches >= 1.5 tokens a verify step on
the token-cyclic fixture, and its capacity guard counts the tree's rows.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu import spec as jspec  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.spec.fixtures import make_token_cyclic as jcyclic  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch import spec as tspec  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.spec.fixtures import make_token_cyclic  # noqa: E402

# fp32 on the CPU, same weights: differences are summation order only
TOL = 1e-5
_MODELS = {}


def _models(kv_heads=2, vocab=512, cyclic=False):
    """(JAX model, port model carrying the JAX weights) of the tiny Llama
    of tests/test_spec.py (dim 64, 2 layers, 4 heads, fp32, seed 7),
    built once per (kv_heads, vocab, cyclic); `cyclic` applies each
    package's make_token_cyclic to its own copy."""
    key = (kv_heads, vocab, cyclic)
    if key not in _MODELS:
        kw = dict(vocab_size=vocab, dim=64, layers=2, heads=4,
                  kv_heads=kv_heads, hidden=128, rope_theta=10000.0)
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
        if cyclic:
            jcyclic(jff)
            make_token_cyclic(tff)
        _MODELS[key] = (jff, tff)
    return _MODELS[key]


def _serve(ff, prompts, new, speculate, temperature=0.0, **kw):
    """Submit every prompt before the loop starts (defer_start), so the
    schedule is a function of the tokens alone; returns (tokens,
    metrics, server)."""
    server = ff.serve_generation(paged=True, speculate=speculate,
                                 defer_start=True, **kw)
    try:
        futs = [server.submit(p, max_new_tokens=new, temperature=temperature)
                for p in prompts]
        server.start()
        got = [np.asarray(f.result(timeout=120)) for f in futs]
        m = server.metrics()
    finally:
        server.stop()
    return got, m, server


# ---------------------------------------------------------------------------
# host-side pieces: config, trie, ancestor masks, accept walk, drafter


def test_spec_config_matches_reference():
    """Validation raises where the reference's does; max_nodes and the
    expected tokens a step equal the reference's."""
    assert tspec.SpecConfig(width=2, depth=4).max_nodes == 9
    for kw in ({"width": 0}, {"depth": 0}, {"min_ngram": 3, "max_ngram": 2}):
        with pytest.raises(ValueError):
            jspec.SpecConfig(**kw)
        with pytest.raises(ValueError):
            tspec.SpecConfig(**kw)
    for drafter in ("model", "nope"):
        with pytest.raises(ValueError):
            tspec.SpecConfig(drafter=drafter).build_drafter()
    for spec in (tspec, jspec):
        with pytest.raises(ValueError, match="COMPILED"):
            spec.SpecConfig(drafter="model",
                            draft_model=object()).build_drafter()
    assert isinstance(tspec.SpecConfig().build_drafter(), tspec.NgramDrafter)
    for w, d in ((1, 1), (2, 4), (3, 2)):
        t, j = tspec.SpecConfig(width=w, depth=d), jspec.SpecConfig(
            width=w, depth=d)
        assert t.max_nodes == j.max_nodes
        for a in (0.0, 0.3, 0.9, 1.0):
            assert t.expected_tokens_per_step(a) == \
                j.expected_tokens_per_step(a)


def _chains(rs, width, depth, vocab=6):
    """Drafted chains over a small vocabulary, so they share prefixes."""
    return [rs.randint(0, vocab, rs.randint(1, depth + 1)).astype(np.int32)
            for _ in range(width)]


@pytest.mark.parametrize("seed", range(6))
def test_tree_masks_and_walk_match_reference(seed):
    """build_tree (shared prefixes merged, capped at max_nodes, chains
    clamped at max_depth), ancestor_masks over a batch of trees, and
    accept_greedy on argmaxes that follow the tree for a while, all
    exactly as the reference's."""
    rs = np.random.RandomState(seed)
    T = int(rs.choice([4, 7, 9]))
    parents, trees = [], []
    for _ in range(3):
        chains = _chains(rs, 3, 5)
        root = int(rs.randint(0, 6))
        t = tspec.build_tree(root, chains, T, max_depth=4)
        j = jspec.build_tree(root, chains, T, max_depth=4)
        for f in ("tokens", "parents", "depths", "valid"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert t.n_nodes == j.n_nodes and t.children == j.children
        parents.append(t.parents)
        trees.append((t, j))
    np.testing.assert_array_equal(
        tspec.ancestor_masks(np.stack(parents)),
        jspec.ancestor_masks(np.stack(parents)))
    for t, j in trees:
        # each node's argmax is one of its children's tokens half the time
        preds = rs.randint(0, 6, T).astype(np.int32)
        for node in range(T):
            if t.children[node] and rs.rand() < 0.5:
                preds[node] = list(t.children[node])[0]
        assert tspec.accept_greedy(t, preds) == jspec.accept_greedy(j, preds)


def test_build_tree_cap():
    """Insertion stops at max_nodes, as the reference's does."""
    chains = [np.arange(1, 6), np.arange(10, 15)]
    t = tspec.build_tree(0, chains, 6)
    assert t.n_nodes == 6 == jspec.build_tree(0, chains, 6).n_nodes


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_matches_reference(seed):
    """Prompt lookup on repetitive seeded contexts: the port's chains
    equal the reference's, for several n-gram ranges and tree shapes."""
    rs = np.random.RandomState(seed)
    ctx = np.concatenate([rs.randint(0, 5, rs.randint(4, 9))
                          for _ in range(5)]).astype(np.int32)
    for lo, hi in ((1, 1), (1, 3), (2, 4)):
        for width, depth in ((1, 3), (2, 4), (4, 2)):
            got = tspec.NgramDrafter(lo, hi).draft(ctx, width, depth)
            want = jspec.NgramDrafter(lo, hi).draft(ctx, width, depth)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the accepted-path commit and the tree-verify step against the reference's


def _commit_case(seed, quantized):
    """Pools of 8 pages of 4 rows (Hkv 2, D 8) holding seeded rows, 3
    slots' tables, and (slots, C=4) src/dst rows of an accept outcome
    each: slot 0 commits a 3-row path from pos 6, whose first
    destination page (1) takes a row from page 2, given the larger
    scales, so the commit re-quantizes page 1 while its own row 6 is a
    source; slot 1 commits one row (the bonus alone); slot 2 is idle
    (self-copies of row 0 on the null page)."""
    rs = np.random.RandomState(seed)
    N, P, Hkv, D = 8, 4, 2, 8
    tables = np.array([[3, 1, 2, 5], [4, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    src = np.array([[6, 8, 11, 6], [9, 9, 9, 9], [0, 0, 0, 0]], np.int32)
    dst = np.array([[6, 7, 8, 6], [9, 9, 9, 9], [0, 0, 0, 0]], np.int32)
    bufs = {}
    for n in ("k", "v"):
        x = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
        if quantized:
            sc = rs.uniform(0.01, 0.02, (N, Hkv)).astype(np.float32)
            sc[2] = rs.uniform(0.05, 0.06, Hkv)  # page 2 > page 1
            bufs[n] = rs.randint(-127, 128, (N, P, Hkv, D)).astype(np.int8)
            bufs[n + "_scale"] = sc
        else:
            bufs[n] = x
    return {"l0_attn_2": bufs}, tables, src, dst


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_commit_matches_reference(quantized, seed):
    """The port's paged_commit_fn leaves the pools exactly as JAX's: fp
    rows copied bit for bit; int8 bytes and scales equal, including a
    source row on a page the same commit re-quantizes."""
    jff, tff = _models()
    caches, tables, src, dst = _commit_case(seed, quantized)
    want = jff.executor.paged_commit_fn()(
        {k: {n: jnp.asarray(a) for n, a in b.items()}
         for k, b in caches.items()},
        jnp.asarray(tables), jnp.asarray(src), jnp.asarray(dst))
    tcaches = {k: {n: torch.from_numpy(a.copy()) for n, a in b.items()}
               for k, b in caches.items()}
    got = tff.executor.paged_commit_fn(
        tcaches, torch.from_numpy(tables), torch.from_numpy(src),
        torch.from_numpy(dst))
    for k, b in want.items():
        for n, a in b.items():
            np.testing.assert_array_equal(got[k][n].numpy(), np.asarray(a),
                                          err_msg=f"{k}/{n}")
    if quantized:
        # page 1 took a row from page 2: its scale grew, its rows moved
        new = got["l0_attn_2"]["k_scale"].numpy()
        old = caches["l0_attn_2"]["k_scale"]
        assert (new[1] > old[1]).all() and (new[2] == old[2]).all()
        assert not np.array_equal(got["l0_attn_2"]["k"].numpy()[1, 0],
                                  caches["l0_attn_2"]["k"][1, 0])


def test_verify_fn_matches_reference():
    """One tree-verify step at pos 5 and 9 over seeded pools, with two
    real trees (one padded past its live nodes): probabilities to TOL and
    the written pools to TOL, against JAX's verify_fn."""
    jff, tff = _models()
    rs = np.random.RandomState(3)
    T, P, N = 7, 4, 12
    trees = [tspec.build_tree(5, [np.array([1, 2, 3]), np.array([1, 4])],
                              T),
             tspec.build_tree(9, [np.array([7])], T)]
    assert trees[1].n_nodes < T
    tokens = np.stack([t.tokens for t in trees])
    depths = np.stack([t.depths for t in trees])
    anc = tspec.ancestor_masks(np.stack([t.parents for t in trees]))
    pos = np.array([5, 9], np.int32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    specs = tff.executor.paged_kv_cache_specs(N, P)
    pools = {k: {n: rs.standard_normal(shape).astype(np.float32)
                 for n, (shape, _) in b.items()} for k, b in specs.items()}
    jtr, jntr = jff._params
    jp, jc = jff.executor.verify_fn()(
        jtr, jntr, {k: {n: jnp.asarray(a) for n, a in b.items()}
                    for k, b in pools.items()},
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(depths),
        jnp.asarray(anc), jnp.asarray(tokens))
    ttr, tntr = tff._params
    tp, tc = tff.executor.verify_fn(
        ttr, tntr, {k: {n: torch.from_numpy(a.copy()) for n, a in b.items()}
                    for k, b in pools.items()},
        torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(depths), torch.from_numpy(anc),
        torch.from_numpy(tokens))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL,
                               rtol=TOL)
    for k in jc:
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[k][n].numpy(),
                                       np.asarray(jc[k][n]), atol=TOL,
                                       rtol=TOL)


# ---------------------------------------------------------------------------
# served tokens: the port's speculative server against the reference's


@pytest.mark.parametrize("kv_heads", [2, 4], ids=["gqa", "mha"])
def test_spec_server_matches_reference(kv_heads):
    """Greedy speculative serving emits exactly the JAX speculative
    server's tokens (prompts across page boundaries, staggered lengths,
    drafts mostly rejected on a random model), with the same verify
    steps and acceptance counters, and frees every page."""
    jff, tff = _models(kv_heads)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (3, 8, 5, 2, 6)]
    kw = dict(slots=2, max_len=32, page_size=4)
    sc = dict(width=2, depth=3)
    want, jm, _ = _serve(jff, prompts, 5, jspec.SpecConfig(**sc), **kw)
    got, m, server = _serve(tff, prompts, 5, tspec.SpecConfig(**sc), **kw)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert m["speculative"] == jm["speculative"]
    assert m["speculative"]["steps"] == m["decode_steps"] > 0
    assert m["requests_served"] == len(prompts)
    assert m["pages_in_use"] == 0
    server.pool.check_invariants(owners={})


def test_spec_acceptance_on_cyclic_fixture():
    """On the token-cyclic fixture the n-gram drafter reaches >= 1.5
    tokens a verify step (the reference's contract, tests/test_spec.py:
    237) while the stream equals the JAX speculative server's; fewer
    verify steps than the plain server's ticks; the per-request rates
    are recorded; and a sampled request on the same server decodes
    through the root's draw."""
    jff, tff = _models(vocab=64, cyclic=True)
    rs = np.random.RandomState(1)
    prompt = rs.randint(0, 64, (6,)).astype(np.int32)
    kw = dict(slots=2, max_len=64, page_size=8)
    sc = dict(width=2, depth=4)
    want, jm, _ = _serve(jff, [prompt], 40, jspec.SpecConfig(**sc), **kw)
    got, m, _ = _serve(tff, [prompt], 40, tspec.SpecConfig(**sc), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    spec = m["speculative"]
    assert spec == jm["speculative"]
    assert spec["accepted_tokens_per_step"] >= 1.5, spec
    assert 0.0 < spec["acceptance_rate"] <= 1.0
    assert m["decode_steps"] < 39  # the plain server's decode ticks
    assert m["requests"][0]["spec_accepted_tokens_per_step"] >= 1.5
    sampled, _, _ = _serve(tff, [prompt], 6, tspec.SpecConfig(**sc),
                           temperature=0.9, **kw)
    assert len(sampled[0]) == 6 and (sampled[0] < 64).all()


def test_spec_eos_mid_acceptance():
    """An eos inside an accepted run truncates the emitted tokens there,
    so a request can finish inside one verify step; the stream equals the
    JAX speculative server's."""
    jff, tff = _models(vocab=64, cyclic=True)
    rs = np.random.RandomState(1)
    prompt = rs.randint(0, 64, (6,)).astype(np.int32)
    plain, _, _ = _serve(tff, [prompt], 8, None, slots=2, max_len=64,
                         page_size=8)
    eos = int(plain[0][5])
    kw = dict(slots=2, max_len=64, page_size=8, eos_id=eos)
    want, _, _ = _serve(jff, [prompt], 40, jspec.SpecConfig(), **kw)
    got, _, _ = _serve(tff, [prompt], 40, tspec.SpecConfig(), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0][-1] == eos and eos not in got[0][:-1]


def test_spec_preemption_stays_correct():
    """A pool too tight for both slots' trees: preemption and requeue
    under speculation reproduce the JAX server's tokens and preemption
    count, and every page comes back."""
    jff, tff = _models()
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 6, 4, 7)]
    kw = dict(slots=2, max_len=16, page_size=4, num_pages=10)
    sc = dict(width=1, depth=2)
    want, jm, _ = _serve(jff, prompts, 6, jspec.SpecConfig(**sc), **kw)
    got, m, server = _serve(tff, prompts, 6, tspec.SpecConfig(**sc), **kw)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert m["preemptions"] == jm["preemptions"]
    assert m["pages_in_use"] == 0
    server.pool.check_invariants(owners={})


def test_spec_int8_pool_matches_reference():
    """Speculation over an int8 pool (the scale-aware commit) emits the
    JAX int8 speculative server's tokens, on the token-cyclic fixture
    where paths are accepted and committed across pages."""
    jff, tff = _models(vocab=64, cyclic=True)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 64, (n,)).astype(np.int32) for n in (6, 9)]
    kw = dict(slots=2, max_len=64, page_size=4, kv_dtype="int8")
    want, jm, _ = _serve(jff, prompts, 24, jspec.SpecConfig(), **kw)
    got, m, server = _serve(tff, prompts, 24, tspec.SpecConfig(), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert m["kv_cache_dtype"] == "int8"
    assert m["speculative"] == jm["speculative"]
    assert m["speculative"]["accepted_tokens"] > 0
    server.pool.check_invariants(owners={})


def test_spec_capacity_guard_counts_tree_rows():
    """submit() refuses a request whose prompt + max_new + tree scratch
    cannot fit the pool (8 + 4 - 1 + 9 = 20 rows > 3 pages of 4), which
    the non-speculative server on the same pool admits (12 rows)."""
    _, tff = _models()
    kw = dict(slots=1, max_len=16, paged=True, page_size=4, num_pages=4)
    prompt = np.arange(1, 9, dtype=np.int32)
    server = tff.serve_generation(speculate=tspec.SpecConfig(width=2,
                                                             depth=3), **kw)
    try:
        with pytest.raises(ValueError, match="pages"):
            server.submit(prompt, max_new_tokens=4)
    finally:
        server.stop()
    plain = tff.serve_generation(**kw)
    try:
        assert len(plain.generate(prompt, 4, timeout=120)) == 4
    finally:
        plain.stop()


def test_spec_requires_paged_and_a_spec_config():
    _, tff = _models()
    with pytest.raises(ValueError, match="paged"):
        tff.serve_generation(slots=1, max_len=16,
                             speculate=tspec.SpecConfig())
    with pytest.raises(TypeError):
        tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4,
                             speculate="ngram")
