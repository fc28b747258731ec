"""The port's universal (mixed) megastep, overlap_dispatch and the
unpacked launch (ragged_pack=False), held to the JAX reference on the
CPU.

Executor level: Executor.paged_mixed_megastep_fn against the reference's
on the same pools, page tables, token ledger and inputs (a decode row, a
prefill row, a drafting row at depth 3 and an idle slot), with a room
stop, a chunk stop and an eos stop: tokens, counts, flags, ticks and the
ledger exactly, the pools to 1e-5 (fp32, summation order). The port
enqueues every tick and the device predicates off the ones the
reference's loop does not run.

Server level, the scenarios of tests/test_megastep.py:330-500: greedy
tokens equal the JAX package's dense generate, fixed-seed sampled tokens
do not depend on the fusion width (torch.Generator is not jax.random, so
they match JAX in distribution only), and the pool's invariants hold at
every resume. Then the unpacked launch of tests/test_paged.py:690 and
tests/test_spec.py:326: tokens identical, and a larger padded-row share.
Tokens are compared exactly; the model is the tiny Llama of
tests/test_megastep.py (vocab 512, dim 64, 2 layers, 4/2 heads, fp32,
seed 7) with the JAX weights on both sides.
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
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.paged.scheduler import PagedGenerationServer  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.spec import SpecConfig  # noqa: E402

VOCAB = 512
POOL_TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    """(JAX model, port model carrying the JAX weights)."""
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
        {k: {n: np.asarray(a) for n, a in w.items()} for k, w in jtr.items()},
        {k: {n: np.asarray(a) for n, a in w.items()}
         for k, w in jntr.items()}, device="cpu"))
    return jff, tff


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def dense_tokens(lm):
    """JAX generate's greedy tokens ({prompt seed: [tokens]}) for the
    scenarios' prompts: 3, 9, 5 and 14 tokens, 12 new each."""
    jff, _ = lm
    return {seed: [np.asarray(jff.generate(p[None, :], max_new_tokens=12)[0])
                   for p in _prompts(seed, (3, 9, 5, 14))]
            for seed in (21, 23, 24, 25)}


def _serve(ff, prompts, new, temperature=0.0, cls=None, **kw):
    """Queue every request before the loop starts (defer_start), serve,
    and return (tokens, metrics, server)."""
    kw = {"slots": 4, "max_len": 64, "page_size": 4, "prefill_chunk": 4,
          **kw}
    server = (cls(ff, defer_start=True, **kw) if cls is not None
              else ff.serve_generation(paged=True, defer_start=True, **kw))
    temps = (temperature if isinstance(temperature, (list, tuple))
             else [temperature] * len(prompts))
    try:
        futs = [server.submit(p, max_new_tokens=new, temperature=t)
                for p, t in zip(prompts, temps)]
        server.start()
        got = [np.asarray(f.result(timeout=120)) for f in futs]
        m = server.metrics()
    finally:
        server.stop()
    assert m["pages_in_use"] == 0
    server.pool.check_invariants(owners={})
    return got, m, server


# ---------------------------------------------------------------------------
# executor parity: the port's paged_mixed_megastep_fn against the JAX one

SLOTS, PAGE, NPAGES, MAXP, DEPTH, WINDOW = 4, 4, 40, 8, 3, 4


def _mixed_inputs(lm, case):
    """Random pools and tables, a token ledger and the per-slot state of
    one tick mix: slot 0 decodes, slot 1 prefills (its chunk completes on
    the third tick in "chunk", later otherwise), slot 2 drafts at depth 3
    (its last token occurs earlier in its row, so the draft is a real
    chain), slot 3 is idle. In "room" slot 0's pages end after its third
    write row."""
    jff, _ = lm
    rs = np.random.RandomState({"room": 1, "chunk": 2, "eos": 3}[case])
    specs = jff.executor.paged_kv_cache_specs(NPAGES, PAGE)
    pools = {k: {n: rs.standard_normal(s.shape).astype(np.float32)
                 for n, s in b.items()} for k, b in specs.items()}
    tables = (rs.permutation(NPAGES - 1)[:SLOTS * MAXP] + 1).reshape(
        SLOTS, MAXP).astype(np.int32)
    L = MAXP * PAGE
    seq = np.zeros((SLOTS, L + 1), np.int32)
    seq[:, :L] = rs.randint(0, VOCAB, (SLOTS, L))
    pos = np.array([6, 0, 9, 0], np.int32)
    seq[2, 3] = seq[2, 9]  # slot 2's last token recurs: a 3-token draft
    pf_pos = np.array([0, 3, 0, 0], np.int32)
    pf_target = np.array([0, 3 + (2 * WINDOW + 1 if case == "chunk"
                                  else 5 * WINDOW), 0, 0], np.int32)
    rem = np.array([20, 20, 20, 0], np.int32)
    cap = np.full((SLOTS,), L, np.int32)
    if case == "room":
        cap[0] = pos[0] + 3
    dec = np.array([True, False, True, False])
    pf = np.array([False, True, False, False])
    spec = np.array([False, False, True, False])
    temps = np.zeros((SLOTS,), np.float32)
    return dict(pools=pools, tables=tables, seq=seq, pos=pos, pf_pos=pf_pos,
                pf_target=pf_target, temps=temps, rem=rem, cap=cap, dec=dec,
                pf=pf, spec=spec)


def _run_jax(lm, x, N, eos_id):
    jff, _ = lm
    tr, ntr = jff._params
    fn = jff.executor.paged_mixed_megastep_fn(N, eos_id, window=WINDOW,
                                              depth=DEPTH)
    caches = jax.tree.map(jnp.asarray, x["pools"])
    out = fn(tr, ntr, caches, *[jnp.asarray(x[k]) for k in (
        "tables", "seq", "pos", "pf_pos", "pf_target", "temps", "rem",
        "cap", "dec", "pf", "spec")], jax.random.key(0))
    caches, seq, toks, cnt, done, pf_fin, _, ticks = out
    return (jax.tree.map(np.asarray, caches), np.asarray(seq),
            np.asarray(toks), np.asarray(cnt), np.asarray(done),
            np.asarray(pf_fin), int(ticks))


def _run_port(lm, x, N, eos_id):
    _, tff = lm
    tr, ntr = tff._params
    caches = {k: {n: torch.from_numpy(a.copy()) for n, a in b.items()}
              for k, b in x["pools"].items()}
    t = {k: torch.from_numpy(x[k].copy()) for k in (
        "tables", "seq", "pos", "pf_pos", "pf_target", "temps", "rem",
        "cap", "dec", "pf", "spec")}
    gen = torch.Generator()
    gen.manual_seed(0)
    caches, seq, toks, cnt, done, pf_fin, ran, states = \
        tff.executor.paged_mixed_megastep_fn(
            tr, ntr, caches, t["tables"], t["seq"], t["pos"], t["pf_pos"],
            t["pf_target"], t["temps"], t["rem"], t["cap"], t["dec"],
            t["pf"], t["spec"], gen, max_ticks=N, window=WINDOW,
            depth=DEPTH, eos_id=eos_id)
    assert len(states) == N + 1
    return ({k: {n: a.numpy() for n, a in b.items()}
             for k, b in caches.items()}, seq.numpy(), toks.numpy(),
            cnt.numpy(), done.numpy(), pf_fin.numpy(), int(ran))


@pytest.mark.parametrize("case", ["room", "chunk", "eos"])
def test_mixed_megastep_fn_matches_reference(lm, case):
    """The same tick mix through both executors: every output equal, the
    pools (null page aside, where masked writes land) within POOL_TOL.
    "room" stops before slot 0's fourth write row, "chunk" after the tick
    completing slot 1's prompt, "eos" on the token slot 0 emits on its
    second tick (taken from an eos-free run)."""
    x = _mixed_inputs(lm, case)
    N = 6
    eos = None
    if case == "eos":
        toks = _run_jax(lm, x, N, None)[2]
        eos = int(toks[1, 0, 0])
    want = _run_jax(lm, x, N, eos)
    got = _run_port(lm, x, N, eos)
    # the ledger's last column is the trash column of masked scatters:
    # what lands there is not compared
    names = ("seq", "tokens", "counts", "done", "pf_fin", "ticks")
    for name, w, g in zip(names, (want[1][:, :-1],) + want[2:],
                          (got[1][:, :-1],) + got[2:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    ticks = want[-1]
    assert ticks == {"room": 3, "chunk": 3}.get(case, 2)
    assert ticks < N  # the port predicated the rest off
    for k, bufs in want[0].items():
        for n, w in bufs.items():
            np.testing.assert_allclose(got[0][k][n][1:], w[1:],
                                       atol=POOL_TOL, rtol=POOL_TOL)
    # slot 2 drafted depth-3 chains and, on random weights, saw them
    # rejected: its stale rows were rewritten by the next tick's chain
    assert (want[3][:ticks, 2] >= 1).all()
    assert (want[3][:ticks, 2] < DEPTH + 1).any()


# ---------------------------------------------------------------------------
# server scenarios (tests/test_megastep.py:330-500)


@pytest.mark.parametrize("n_ticks", [1, 4, 8])
def test_mixed_megastep_greedy_identity_vs_dense(lm, dense_tokens, n_ticks):
    """Chunk rows ride the fused dispatch beside decode rows: the greedy
    tokens of a mix of short and chunk-spanning prompts equal JAX
    generate's at every fusion width, and completing chunks hand control
    back (`chunk` breaks)."""
    _, tff = lm
    got, m, _ = _serve(tff, _prompts(21, (3, 9, 5, 14)), 12,
                       megastep_ticks=n_ticks, megastep_mixed=True)
    for w, g in zip(dense_tokens[21], got):
        np.testing.assert_array_equal(g, w)
    ms = m["megastep"]
    assert ms["mixed"] is True and ms["breaks"]["chunk"] > 0
    assert ms["decode_tokens"] > 0
    assert sum(ms["breaks"].values()) == ms["dispatches"]
    if n_ticks > 1:
        assert ms["host_roundtrips"] < ms["decode_tokens"] + sum(
            (3, 9, 5, 14))
    assert any(r["decode_overlap_ticks"] > 0 for r in m["requests"])


def test_mixed_megastep_sampled_identity_vs_one_tick(lm):
    """Fixed-seed sampling does not depend on the fusion width with
    prefill chunks interleaved: a completing prefill's first token comes
    from the tick's own draw, and predicated-off ticks hand their draws
    back to the generator."""
    _, tff = lm
    prompts = _prompts(22, (3, 9, 5, 14))
    temps = [0.8, 0.0, 0.7, 0.9]
    outs = {n: _serve(tff, prompts, 12, temps, seed=3, megastep_ticks=n,
                      megastep_mixed=True)[0] for n in (1, 4)}
    for a, b in zip(outs[1], outs[4]):
        np.testing.assert_array_equal(a, b)


def test_mixed_megastep_spec_greedy_identity_vs_dense(lm, dense_tokens):
    """The speculative server's mixed batch (chunked prefill, greedy
    slots drafting on the device, a sampled slot decoding a token a
    tick) keeps its greedy tokens equal to JAX generate's, fills the
    speculative counters, and hands control back when a drafting slot's
    next chain would cross its pages (`verify`)."""
    _, tff = lm
    temps = [0.0, 0.6, 0.0, 0.0]
    got, m, _ = _serve(tff, _prompts(23, (3, 9, 5, 14)), 12, temps, seed=5,
                       megastep_ticks=8, megastep_mixed=True,
                       speculate=SpecConfig(width=2, depth=3))
    for w, g, t in zip(dense_tokens[23], got, temps):
        if t == 0.0:
            np.testing.assert_array_equal(g, w)
    spec = m["speculative"]
    assert spec["steps"] > 0 and spec["draft_tokens"] >= spec["steps"]
    assert m["megastep"]["breaks"]["verify"] > 0


def test_mixed_megastep_overlap_identity(lm, dense_tokens):
    """overlap_dispatch=True admits while the fused ticks run, then reads
    back once: tokens unchanged, host_overlap_ratio in [0, 1]."""
    _, tff = lm
    got, m, _ = _serve(tff, _prompts(24, (3, 9, 5, 14)), 12,
                       megastep_ticks=4, megastep_mixed=True,
                       overlap_dispatch=True)
    for w, g in zip(dense_tokens[24], got):
        np.testing.assert_array_equal(g, w)
    ms = m["megastep"]
    assert ms["overlap_dispatch"] is True
    assert 0.0 <= ms["host_overlap_ratio"] <= 1.0


def test_mixed_megastep_pool_invariants_at_every_resume(lm, dense_tokens):
    """The pool's invariants hold at every host resume of the universal
    megastep, under page pressure (24 pages for 3 slots) that grows
    pages between dispatches."""
    _, tff = lm
    resumes = []

    class CheckedServer(PagedGenerationServer):
        def _on_megastep_resume(self):
            owners = {s: list(self._active[s].pages)
                      for s in self._admit_order
                      if self._active[s] is not None
                      and self._active[s].pages}
            self.pool.check_invariants(owners=owners)
            resumes.append(len(owners))

    got, _, _ = _serve(tff, _prompts(25, (3, 9, 5, 14)), 12,
                       cls=CheckedServer, slots=3, num_pages=24,
                       megastep_ticks=8, megastep_mixed=True)
    for w, g in zip(dense_tokens[25], got):
        np.testing.assert_array_equal(g, w)
    assert resumes


def test_mixed_megastep_int8_pool_matches_one_tick(lm):
    """On an int8 pool the universal megastep's greedy tokens equal the
    int8 one-tick server's where both write every page's rows in the same
    groups: a budget (64) that takes each prompt whole in the one-tick
    loop, and chunks of 8 rows on pages of 4 in the megastep. (Grow-only
    page scales re-quantize a page's rows when a later group raises its
    scale, so the bytes depend on how a page's rows are grouped into
    steps; with a budget split across slots the two schedules group them
    differently, as in the reference.)"""
    _, tff = lm
    prompts = _prompts(26, (3, 9, 5, 14))
    one, _, _ = _serve(tff, prompts, 12, kv_dtype="int8", prefill_chunk=64)
    mixed, m, _ = _serve(tff, prompts, 12, kv_dtype="int8", prefill_chunk=64,
                         megastep_ticks=8, megastep_mixed=True)
    for a, b in zip(one, mixed):
        np.testing.assert_array_equal(b, a)
    assert m["kv_cache_dtype"] == "int8"


def test_mixed_megastep_rejects_invalid_configs(lm):
    """The reference's ValueErrors: overlap_dispatch without the mixed
    megastep, the mixed megastep without paged."""
    _, tff = lm
    with pytest.raises(ValueError, match="megastep_mixed"):
        tff.serve_generation(max_len=64, paged=True, overlap_dispatch=True)
    with pytest.raises(ValueError, match="megastep_mixed"):
        PagedGenerationServer(tff, max_len=64, overlap_dispatch=True)
    with pytest.raises(ValueError, match="paged"):
        tff.serve_generation(max_len=64, megastep_mixed=True)


# ---------------------------------------------------------------------------
# the unpacked launch (tests/test_paged.py:690, tests/test_spec.py:326)


def test_ragged_pack_token_identity_and_less_waste(lm):
    """ragged_pack=False (one launch a prefilling slot at _bucket(take)
    rows) emits the packed launch's greedy tokens, which equal JAX
    generate's, on a chunked-prefill and decode mix, and ships a larger
    share of padded rows."""
    jff, tff = lm
    prompts = _prompts(21, (3, 17, 5, 11, 2))
    want = [np.asarray(jff.generate(p[None, :], max_new_tokens=6)[0])
            for p in prompts]
    waste = {}
    for pack in (True, False):
        got, m, _ = _serve(tff, prompts, 6, slots=3, max_len=32,
                           prefill_chunk=6, ragged_pack=pack)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w, err_msg=f"pack={pack}")
        assert m["launch_rows"] > 0
        assert 0.0 <= m["padding_waste_ratio"] < 1.0
        waste[pack] = m["padded_rows"] / m["launch_rows"]
    assert waste[True] < waste[False], waste


def test_spec_ragged_pack_identity_with_mixed_temperatures(lm):
    """The speculative verify tick unpacked (an item for every slot, the
    idle one a q_len-0 filler) against packed: greedy tokens equal JAX
    generate's either way, a sampled request rides the same ticks, and
    packing pads fewer rows."""
    jff, tff = lm
    prompts = _prompts(9, (4, 6))
    want = [np.asarray(jff.generate(p[None, :], max_new_tokens=5)[0])
            for p in prompts]
    waste = {}
    for pack in (True, False):
        got, m, _ = _serve(tff, prompts + [prompts[0]], 5,
                           [0.0, 0.0, 0.8], max_len=32, prefill_chunk=64,
                           ragged_pack=pack,
                           speculate=SpecConfig(width=2, depth=3))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w, err_msg=f"pack={pack}")
        assert 1 <= len(got[2]) <= 5
        waste[pack] = m["padded_rows"] / max(m["launch_rows"], 1)
    assert waste[True] < waste[False], waste
