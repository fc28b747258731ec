"""The port's host KV tier, prefill/decode disaggregation and
prefix-affinity router held to the JAX reference, on the CPU.

Each scenario is one of the reference's own (tests/test_disagg.py): the
same prompts and settings drive the JAX package and the port (the tiny
GQA Llama of tests/test_paged.py, the JAX weights carried over). The
port's greedy tokens must equal the JAX server's exactly and the port's
untiered server's; its spilled and fetched page counts must equal the
JAX server's on a deterministic schedule; its router must take the JAX
router's decisions on the same prompts. Every scenario ends with the
port's pools' invariants checked (resident ⊎ spilled partitions the hash
index).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.disagg import DisaggPair as JDisaggPair  # noqa: E402
from flexflow_tpu.disagg import HostTier as JHostTier  # noqa: E402
from flexflow_tpu.disagg import PrefixAffinityRouter as JRouter  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.paged.pool import PagePool as JPagePool  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.disagg import (  # noqa: E402
    DisaggPair,
    HostTier,
    PrefillWorker,
    PrefixAffinityRouter,
)
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.paged.pool import PagePool  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.serving import _GenRequest  # noqa: E402

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


def _prompts(seed, lens, low=1):
    rs = np.random.RandomState(seed)
    return [rs.randint(low, VOCAB, (n,)).astype(np.int32) for n in lens]


def _equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"request {i}")


# ---------------------------------------------------------------------------
# HostTier unit behavior (no model): the reference's contracts


@pytest.mark.parametrize("cls", [HostTier, JHostTier], ids=["port", "jax"])
def test_host_tier_spill_fetch_move_semantics(cls):
    t = cls(capacity_pages=3)
    t.spill("a", "payload-a")
    t.spill("b", "payload-b")
    assert t.contains("a") and len(t) == 2
    assert t.peek("a") == "payload-a"      # peek never pops
    assert t.fetch("a") == "payload-a"     # fetch is a move
    assert not t.contains("a") and len(t) == 1
    assert t.fetch("a") is None            # absent -> None, not raise
    m = t.metrics()
    assert m["spilled_pages_total"] == 2
    assert m["fetched_pages_total"] == 1


def test_host_tier_capacity_evicts_oldest_and_counts_drops():
    t = HostTier(capacity_pages=2)
    t.spill("a", 1)
    t.spill("b", 2)
    t.spill("c", 3)                        # capacity 2: oldest (a) drops
    assert not t.contains("a")
    assert t.contains("b") and t.contains("c")
    assert t.metrics()["dropped_pages_total"] == 1
    t.spill("b", 20)                       # latest wins, recency refreshed
    t.spill("d", 4)                        # now c is oldest -> drops
    assert t.contains("b") and t.peek("b") == 20
    assert not t.contains("c")
    t.drop("b")                            # residency won elsewhere
    assert not t.contains("b")
    assert t.metrics()["dropped_pages_total"] == 3
    with pytest.raises(ValueError, match="capacity_pages"):
        HostTier(0)


def test_host_tier_unfetch_rolls_back_to_lru_front():
    """A fetch whose page allocation fails rolls back: unfetch re-inserts
    at the LRU FRONT, so a rolled-back page is the first capacity victim,
    and the fetch is uncounted."""
    t = HostTier(capacity_pages=2)
    t.spill("a", 1)
    t.spill("b", 2)
    got = t.fetch("a")
    t.unfetch("a", got)
    assert t.contains("a")
    assert t.metrics()["fetched_pages_total"] == 0
    t.spill("c", 3)                        # a is oldest again -> drops
    assert not t.contains("a") and t.contains("b") and t.contains("c")
    t.observe_fetch_seconds(0.5)
    t.observe_fetch_seconds(-1.0)          # clamped, never negative
    assert t.metrics()["fetch_seconds_total"] == 0.5


def test_host_tier_survives_deepcopy():
    """The tier's lock must not break copy.deepcopy, and the clone must
    be independent (a tensor payload included)."""
    import torch

    t = HostTier(capacity_pages=4)
    t.spill("a", (1, 2))
    t.spill("p", {"n": {"k": torch.arange(4)}})
    c = copy.deepcopy(t)
    assert c.peek("a") == (1, 2)
    assert torch.equal(c.peek("p")["n"]["k"], torch.arange(4))
    c.spill("b", 3)
    assert not t.contains("b")
    assert c.metrics()["spilled_pages_total"] == 3


def test_host_tier_concurrent_spill_and_fetch_keep_their_counts():
    """The tier is shared by two loop threads (DisaggPair): 16 threads
    spilling and fetching their own hashes at a tiny switch interval lose
    no entry and no count — every fetch returns its own payload, and the
    totals are the operations made."""
    import sys
    import threading

    t = HostTier(capacity_pages=10_000)
    n, per = 16, 200
    errors = []

    def work(i):
        try:
            for j in range(per):
                h = f"{i}:{j}"
                t.spill(h, (i, j))
                if j % 2:
                    assert t.fetch(h) == (i, j)
        except BaseException as e:  # surfaced by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert not any(th.is_alive() for th in threads)
    m = t.metrics()
    assert m["spilled_pages_total"] == n * per
    assert m["fetched_pages_total"] == n * per // 2
    assert len(t) == n * per // 2
    assert m["dropped_pages_total"] == 0


def test_pool_tier_contracts_match_reference():
    """The pool's tier bookkeeping, driven op for op in the port's
    PagePool and the reference's with bookkeeping payloads: spill on LRU
    eviction, transparent fetch on lookup, the rollback when a fetch
    cannot land, spill_request's unregistering, spill_oldest and
    prefetch. Both end in the same state, and the invariants hold after
    every op."""
    def run(pool_cls, tier_cls):
        pool = pool_cls(6, 2, 4)
        tier = tier_cls(capacity_pages=3)
        pool.attach_tier(tier, lambda p: ("page", p),
                         lambda p, payload: None)
        trace = []
        toks = np.arange(1, 9, dtype=np.int32)
        pages = pool.alloc(4)
        for b, h in enumerate(pool.chain_hashes(toks)):
            pool.register_full(pages[b], h)
        pool.free(list(reversed(pages)))       # 4 dead-cached pages
        pool.check_invariants(owners={})
        other = pool.alloc(5)                  # evicts + spills 4
        trace.append((pool.spilled_pages, len(tier), pool.evictions))
        pool.check_invariants(owners={"o": other})
        # the pool is full: the lookup's fetch cannot land -> rollback
        hit = pool.lookup(toks)
        trace.append((hit, pool.fetched_pages,
                      tier.metrics()["fetched_pages_total"], len(tier)))
        pool.free(other)
        hit = pool.lookup(toks)                # transparent fetch
        trace.append((len(hit[0]), hit[1], pool.fetched_pages, len(tier)))
        pool.check_invariants(owners={"r": hit[0]})
        moved = pool.spill_request(hit[0])     # handoff spill
        pool.free(hit[0])
        trace.append((moved, len(tier), pool.free_pages))
        pool.check_invariants(owners={})
        h0 = pool.chain_hashes(toks)[0]
        trace.append(pool.prefetch(h0) is not None)
        trace.append(pool.spill_oldest() is not None)
        pool.check_invariants(owners={})
        trace.append((pool.spilled_pages, pool.fetched_pages, len(tier),
                      sorted(tier.hashes()) == sorted(
                          set(pool.chain_hashes(toks)) - set(pool._full))))
        return trace

    assert run(PagePool, HostTier) == run(JPagePool, JHostTier)


# ---------------------------------------------------------------------------
# spill -> fetch on a live server


def _serve(ff, prompts, new, drive="sequential", **kw):
    server = ff.serve_generation(paged=True, page_size=4, **kw)
    try:
        if drive == "sequential":
            got = [server.submit(p, max_new_tokens=new).result(timeout=120)
                   for p in prompts]
        else:
            futs = [server.submit(p, max_new_tokens=new) for p in prompts]
            if kw.get("defer_start"):
                server.start()
            got = [f.result(timeout=120) for f in futs]
        m = server.metrics()
    finally:
        server.stop()
    return [np.asarray(g) for g in got], m, server


def test_spill_then_fetch_is_token_identical():
    """A pool too small to keep every finished prefix resident spills its
    evictions to the tier; resubmitting the first prompt fetches its
    pages back. Tokens equal the JAX tiered server's and the port's
    untiered server's, and the spilled and fetched counts the JAX
    server's: the fetched KV is the KV that was spilled."""
    jff, tff = _models()
    prompts = _prompts(0, (7, 9, 12))
    traffic = prompts + [prompts[0]]
    kw = dict(slots=2, max_len=32, num_pages=10)
    got, m, server = _serve(tff, traffic, 6, host_tier=HostTier(64), **kw)
    jgot, jm, jserver = _serve(jff, traffic, 6, host_tier=JHostTier(64),
                               **kw)
    plain, _, _ = _serve(tff, traffic, 6, **kw)
    _equal(got, jgot)
    _equal(got, plain)
    server.pool.check_invariants(owners={})
    assert server.pool.spilled_pages > 0 and server.pool.fetched_pages > 0
    assert (server.pool.spilled_pages, server.pool.fetched_pages) == (
        jserver.pool.spilled_pages, jserver.pool.fetched_pages)
    ht, jht = m["host_tier"], jm["host_tier"]
    assert ht["enabled"] is True
    for key in ("spilled_pages", "fetched_pages", "occupancy_pages",
                "spilled_pages_total", "fetched_pages_total",
                "dropped_pages_total"):
        assert ht[key] == jht[key], key
    assert ht["fetch_seconds_total"] > 0.0
    records = server.request_log.records()
    assert sum(r["fetched_pages"] for r in records) == ht["fetched_pages"]
    assert [r["fetched_pages"] for r in records] == [
        r["fetched_pages"] for r in jserver.request_log.records()]
    # the registry follows the pool at scrape time (Prometheus names)
    assert server.registry.counter("kv_fetch_pages_total").value == \
        ht["fetched_pages"]
    assert server.registry.gauge("host_tier_occupancy_pages").value == \
        ht["occupancy_pages"]


def test_preempt_resume_through_the_tier():
    """The preemption path under a tier: evicted pages SPILL instead of
    dropping and the preempted requests' resumes fetch their prefixes
    back. Every request queued before the first tick (defer_start), so
    the schedule is the tokens' alone: tokens, preemptions and spill and
    fetch counts equal the JAX server's."""
    jff, tff = _models()
    prompts = _prompts(2, (5, 6, 4, 7, 5, 6), low=0)
    kw = dict(slots=2, max_len=16, num_pages=5, drive="concurrent",
              defer_start=True)
    got, m, server = _serve(tff, prompts, 8, host_tier=HostTier(64), **kw)
    jgot, jm, _ = _serve(jff, prompts, 8, host_tier=JHostTier(64), **kw)
    plain, _, _ = _serve(tff, prompts, 8, **kw)
    _equal(got, jgot)
    _equal(got, plain)
    server.pool.check_invariants(owners={})
    assert m["preemptions"] > 0
    assert m["host_tier"]["spilled_pages"] > 0
    assert m["host_tier"]["fetched_pages"] > 0
    for key in ("spilled_pages", "fetched_pages"):
        assert m["host_tier"][key] == jm["host_tier"][key], key
    assert m["preemptions"] == jm["preemptions"]


def test_int8_pool_tier_roundtrip_is_bit_exact():
    """An int8 pool's payload carries its scale sidecar: a page spilled
    and fetched back holds the same bytes and scales, and serving through
    the tier gives the untiered int8 server's tokens."""
    import torch

    _, tff = _models()
    prompts = _prompts(5, (9, 11, 6))
    traffic = prompts + [prompts[0]]
    kw = dict(slots=2, max_len=32, num_pages=8, kv_dtype="int8")
    got, m, server = _serve(tff, traffic, 5, host_tier=HostTier(64), **kw)
    plain, _, _ = _serve(tff, traffic, 5, **kw)
    _equal(got, plain)
    assert m["host_tier"]["fetched_pages"] > 0
    caches = server._caches
    layout, total = server._page_layout()
    assert {name for _, name, *_ in layout} == {"k", "v", "k_scale",
                                                "v_scale"}
    page = next(iter(server.pool._full.values()))
    before = {k: {n: b[page].clone() for n, b in bufs.items()}
              for k, bufs in caches.items()}
    payload = server._tier_read_page(page)
    for bufs in caches.values():
        for b in bufs.values():
            b[page].fill_(7)
    server._tier_write_page(page, payload)
    for k, bufs in caches.items():
        for n, b in bufs.items():
            assert torch.equal(b[page], before[k][n]), (k, n)
            assert payload[k][n].dtype == b.dtype


def test_dense_server_rejects_host_tier():
    _, tff = _models()
    with pytest.raises(ValueError, match="paged"):
        tff.serve_generation(slots=1, max_len=16, paged=False,
                             host_tier=HostTier(8))


# ---------------------------------------------------------------------------
# prefill/decode split


def test_disagg_handoff_token_identical_to_monolithic():
    """Requests served by the PrefillWorker -> decode server pair (KV
    through the shared host tier) give the monolithic server's tokens
    and the JAX DisaggPair's; every handoff moves pages through the tier
    (the tier's totals equal the JAX pair's); the decode side completes
    every request; both pools end invariant-clean."""
    jff, tff = _models()
    prompts = _prompts(1, (7, 9, 12))
    kw = dict(tier_pages=64, page_size=4, num_pages=24, max_len=32,
              slots=2)
    mono, _, _ = _serve(tff, prompts, 6, slots=2, max_len=32)
    out = {}
    for name, cls, ff in (("port", DisaggPair, tff),
                          ("jax", JDisaggPair, jff)):
        pair = cls(ff, **kw)
        try:
            got = [np.asarray(pair.submit(p, max_new_tokens=6).result(
                timeout=120)) for p in prompts]
            out[name] = (got, pair.metrics(), pair)
        finally:
            pair.stop()
    got, m, pair = out["port"]
    jgot, jm, _ = out["jax"]
    _equal(got, mono)
    _equal(got, jgot)
    pair.prefill.pool.check_invariants(owners={})
    pair.decode.pool.check_invariants(owners={})
    assert m["handoffs"] == jm["handoffs"] == len(prompts)
    assert m["host_tier"]["spilled_pages_total"] > 0
    for key in ("spilled_pages_total", "fetched_pages_total",
                "occupancy_pages", "dropped_pages_total"):
        assert m["host_tier"][key] == jm["host_tier"][key], key
    recs = pair.decode.request_log.records()
    assert len(recs) == len(prompts)
    assert [r["fetched_pages"] for r in recs] == [
        r["fetched_pages"] for r in
        out["jax"][2].decode.request_log.records()]
    assert len(pair.prefill.request_log.records()) == 0
    assert pair.request_log is pair.decode.request_log
    assert pair.pool is pair.prefill.pool


def test_disagg_pair_concurrent_submissions():
    """Overlapped submissions: prefill admits the next request while the
    decode worker streams earlier ones — every future resolves to the
    monolithic server's tokens (no lost handoff, no mixed-up KV)."""
    _, tff = _models()
    prompts = _prompts(3, (5, 11, 8, 6))
    mono, _, _ = _serve(tff, prompts, 5, slots=2, max_len=32)
    pair = DisaggPair(tff, tier_pages=64, page_size=4, num_pages=24,
                      max_len=32, slots=2)
    try:
        futs = [pair.submit(p, max_new_tokens=5) for p in prompts]
        got = [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        pair.stop()
    _equal(got, mono)
    assert pair.handoffs == len(prompts)
    pair.prefill.pool.check_invariants(owners={})
    pair.decode.pool.check_invariants(owners={})


def test_prefill_worker_requires_tier_and_prefix_cache():
    _, tff = _models()
    with pytest.raises(ValueError, match="handoff"):
        PrefillWorker(tff, handoff=None, host_tier=HostTier(8), slots=1,
                      max_len=16, page_size=4)
    with pytest.raises(ValueError, match="host_tier"):
        PrefillWorker(tff, handoff=lambda r: None, host_tier=None,
                      slots=1, max_len=16, page_size=4)
    with pytest.raises(ValueError, match="prefix_cache"):
        PrefillWorker(tff, handoff=lambda r: None, host_tier=HostTier(8),
                      prefix_cache=False, slots=1, max_len=16, page_size=4)
    with pytest.raises(ValueError, match="prefix_cache"):
        DisaggPair(tff, prefix_cache=False, slots=1, max_len=16,
                   page_size=4)


# ---------------------------------------------------------------------------
# prefix-affinity router


class _Instance:
    """A serving instance as the router sees it: a pool, submit_request
    (the request is held, its future left pending until `finish`), a
    request log and stop."""

    def __init__(self, pool, free=None):
        self.pool = pool
        self.request_log = None
        self.held = []
        if free is not None:
            pool.alloc(pool.capacity - free)

    def submit_request(self, req):
        self.held.append(req)
        return req.future

    def finish(self):
        for r in self.held:
            r.future.set_result(np.zeros(1, np.int32))
        self.held = []

    def stop(self):
        pass


def test_router_decisions_match_reference():
    """The same prompts routed by the port's router and the JAX router
    over instances with the same pools: sticky affinity on the first
    page-aligned chain hash (and the whole prompt for one shorter than a
    page), least-loaded placement from in-flight requests, page pressure
    that diverts new prefixes only from a pool whose tier is full. Every
    decision, stamp and counter equals the reference's."""
    prompts = _prompts(4, (9, 9, 3, 12, 9, 5))
    prompts[1][:4] = prompts[0][:4]   # shares prompt 0's first page
    prompts.append(prompts[2].copy())  # a repeat of the short prompt

    def run(pool_cls, tier_cls, router_cls):
        tier = tier_cls(capacity_pages=1)
        tier.spill("x", 0)                      # full: spill-starved
        insts = [_Instance(pool_cls(20, 4, 8)),
                 _Instance(pool_cls(20, 4, 8), free=1),  # page-pressured
                 _Instance(pool_cls(20, 4, 8))]
        insts[1].pool._tier = tier
        router = router_cls(insts, names=["a", "b", "c"])
        seen = []
        for i, p in enumerate(prompts):
            fut = router.submit(p, max_new_tokens=2)
            req = next(r for inst in insts for r in inst.held
                       if r.future is fut)
            seen.append((req.routed_to, router.route_index(p),
                         list(router.metrics()["inflight"])))
            if i == 3:
                insts[0].finish()               # drains instance a
        insts[1].pool._tier = tier_cls(capacity_pages=8)  # tier headroom
        seen.append(router.route_index(_prompts(9, (8,))[0]))
        return seen, router.metrics()

    got = run(PagePool, HostTier, PrefixAffinityRouter)
    want = run(JPagePool, JHostTier, JRouter)
    assert got == want
    assert got[1]["affinity_misses"] >= 4


def _two_servers(ff):
    mk = lambda: ff.serve_generation(  # noqa: E731
        slots=2, max_len=32, paged=True, page_size=4, num_pages=24)
    return mk(), mk()


def test_router_pins_prefixes_and_beats_round_robin_on_reuse():
    """The same prompt always routes to the same instance, and on
    repeat-prefix traffic the router's cache reuse beats round robin's,
    which scatters each prefix across both pools; tokens equal the
    monolithic server's."""
    _, tff = _models()
    base = _prompts(4, (9, 9))
    traffic = [base[0]] * 3 + [base[1]] * 3
    want, _, _ = _serve(tff, traffic, 4, slots=2, max_len=32)
    s0, s1 = _two_servers(tff)
    try:
        for i, p in enumerate(traffic):
            got = [s0, s1][i % 2].submit(p, max_new_tokens=4).result(
                timeout=120)
            np.testing.assert_array_equal(want[i], np.asarray(got))
        rr_cached = sum(r["cached_prefill_tokens"] for s in (s0, s1)
                        for r in s.request_log.records())
    finally:
        s0.stop()
        s1.stop()
    s0, s1 = _two_servers(tff)
    router = PrefixAffinityRouter([s0, s1], names=["a", "b"])
    try:
        homes = []
        for i, p in enumerate(traffic):
            got = router.generate(p, max_new_tokens=4)
            np.testing.assert_array_equal(want[i], np.asarray(got))
            homes.append(router.route_index(p))
        rt_cached = sum(r["cached_prefill_tokens"] for s in (s0, s1)
                        for r in s.request_log.records())
        records = [r for s in (s0, s1) for r in s.request_log.records()]
        m = router.metrics()
    finally:
        router.stop()
    assert homes[0] == homes[1] == homes[2]
    assert homes[3] == homes[4] == homes[5]
    assert m["affinity_misses"] == 2
    assert sum(m["routed_total"]) == 6
    assert rt_cached > rr_cached > 0
    assert {r["routed_to"] for r in records} <= {"a", "b"}
    assert all(r["routed_to"] is not None for r in records)
    for s in (s0, s1):
        s.pool.check_invariants(owners={})


def test_router_load_balances_fresh_prefixes():
    """Never-seen prefixes spread by load: a burst of distinct prompts
    raises the chosen instance's in-flight count, so the next fresh
    prefix goes to the other one."""
    _, tff = _models()
    prompts = _prompts(6, (9, 9, 9, 9))
    s0, s1 = _two_servers(tff)
    router = PrefixAffinityRouter([s0, s1])
    try:
        futs = [router.submit(p, max_new_tokens=3) for p in prompts]
        m = router.metrics()
        for f in futs:
            f.result(timeout=120)
    finally:
        router.stop()
    assert m["routed_total"][0] > 0 and m["routed_total"][1] > 0
    assert m["affinity_misses"] == 4
    for s in (s0, s1):
        s.pool.check_invariants(owners={})


def test_router_rejects_mismatched_page_sizes():
    _, tff = _models()
    s0 = tff.serve_generation(slots=1, max_len=16, paged=True, page_size=4)
    s1 = tff.serve_generation(slots=1, max_len=16, paged=True, page_size=8)
    try:
        with pytest.raises(ValueError, match="page_size"):
            PrefixAffinityRouter([s0, s1])
        with pytest.raises(ValueError, match="names"):
            PrefixAffinityRouter([s0], names=["a", "b"])
        with pytest.raises(ValueError, match="max_new_tokens"):
            PrefixAffinityRouter([s0]).submit(np.ones(3, np.int32), 0)
    finally:
        s0.stop()
        s1.stop()


def test_router_fronts_disagg_pairs():
    """DisaggPair meets the router's instance contract (pool,
    submit_request, stop): routed disaggregated serving gives the
    monolithic server's tokens."""
    _, tff = _models()
    prompts = _prompts(8, (7, 9))
    want, _, _ = _serve(tff, prompts, 4, slots=2, max_len=32)
    pairs = [DisaggPair(tff, tier_pages=64, page_size=4, num_pages=24,
                        max_len=32, slots=2) for _ in range(2)]
    router = PrefixAffinityRouter(pairs)
    try:
        got = [router.submit(p, max_new_tokens=4).result(timeout=120)
               for p in prompts]
    finally:
        router.stop()
    _equal(got, want)
    assert sum(p.handoffs for p in pairs) == len(prompts)
    for p in pairs:
        p.prefill.pool.check_invariants(owners={})
        p.decode.pool.check_invariants(owners={})


# ---------------------------------------------------------------------------
# page adoption between servers on one device


def test_adopt_request_pages_and_adopt_pool_from():
    """adopt_request_pages copies a request's resident full prefix pages
    from one server's pool into a quiescent one's, registered and parked
    dead-cached, so its admission re-attaches them; adopt_pool_from takes
    a stopped server's whole pool over when the geometry matches and
    refuses otherwise. Both serve the source's tokens."""
    _, tff = _models()
    prompt = _prompts(10, (13,))[0]
    kw = dict(slots=2, max_len=32, paged=True, page_size=4)
    src = tff.serve_generation(**kw)
    try:
        want = np.asarray(src.generate(prompt, 5, timeout=120))
    finally:
        src.stop()
    dst = tff.serve_generation(defer_start=True, **kw)
    req = _GenRequest(prompt, 5, 0.0)
    assert dst.adopt_request_pages(src, req) == len(prompt) // 4
    assert dst.adopt_request_pages(src, req) == 0   # already resident
    dst.pool.check_invariants(owners={})
    dst.start()
    try:
        got = dst.generate(prompt, 5, timeout=120)
        m = dst.metrics()
    finally:
        dst.stop()
    np.testing.assert_array_equal(got, want)
    assert m["requests"][0]["cached_prefill_tokens"] == 12
    other = tff.serve_generation(defer_start=True, num_pages=7, **kw)
    assert other.adopt_pool_from(src) is False       # other geometry
    same = tff.serve_generation(defer_start=True, **kw)
    assert same.adopt_pool_from(src) is True
    assert same.pool is src.pool
    same.start()
    try:
        got = same.generate(prompt, 5, timeout=120)
        with pytest.raises(RuntimeError, match="defer_start"):
            same.adopt_pool_from(src)
        m = same.metrics()
    finally:
        same.stop()
        other.stop()
    np.testing.assert_array_equal(got, want)
    assert m["requests"][0]["cached_prefill_tokens"] == 12
    same.pool.check_invariants(owners={})
    int8 = tff.serve_generation(defer_start=True, kv_dtype="int8", **kw)
    try:
        assert int8.adopt_request_pages(src, req) == 0   # other dtype
    finally:
        int8.stop()
