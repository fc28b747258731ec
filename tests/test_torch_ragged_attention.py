"""The port's ragged paged attention held to the JAX reference.

On the CPU the kernel wrapper takes its plain PyTorch version; it must
agree with the reference's Pallas kernel (run in interpret mode) and its
gather fallback on the live rows of mixed batches — decode rows, prefill
chunks, token trees and padded entries in one launch — and write exact
zeros on rows at or past q_len, as the kernel does. The rope + page-write
+ attend step (ragged_paged_attention) is held to the reference's too,
pools included. The CUDA kernel itself is compared with the plain version
by tests/test_torch_cuda.py (skipped without a card) and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.paged.attention import (  # noqa: E402
    ragged_flash_attention as jax_ragged_flash_attention,
    ragged_gather_attention as jax_ragged_gather_attention,
    ragged_paged_attention as jax_ragged_paged_attention,
)
from flexflow_tpu_torch.paged.attention import (  # noqa: E402
    SplitPlan,
    chain_descriptor,
    ragged_flash_attention,
    ragged_gather_attention,
    ragged_paged_attention,
    ragged_split_plan,
    ragged_visibility_mask,
)
from flexflow_tpu_torch.paged.quant import (  # noqa: E402
    dequantize_pages,
    quantized_append,
)

# fp32 on the CPU: the reference kernel's own test tolerance
TOL = 2e-5


def _ancestor_masks(parents):
    """(T,) parent array -> (T, T) ancestor-or-self mask (node q may see
    node k's row when k lies on q's root path)."""
    T = len(parents)
    anc = np.zeros((T, T), bool)
    for j in range(T):
        anc[j, j] = True
        if parents[j] >= 0:
            anc[j] |= anc[parents[j]]
    return anc


def _ragged_entry(kind, S, rs):
    """(pos, q_len, anc) for one batch entry of a window-S launch."""
    anc = np.zeros((S, S), bool)
    if kind == "pad":
        return 0, 0, anc
    if kind == "decode":
        anc[0, 0] = True
        return int(rs.randint(1, 28)), 1, anc
    if kind == "chunk":
        n = int(rs.randint(2, S + 1))
        anc[:n, :n] = np.tril(np.ones((n, n), bool))
        return int(rs.randint(0, 24)), n, anc
    # tree: root + two branches sharing the root (a non-causal mask)
    n = min(S, 5)
    parents = np.full((S,), -1, np.int32)
    parents[:n] = np.array([-1, 0, 1, 0, 3], np.int32)[:n]
    anc[:] = _ancestor_masks(parents)
    return int(rs.randint(0, 24)), n, anc


def _case(H, Hkv, S, mix, D=32, P=8, N=24, MAXP=4):
    B = len(mix)
    rs = np.random.RandomState(1000 * S + len(mix))
    q = rs.standard_normal((B, S, H, D)).astype(np.float32)
    kc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    perm = rs.permutation(N - 1)[:B * MAXP] + 1  # distinct non-null pages
    pt = perm.reshape(B, MAXP).astype(np.int32)
    entries = [_ragged_entry(k, S, rs) for k in mix]
    pos = np.array([e[0] for e in entries], np.int32)
    q_lens = np.array([e[1] for e in entries], np.int32)
    anc = np.stack([e[2] for e in entries])
    return q, kc, vc, pt, pos, q_lens, anc, 1.0 / np.sqrt(D)


MIXES = [
    (8, 2, 1, ["decode", "decode", "decode"]),
    (8, 2, 4, ["chunk", "chunk"]),
    (8, 2, 4, ["decode", "chunk", "pad"]),
    (8, 2, 6, ["decode", "tree"]),
    (8, 2, 6, ["decode", "chunk", "tree", "pad"]),
    (4, 4, 6, ["decode", "chunk", "tree", "pad"]),  # MHA rep=1
]


@pytest.mark.parametrize("H,Hkv,S,mix", MIXES)
def test_plain_ragged_attention_matches_jax(H, Hkv, S, mix):
    q, kc, vc, pt, pos, q_lens, anc, scale = _case(H, Hkv, S, mix)
    jargs = [jnp.asarray(a) for a in (q, kc, vc, pt, pos, q_lens, anc)]
    targs = [torch.from_numpy(a) for a in (q, kc, vc, pt, pos, q_lens, anc)]
    want_kernel = np.asarray(jax_ragged_flash_attention(
        *jargs, scale=scale, interpret=True))
    want_gather = np.asarray(jax_ragged_gather_attention(*jargs,
                                                         scale=scale))
    got = ragged_flash_attention(*targs, scale=scale).numpy()
    got_plain = ragged_gather_attention(*targs, scale=scale).numpy()
    np.testing.assert_array_equal(got, got_plain)  # CPU -> plain version
    for b, kind in enumerate(mix):
        n = int(q_lens[b])
        np.testing.assert_allclose(got[b, :n], want_kernel[b, :n],
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"entry {b} {kind} vs kernel")
        np.testing.assert_allclose(got[b, :n], want_gather[b, :n],
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"entry {b} {kind} vs gather")
        # the kernel's contract: rows at or past q_len are exact zeros
        assert not got[b, n:].any(), f"entry {b} {kind} padded tail"
        assert not want_kernel[b, n:].any()


@pytest.mark.parametrize("H,Hkv", [(8, 2), (4, 4)])
def test_ragged_paged_attention_matches_jax(H, Hkv):
    """rope + page write + attend: a decode row, a 5-row chunk and a pad
    entry in one window-6 step over pools already holding a prefix. The
    output's live rows and the whole written pools match; the pad entry
    and rows past q_len only ever touch the null page 0."""
    B, S, D, P, N, MAXP = 3, 6, 16, 4, 12, 4
    rs = np.random.RandomState(11)
    q = rs.standard_normal((B, S, H, D)).astype(np.float32)
    k = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    pt = np.array([[3, 5, 0, 0], [7, 2, 9, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([6, 3, 0], np.int32)
    q_lens = np.array([1, 5, 0], np.int32)
    depths = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    anc = np.tile(np.tril(np.ones((S, S), bool)), (B, 1, 1))
    scale = 1.0 / np.sqrt(D)
    jout, jkc, jvc = jax_ragged_paged_attention(
        *[jnp.asarray(a) for a in (q, k, v, kc, vc, pt, pos, q_lens,
                                   depths, anc)],
        scale=scale, rope_theta=10000.0)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, tkc2, tvc2 = ragged_paged_attention(
        *[torch.from_numpy(a) for a in (q, k, v)], tkc, tvc,
        *[torch.from_numpy(a) for a in (pt, pos, q_lens, depths, anc)],
        scale=scale, rope_theta=10000.0)
    assert tkc2 is tkc and tvc2 is tvc  # written in place
    jout = np.asarray(jout)
    for b in range(B):
        n = int(q_lens[b])
        np.testing.assert_allclose(tout[b, :n].numpy(), jout[b, :n],
                                   atol=TOL, rtol=TOL)
        assert not tout[b, n:].numpy().any()
    # every page but the garbage null page agrees
    np.testing.assert_allclose(tkc.numpy()[1:], np.asarray(jkc)[1:],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tvc.numpy()[1:], np.asarray(jvc)[1:],
                               atol=TOL, rtol=TOL)


def test_chain_descriptor_matches_jax():
    from flexflow_tpu.paged.attention import (
        chain_descriptor as jax_chain_descriptor,
    )

    for got, want in zip(chain_descriptor(3, 5), jax_chain_descriptor(3, 5)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_refuses_mixed_devices():
    q, kc, vc, pt, pos, q_lens, anc, scale = _case(8, 2, 4, ["chunk"])
    targs = [torch.from_numpy(a) for a in (q, kc, vc, pt, pos, q_lens, anc)]
    targs[0] = targs[0].to("meta")
    with pytest.raises(ValueError):
        ragged_flash_attention(*targs, scale=scale)



# ---------------------------------------------------------------------------
# the fp-pool kernel's split page walk (csrc/ragged_paged_attention.cu)

# (B, S, H, Hkv, P, maxp, sm_count): Llama-3-8B decode and a packed
# prefill on the serving pool (page 64, 32 pages), GPT-2 XL decode (rep
# 1, 16 pages), phase 7's chunk of 64 rows, small test tables, one page,
# a table that is not a multiple of the split, a small card
PLAN_SHAPES = [
    (4, 1, 32, 8, 64, 32, 132), (8, 8, 32, 8, 64, 32, 132),
    (4, 1, 25, 25, 64, 16, 132), (4, 64, 32, 8, 64, 32, 132),
    (3, 6, 8, 2, 8, 4, 132), (2, 1, 8, 2, 16, 1, 132),
    (1, 1, 8, 8, 16, 7, 132), (64, 1, 32, 8, 16, 100, 8),
    (1, 1, 4, 1, 1, 37, 132),
]


def _split_pages(plan, horizon, P, maxp):
    """The pages each live split walks for an entry at `horizon`
    (pos + q_len), as ragged_split_kernel computes them: split s takes
    pages s * pps .. min((s + 1) * pps, live) - 1 and runs only when that
    run is not empty."""
    live = min(maxp, -(-horizon // P))
    pps = plan.pages_per_split
    return [list(range(s * pps, min((s + 1) * pps, live)))
            for s in range(plan.n_splits) if s * pps < live]


@pytest.mark.parametrize("B,S,H,Hkv,P,maxp,sms", PLAN_SHAPES)
def test_split_plan_covers_each_live_page_once(B, S, H, Hkv, P, maxp, sms):
    """For every horizon up to the table's maxp x P rows, the live splits
    walk pages 0 .. ceil(horizon / P) - 1, each exactly once; the plan
    covers the table with its splits; and the fp32 workspace of the
    partials (D + 2 floats a row and split) is bounded by one row per 16
    cache rows of a full table plus one per query row of a GQA group.
    fp and int8 pools share the plan (an int8 pool's split walk timed
    fastest at the fp plan's pages a split, phase 2's sweep); an int8
    split reads half an fp16 one's bytes, so a full split's partial
    weighs twice as much beside its K/V reads: at most (D + 2) / (8 D)
    of them for 1-byte elements, (D + 2) / (16 D) for 2-byte ones."""
    plan = ragged_split_plan(B, S, H, Hkv, P, maxp, sms)
    pps, n = plan
    assert 1 <= pps <= maxp and n == -(-maxp // pps)
    for horizon in range(1, maxp * P + 1):
        walked = [j for run in _split_pages(plan, horizon, P, maxp)
                  for j in run]
        assert walked == list(range(-(-horizon // P))), horizon
    rep, D = H // Hkv, 128
    ws_rows = B * n * S * H
    assert ws_rows * (D + 2) <= B * Hkv * (maxp * P // 16 + rep * S) * (
        D + 2)
    assert n <= max(1, -(-4 * sms // (B * Hkv)))  # SPLIT_WAVES fills
    if pps < maxp:  # not cut short by the table
        for esz in (1, 2, 4):  # int8, bf16 / fp16, fp32 pools
            partial = rep * S * (D + 2) * 4       # a split's fp32 write
            read = 2 * pps * P * D * esz          # its K and V bytes
            assert partial * 8 * D * esz <= (D + 2) * read, esz


def _split_combine_model(q, kc, vc, pt, pos, q_lens, anc, scale, plan,
                         k_scales=None, v_scales=None):
    """A plain model of the kernels' split walk: each live split's
    partial (m, l, acc) over its pages, p = exp(s - m) against the
    split's own max (floored at -1e30), then the partials merged by max
    and rescale; rows past q_len zeros. An fp pool is cast to q's dtype
    and p rounded to q's dtype before P.V; an int8 pool (with its (N,
    Hkv) k_scales / v_scales) is dequantized page by page against fp32
    q, and p stays fp32."""
    B, S, H, D = q.shape
    P, Hkv, maxp = kc.shape[1], kc.shape[2], pt.shape[1]
    rep = H // Hkv
    quant = k_scales is not None
    vis = ragged_visibility_mask(pt, pos, q_lens, anc, P)
    out = torch.zeros(B, S, H, D)
    for b in range(B):
        n = int(q_lens[b])
        if n == 0:
            continue
        parts = []
        for run in _split_pages(plan, int(pos[b]) + n, P, maxp):
            pages = pt[b, run].long()
            if quant:
                k, v = (dequantize_pages(c[pages], sc[pages])
                        for c, sc in ((kc, k_scales), (vc, v_scales)))
            else:
                k, v = (c[pages].to(q.dtype).float() for c in (kc, vc))
            k = k.reshape(-1, Hkv, D).repeat_interleave(rep, dim=1)
            v = v.reshape(-1, Hkv, D).repeat_interleave(rep, dim=1)
            see = vis[b, :n, run[0] * P:(run[-1] + 1) * P]       # (n, L)
            sc = torch.einsum("thd,lhd->htl", q[b, :n].float(), k) * scale
            sc = sc.masked_fill(~see[None], float("-inf"))
            m = sc.amax(-1).clamp_min(-1e30)                      # (H, n)
            p = torch.exp(sc - m[..., None])
            pv = p if quant else p.to(q.dtype).float()
            acc = torch.einsum("htl,lhd->htd", pv, v)
            parts.append((m, p.sum(-1), acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - mx) for m, _, _ in parts]
        l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        acc = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[b, :n] = (acc / l.clamp_min(1e-30)[..., None]).transpose(0, 1)
    return out.to(q.dtype)


# the kernel's tolerances against the plain version (chip_smoke.TOLS and
# INT8_TOLS): fp32 summation order only; bf16 rounds p before normalising
# (fp pools) or rounds the output (int8 pools)
SPLIT_TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _int8_pools(kc, vc):
    """int8 pools and their (N, Hkv) scales written page by page by the
    port's quantize-on-append from fp32 pools."""
    N, P, Hkv, D = kc.shape
    page = torch.arange(N).repeat_interleave(P)[None]
    off = torch.arange(P).repeat(N)[None]
    live = torch.ones(1, N * P, dtype=torch.bool)
    out = []
    for x in (kc, vc):
        pool = torch.zeros((N, P, Hkv, D), dtype=torch.int8)
        scales = torch.zeros((N, Hkv))
        quantized_append(pool, scales, x.reshape(1, N * P, Hkv, D), page,
                         off, live)
        out += [pool, scales]
    return out


# dtype: q's and an fp pool's, or (q's, "int8") for an int8 pool (the
# fp cases keep their ids dtype0 / dtype1)
@pytest.mark.parametrize("dtype", [
    torch.float32, torch.bfloat16,
    pytest.param((torch.float32, "int8"), id="fp32_q-int8_pool"),
    pytest.param((torch.bfloat16, "int8"), id="bf16_q-int8_pool")])
@pytest.mark.parametrize("pps", [1, 3, None])
@pytest.mark.parametrize("H,Hkv,S,mix", MIXES)
def test_split_then_combine_matches_plain_version(H, Hkv, S, mix, pps,
                                                  dtype):
    """Split-then-combine over decode, chunk, tree and pad entries, at 1
    and 3 pages a split and at ragged_split_plan's choice, equals the
    plain version (ragged_gather_attention) within the kernel's
    tolerances, zeros past q_len included; over an int8 pool also the
    reference's int8 kernel (_ragged_kernel_quant, interpret mode) on the
    same pages and scales."""
    q, kc, vc, pt, pos, q_lens, anc, scale = _case(H, Hkv, S, mix)
    args = [torch.from_numpy(a) for a in (q, kc, vc, pt, pos, q_lens, anc)]
    quant = isinstance(dtype, tuple)
    sc = {}
    if quant:
        dtype = dtype[0]
        args[1], ks, args[2], vs = _int8_pools(args[1], args[2])
        sc = {"k_scales": ks, "v_scales": vs}
        args[0] = args[0].to(dtype)
    else:
        args[:3] = [a.to(dtype) for a in args[:3]]
    maxp, P = pt.shape[1], kc.shape[1]
    plan = (SplitPlan(pps, -(-maxp // pps)) if pps else
            ragged_split_plan(len(mix), S, H, Hkv, P, maxp, 132))
    got = _split_combine_model(*args, scale, plan, **sc)
    want = ragged_gather_attention(*args, scale=scale, **sc)
    tol = SPLIT_TOLS[dtype]
    wants = [want]
    if quant:
        jargs = [jnp.asarray(a.float().numpy() if a.dtype == torch.bfloat16
                             else a.numpy()) for a in args]
        jargs[0] = jargs[0].astype(jnp.bfloat16 if dtype == torch.bfloat16
                                   else jnp.float32)
        jout = jax_ragged_flash_attention(
            *jargs, scale=scale, interpret=True,
            k_scales=jnp.asarray(sc["k_scales"].numpy()),
            v_scales=jnp.asarray(sc["v_scales"].numpy()))
        wants.append(torch.from_numpy(np.array(jout.astype(jnp.float32))))
    for w in wants:
        err = (got.float() - w.float()).abs()
        assert bool((err <= tol + tol * w.float().abs()).all()), float(
            err.max())
    for b, n in enumerate(q_lens):
        assert not got[b, n:].any()
