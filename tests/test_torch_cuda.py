"""Tests of the port's hand-written CUDA kernels; they need an NVIDIA card
(Hopper, sm_90a) and the CUDA toolkit, and skip without a card. Run them
on the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same inputs."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction,
    flash_attention,
    flash_attention_reference,
    flash_delta,
    flash_dkv_reference,
    flash_dq_reference,
    flash_bh_delta,
    flash_bh_dkv_reference,
    flash_bh_dq_reference,
    flash_bh_reference,
)
from flexflow_tpu_torch.paged.attention import (
    ragged_flash_attention,
    ragged_gather_attention,
)

pytestmark = pytest.mark.cuda

# fp32: summation order only. bf16: probabilities are rounded to bf16 at
# different points (the kernel before normalising, the plain version
# after) and the output is rounded to bf16.
TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _mixed_case(H, Hkv, S, D, P, N, MAXP, seed):
    """Decode rows, causal chunks, a token tree and a pad entry."""
    rs = np.random.RandomState(seed)
    B = 4
    pos = rs.randint(0, MAXP * P - S, size=B).astype(np.int32)
    q_lens = np.array([1, S, min(S, 5), 0], np.int32)
    anc = np.zeros((B, S, S), bool)
    anc[0, 0, 0] = True
    anc[1] = np.tril(np.ones((S, S), bool))
    parents = [-1, 0, 1, 0, 3][:min(S, 5)]
    for j, p in enumerate(parents):  # ancestor-or-self of a small tree
        anc[2, j, j] = True
        if p >= 0:
            anc[2, j] |= anc[2, p]
    pos[3] = 0
    pt = (rs.permutation(N - 1)[:B * MAXP] + 1).reshape(B, MAXP)
    q = rs.standard_normal((B, S, H, D)).astype(np.float32)
    kc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    return [torch.from_numpy(a) for a in
            (q, kc, vc, pt.astype(np.int32), pos, q_lens, anc)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,S,D,P", [
    (8, 2, 6, 32, 8),        # test sizes, GQA
    (4, 4, 6, 32, 4),        # MHA, small pages
    (32, 8, 8, 128, 64),     # Llama-3-8B attention, serving page size
])
def test_ragged_kernel_matches_plain_version(dtype, H, Hkv, S, D, P):
    _needs_card()
    from flexflow_tpu_torch.kernels import RAGGED_PAGED_ATTENTION

    N, MAXP = 4 * 8 + 1, 8
    args = _mixed_case(H, Hkv, S, D, P, N, MAXP, seed=S + P)
    args = [a.cuda() for a in args]
    for i in range(3):
        args[i] = args[i].to(dtype)
    scale = 1.0 / D ** 0.5
    before = RAGGED_PAGED_ATTENTION.launches
    got = ragged_flash_attention(*args, scale=scale)
    torch.cuda.synchronize()
    assert RAGGED_PAGED_ATTENTION.launches == before + 1
    want = ragged_gather_attention(*args, scale=scale)
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= TOLS[dtype] * max(1.0, float(
        want.float().abs().max()))
    for b, ql in enumerate(args[5].tolist()):
        assert not got[b, ql:].any()


def _int8_pools(kc, vc):
    """int8 pools and their (N, Hkv) scales from fp pools, written page
    by page through the port's quantize-on-append (on the CPU)."""
    from flexflow_tpu_torch.paged.quant import quantized_append

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,S,D,P", [
    (8, 2, 6, 32, 4),        # GQA, page 4
    (4, 4, 5, 32, 16),       # MHA, page 16, ragged window
    (8, 2, 3, 40, 16),       # a head dim the 16-byte loads do not divide
    (32, 8, 8, 128, 64),     # Llama-3-8B attention, serving page size
])
def test_int8_kernel_matches_plain_version(dtype, H, Hkv, S, D, P):
    """The int8 kernel (dequantize on load with the per-(page, kv head)
    scales, fp32 attention, output in q's dtype) against the plain
    version on the same int8 pages; it alone launches."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        RAGGED_PAGED_ATTENTION,
        RAGGED_PAGED_ATTENTION_INT8,
    )

    N, MAXP = 4 * 8 + 1, 8
    q, kc, vc, pt, pos, qls, anc = _mixed_case(H, Hkv, S, D, P, N, MAXP,
                                               seed=S + P + D)
    kq, ks, vq, vs = (t.cuda() for t in _int8_pools(kc, vc))
    args = [q.cuda().to(dtype), kq, vq] + [a.cuda() for a in (pt, pos, qls,
                                                              anc)]
    scale = 1.0 / D ** 0.5
    before = (RAGGED_PAGED_ATTENTION.launches,
              RAGGED_PAGED_ATTENTION_INT8.launches)
    got = ragged_flash_attention(*args, scale=scale, k_scales=ks,
                                 v_scales=vs)
    torch.cuda.synchronize()
    assert (RAGGED_PAGED_ATTENTION.launches,
            RAGGED_PAGED_ATTENTION_INT8.launches) == (before[0],
                                                      before[1] + 1)
    want = ragged_gather_attention(*args, scale=scale, k_scales=ks,
                                   v_scales=vs)
    assert got.dtype == want.dtype == dtype
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= TOLS[dtype] * max(1.0, float(
        want.float().abs().max()))
    for b, ql in enumerate(args[5].tolist()):
        assert not got[b, ql:].any()


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.bfloat16),  # kv_dtype="bf16" under fp32
    (torch.float32, torch.float16),   # kv_dtype="fp16" under fp32
    (torch.bfloat16, torch.float32),  # kv_dtype="fp32" under bf16
])
@pytest.mark.parametrize("P", [4, 16, 64])
def test_mixed_dtype_pools_match_plain_version(q_dtype, kv_dtype, P):
    """A pool of another float dtype than q: the fp-pool kernel converts
    K/V to q's dtype on load, as the plain version's cast does."""
    _needs_card()
    H, Hkv, S, D = 8, 2, 5, 64
    args = [a.cuda() for a in _mixed_case(H, Hkv, S, D, P, 4 * 8 + 1, 8,
                                          seed=P)]
    args[0] = args[0].to(q_dtype)
    args[1], args[2] = args[1].to(kv_dtype), args[2].to(kv_dtype)
    scale = 1.0 / D ** 0.5
    got = ragged_flash_attention(*args, scale=scale)
    torch.cuda.synchronize()
    want = ragged_gather_attention(*args, scale=scale)
    assert got.dtype == q_dtype
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= TOLS[q_dtype] * max(1.0, float(
        want.float().abs().max()))
    for b, ql in enumerate(args[5].tolist()):
        assert not got[b, ql:].any()


def test_kernel_refuses_what_it_does_not_take():
    _needs_card()
    args = [a.cuda() for a in _mixed_case(8, 2, 6, 32, 8, 33, 8, seed=0)]
    with pytest.raises(ValueError):  # float16 is not a kernel dtype
        ragged_flash_attention(*[a.half() if i < 3 else a
                                 for i, a in enumerate(args)], scale=0.1)
    with pytest.raises(ValueError):  # a non-contiguous q
        q = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        ragged_flash_attention(q, *args[1:], scale=0.1)


def _split_case(H, Hkv, D, P, maxp, S, entries, q_dtype, kv_dtype, seed,
                unaligned=False):
    """One ragged launch on the card: entries (pos, q_len), a decode row
    for q_len 1, a causal chunk above, a pad entry for 0; distinct random
    pages per entry. `unaligned` shifts both pools one element off their
    allocation (a 16-byte copy cannot take them)."""
    rs = np.random.RandomState(seed)
    B = len(entries)
    N = B * maxp + 1
    pos = np.array([e[0] for e in entries], np.int32)
    q_lens = np.array([e[1] for e in entries], np.int32)
    assert (pos + q_lens <= maxp * P).all() and (q_lens <= S).all()
    anc = np.zeros((B, S, S), bool)
    for b, n in enumerate(q_lens):
        anc[b, :n, :n] = np.tril(np.ones((n, n), bool))
    pt = (rs.permutation(N - 1)[:B * maxp] + 1).reshape(B, maxp)
    q = torch.from_numpy(rs.standard_normal((B, S, H, D)).astype(
        np.float32)).cuda().to(q_dtype)
    pools = []
    for _ in range(2):
        x = torch.from_numpy(rs.standard_normal((N, P, Hkv, D)).astype(
            np.float32)).cuda().to(kv_dtype)
        if unaligned:
            flat = torch.empty(x.numel() + 1, dtype=kv_dtype, device="cuda")
            flat[1:] = x.reshape(-1)
            x = flat[1:].view(N, P, Hkv, D)
        pools.append(x)
    return [q, *pools] + [torch.from_numpy(a).cuda() for a in
                          (pt.astype(np.int32), pos, q_lens, anc)]


# (name, H, Hkv, D, P, maxp, S, entries (pos, q_len), q dtype, pool dtype,
# unaligned): the split walk's edges, each under the wrapper's plan and
# under plans of 1, 2 and 3 pages a split
RAGGED_SPLIT_CASES = [
    ("horizon_on_page_edge", 8, 2, 64, 16, 8, 8,
     [(31, 1), (47, 1), (40, 8), (0, 0)], torch.bfloat16, torch.bfloat16,
     False),
    ("horizon_in_first_split", 8, 2, 64, 16, 8, 8,
     [(3, 1), (0, 5), (10, 1)], torch.bfloat16, torch.bfloat16, False),
    ("maxp_1", 8, 2, 64, 16, 1, 4, [(0, 4), (12, 1), (5, 3), (15, 1)],
     torch.bfloat16, torch.bfloat16, False),
    ("maxp_not_a_multiple", 8, 2, 64, 16, 7, 8,
     [(100, 1), (60, 8), (111, 1), (0, 0)], torch.bfloat16, torch.bfloat16,
     False),
    ("pos0_window8", 8, 2, 64, 16, 8, 8, [(0, 8), (0, 8), (0, 1), (0, 0)],
     torch.bfloat16, torch.bfloat16, False),
    ("padded_entries", 8, 2, 64, 16, 8, 1, [(0, 0), (20, 1), (0, 0)],
     torch.bfloat16, torch.bfloat16, False),
    ("gpt2_xl_heads", 25, 25, 64, 64, 16, 1,
     [(960, 1), (500, 1), (1023, 1), (0, 0)], torch.bfloat16,
     torch.bfloat16, False),
    ("fp32_q_bf16_pool", 32, 8, 128, 64, 8, 1,
     [(500, 1), (63, 1), (64, 1)], torch.float32, torch.bfloat16, False),
    ("fp16_pool", 8, 2, 64, 16, 8, 8, [(70, 1), (30, 8), (0, 0)],
     torch.float32, torch.float16, False),
    ("fp32_pool", 8, 2, 64, 16, 8, 8, [(70, 1), (30, 8)], torch.bfloat16,
     torch.float32, False),
    ("unaligned_pool", 8, 2, 64, 16, 8, 8, [(70, 1), (30, 8), (0, 0)],
     torch.bfloat16, torch.bfloat16, True),
    ("unaligned_pool_fp32", 8, 2, 64, 16, 8, 8, [(70, 1), (30, 8)],
     torch.float32, torch.float32, True),
    ("d36_element_loads", 8, 2, 36, 16, 8, 8, [(70, 1), (30, 8), (0, 0)],
     torch.bfloat16, torch.bfloat16, False),
]


@pytest.mark.parametrize("case", RAGGED_SPLIT_CASES, ids=lambda c: c[0])
def test_ragged_split_edges_match_plain_version(case):
    """The fp kernel's split page walk and combine pass at their edges
    (a horizon on a page edge or inside the first split, one page a table,
    a table not a multiple of the split, pos 0 with window 8, padded
    entries, GPT-2 XL's rep 1, pools of another dtype than q, pools a
    16-byte copy cannot take): under the wrapper's plan and under plans of
    1, 2 and 3 pages a split, each call one launch, within the plain
    version's tolerance, rows past q_len exact zeros."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        RAGGED_PAGED_ATTENTION,
        launch_ragged_paged_attention,
    )
    from flexflow_tpu_torch.paged.attention import SplitPlan

    name, H, Hkv, D, P, maxp, S, entries, q_dtype, kv_dtype, unal = case
    args = _split_case(H, Hkv, D, P, maxp, S, entries, q_dtype, kv_dtype,
                       seed=len(name), unaligned=unal)
    scale = 1.0 / D ** 0.5
    want = ragged_gather_attention(*args, scale=scale)
    before = RAGGED_PAGED_ATTENTION.launches
    runs = [ragged_flash_attention(*args, scale=scale)]
    for pps in (1, 2, 3):
        out = torch.empty_like(args[0])
        runs.append(launch_ragged_paged_attention(
            *args, out, scale, SplitPlan(pps, -(-maxp // pps))))
    torch.cuda.synchronize()
    assert RAGGED_PAGED_ATTENTION.launches == before + len(runs)
    limit = TOLS[q_dtype] * max(1.0, float(want.float().abs().max()))
    for pps, got in zip(("plan", 1, 2, 3), runs):
        assert got.dtype == q_dtype
        err = float((got.float() - want.float()).abs().max())
        assert err <= limit, (pps, err, limit)
        for b, ql in enumerate(args[5].tolist()):
            assert not got[b, ql:].any(), (pps, b)


@pytest.mark.parametrize("pos", [1024, 2040])
def test_ragged_long_context_decode_matches_plain_version(pos):
    """Llama-3-8B's steady decode launch (4 slots, page 64, 32 pages a
    table) at pos 1024 and at the end of the table, bf16 and fp32 q: the
    serving path's plan (several live splits), within tolerance."""
    _needs_card()
    for q_dtype in (torch.bfloat16, torch.float32):
        args = _split_case(32, 8, 128, 64, 32, 1, [(pos, 1)] * 4, q_dtype,
                           q_dtype, seed=pos)
        got = ragged_flash_attention(*args, scale=128 ** -0.5)
        want = ragged_gather_attention(*args, scale=128 ** -0.5)
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOLS[q_dtype] * max(1.0, float(
            want.float().abs().max())), (q_dtype, err)


# flash attention. fp32: summation order only (out and lse 1e-5; the
# gradients sum up to 1000 products per element, 1e-4). bf16: p and ds
# are rounded to bf16 at other points than in the plain version, and
# every output is bf16. Besides max |err| <= tol x max(1, max |want|),
# which scales with the largest value and so is loose for late causal
# rows, the error's norm within tol / 2 of the plain result's (as
# chip_smoke.py's flash checks).
FLASH_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _close(got, want, tol):
    diff = got.float() - want.float()
    err = float(diff.abs().max())
    return (err <= tol * max(1.0, float(want.float().abs().max()))
            and float(diff.norm()) <= tol / 2 * float(want.float().norm()),
            err)


# (S, T, H, Hkv, D): S = T at 128, a ragged 1000 and 1024, S != T both
# ways, GQA rep 1, 2 and 8; bf16 at 64, 128 and 256 run K2's wgmma
# bodies, fp32 at 128 and 256 its 3xTF32 ones, the rest (fp32 at 64,
# both dtypes at 384 / 512, and K1 in fp32) the CUDA-core bodies
FLASH_SHAPES = [
    (128, 128, 4, 2, 64), (1000, 1000, 4, 2, 64),
    (128, 128, 4, 4, 128), (256, 256, 4, 2, 128), (1000, 1000, 4, 2, 128),
    (1024, 1024, 16, 8, 128), (1000, 1000, 8, 1, 128),
    (256, 1024, 4, 2, 128), (1024, 256, 4, 2, 128), (200, 333, 8, 1, 128),
    (256, 256, 4, 2, 256), (200, 200, 4, 2, 256), (1024, 1024, 4, 4, 256),
    (128, 128, 8, 1, 256), (256, 1024, 4, 2, 256),
    (128, 128, 4, 2, 384), (200, 300, 4, 2, 384), (128, 128, 4, 2, 512),
    (200, 200, 8, 1, 512),
]


def _flash_inputs(S, T, H, Hkv, D, dtype, seed, B=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, T, Hkv, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    # dO as the output projection's backward may hand it over: strided
    do = torch.randn(B, H, S, D, generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,H,Hkv,D", FLASH_SHAPES)
def test_flash_kernels_match_plain_version(dtype, causal, S, T, H, Hkv, D):
    """K1 (out, lse) and K2 (dq, dk, dv from a fixed, non-contiguous dO)
    against the plain version's forward and autograd gradients, B 2, at
    every shape class the bodies take (FLASH_SHAPES). K1/K2 are driven
    through FlashAttentionFunction: flash_attention sends D 64 to K4."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_DKV,
        FLASH_ATTENTION_DQ,
        FLASH_ATTENTION_FWD,
        launch_flash_attention_fwd,
    )

    B = 2
    scale = 1.0 / D ** 0.5
    q, k, v, do = _flash_inputs(S, T, H, Hkv, D, dtype, S + T + D)
    fwd_tol, grad_tol = FLASH_TOLS[dtype]

    want_out, want_lse = flash_attention_reference(q, k, v, causal, scale)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, device="cuda")
    launch_flash_attention_fwd(q, k, v, out, lse, causal, scale)
    torch.cuda.synchronize()
    for name, got, want in (("out", out, want_out), ("lse", lse, want_lse)):
        ok, err = _close(got, want, fwd_tol)
        assert ok, (name, err)

    counts = [kk.launches for kk in (FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ,
                                     FLASH_ATTENTION_DKV)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttentionFunction.apply(*leaves, causal, scale).backward(do)
    torch.cuda.synchronize()
    assert [kk.launches for kk in (FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ,
                                   FLASH_ATTENTION_DKV)] == [
        c + 1 for c in counts]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_reference(*plain, causal, scale)[0].backward(do)
    for name, got, want in zip(("dq", "dk", "dv"), leaves, plain):
        assert got.grad.dtype == dtype
        ok, err = _close(got.grad, want.grad, grad_tol)
        assert ok, (name, err)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,H,Hkv,D", [(1000, 1000, 16, 8, 128),
                                         (256, 1024, 8, 1, 256)])
def test_flash_bf16_kernels_are_bitwise_deterministic(causal, S, T, H, Hkv,
                                                      D):
    """Two launches of each bf16 kernel on the same inputs give the same
    bits: dk/dv sum the GQA group inside the block, with no atomics."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        launch_flash_attention_dkv,
        launch_flash_attention_dq,
        launch_flash_attention_fwd,
    )

    B = 2
    scale = 1.0 / D ** 0.5
    q, k, v, do = _flash_inputs(S, T, H, Hkv, D, torch.bfloat16, 7)
    do = do.contiguous()
    runs = []
    for _ in range(2):
        out = torch.empty_like(q)
        lse = torch.empty(B, H, S, device="cuda")
        launch_flash_attention_fwd(q, k, v, out, lse, causal, scale)
        delta = flash_delta(do, out)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        launch_flash_attention_dq(q, k, v, do, lse, delta, dq, causal, scale)
        launch_flash_attention_dkv(q, k, v, do, lse, delta, dk, dv, causal,
                                   scale)
        runs.append((out, lse, dq, dk, dv))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


def test_flash_wrapper_refuses_what_the_kernels_do_not_take():
    """D 640 (a multiple of 128 above 512) is refused by K1/K2; above 256
    by K4; float16 by both; a base address TMA cannot map by K4's and
    K5's tensor-core bodies."""
    _needs_card()
    q = torch.zeros(1, 8, 2, 640, device="cuda")
    with pytest.raises(ValueError, match="up to 512"):
        flash_attention(q, q, q, causal=True, scale=0.1)
    q = torch.zeros(1, 8, 2, 264, device="cuda")
    with pytest.raises(ValueError, match="up to 256"):
        flash_attention(q, q, q, causal=True, scale=0.1)
    for D in (64, 48):
        q = torch.zeros(1, 8, 2, D, device="cuda", dtype=torch.float16)
        with pytest.raises(ValueError):
            flash_attention(q, q, q, causal=True, scale=0.1)
    # a contiguous bf16 tensor whose base TMA cannot map (2 bytes past a
    # 16-byte boundary): K4's tensor-core body refuses it and the wrapper
    # raises; no other body takes it
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_forward

    flat = torch.zeros(2 * 128 * 64 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(2, 128, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_forward(q, q, q, True, 0.1)
    # the same for K5's tensor-core body (HeadMajorCarry)
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_fwd_carry

    m, l = (torch.zeros(2, 128, device="cuda") for _ in range(2))
    acc = torch.zeros(2, 128, 64, device="cuda")
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_fwd_carry(q, q, q, m, l, acc, True, 0.1)


# (S, T, D) for K4: every padded width of the CUDA-core bodies (8, 48,
# 80, 96, 100), S != T and S not a multiple of the tile; and the
# tensor-core classes (D 64, 128 and 256: wgmma in bf16, 3xTF32 in
# fp32): S = T at 128, a ragged 1000 and 1024, and S != T both ways
K4_SHAPES = [
    (128, 128, 64), (200, 200, 48), (130, 260, 80), (256, 100, 96),
    (128, 128, 100), (96, 96, 8), (256, 256, 128), (160, 160, 256),
    (1000, 1000, 64), (1024, 1024, 64), (256, 1024, 64), (1024, 300, 64),
    (128, 128, 128), (1000, 1000, 128), (1024, 1024, 128),
    (200, 1000, 128), (1000, 200, 128),
    (128, 128, 256), (1000, 1000, 256), (1024, 1024, 256),
    (300, 1024, 256), (1024, 256, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,D", K4_SHAPES)
def test_head_major_kernels_match_plain_version(dtype, causal, S, T, D):
    """K4's forward (out, lse), dq and dk/dv kernels against their plain
    versions on head-major (BH, S, D) tensors at every shape class of
    K4_SHAPES, within FLASH_TOLS; the backward fed its forward's lse and
    a shifted one (the ring contract)."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_BH_DKV,
        FLASH_ATTENTION_BH_DQ,
        FLASH_ATTENTION_BH_FWD,
    )
    from flexflow_tpu_torch.ops.flash_attention import (
        flash_bh_dkv,
        flash_bh_dq,
        flash_bh_forward,
    )

    BH, scale = 6, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(S + T + D)
    q, do = (torch.randn(BH, S, D, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(BH, T, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    fwd_tol, grad_tol = FLASH_TOLS[dtype]
    counts = [kk.launches for kk in (FLASH_ATTENTION_BH_FWD,
                                     FLASH_ATTENTION_BH_DQ,
                                     FLASH_ATTENTION_BH_DKV)]
    out, lse = flash_bh_forward(q, k, v, causal, scale)
    torch.cuda.synchronize()
    want_out, want_lse = flash_bh_reference(q, k, v, causal, scale)
    for name, got, want in (("out", out, want_out), ("lse", lse, want_lse)):
        ok, err = _close(got, want, fwd_tol)
        assert ok, (name, err)
    delta = flash_bh_delta(do, want_out)
    shift = torch.rand(BH, S, generator=g, device="cuda")
    for given in (want_lse, want_lse + shift):
        args = (q, k, v, do, given, delta, causal, scale)
        dq = flash_bh_dq(*args)
        dk, dv = flash_bh_dkv(*args)
        torch.cuda.synchronize()
        want_dk, want_dv = flash_bh_dkv_reference(*args)
        for name, got, want in (("dq", dq, flash_bh_dq_reference(*args)),
                                ("dk", dk, want_dk), ("dv", dv, want_dv)):
            assert got.dtype == dtype
            ok, err = _close(got, want, grad_tol)
            assert ok, (name, err)
    assert [kk.launches for kk in (FLASH_ATTENTION_BH_FWD,
                                   FLASH_ATTENTION_BH_DQ,
                                   FLASH_ATTENTION_BH_DKV)] == [
        counts[0] + 1, counts[1] + 2, counts[2] + 2]


@pytest.mark.parametrize("D", [64, 128, 256])
def test_head_major_fp32_backward_takes_unaligned_tensors(D):
    """K4's fp32 dq and dk/dv at D 64, 128 and 256 (the 3xTF32 bodies)
    on tensors whose base is 4 bytes past a 16-byte boundary (staged by
    scalar loads, not cp.async) match the plain versions within
    FLASH_TOLS, as the aligned ones do."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_dkv, flash_bh_dq

    BH, S, scale = 3, 200, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(D)

    def unaligned(*shape):
        flat = torch.randn(int(np.prod(shape)) + 1, generator=g,
                           device="cuda")
        t = flat[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 != 0
        return t

    q, k, v, do = (unaligned(BH, S, D) for _ in range(4))
    out, lse = flash_bh_reference(q, k, v, True, scale)
    args = (q, k, v, do, lse, flash_bh_delta(do, out), True, scale)
    dq = flash_bh_dq(*args)
    dk, dv = flash_bh_dkv(*args)
    torch.cuda.synchronize()
    want_dk, want_dv = flash_bh_dkv_reference(*args)
    tol = FLASH_TOLS[torch.float32][1]
    for name, got, want in (("dq", dq, flash_bh_dq_reference(*args)),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        ok, err = _close(got, want, tol)
        assert ok, (name, err)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,D", [(1000, 1000, 64), (256, 1024, 128),
                                   (1024, 300, 256)])
def test_head_major_bf16_kernels_are_bitwise_deterministic(causal, S, T, D):
    """Two launches of each bf16 K4 kernel on the tensor cores on the same
    inputs give the same bits: no atomics."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import (
        flash_bh_dkv,
        flash_bh_dq,
        flash_bh_forward,
    )

    BH, scale = 8, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(S + T + D)
    q, do = (torch.randn(BH, S, D, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(BH, T, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    runs = []
    for _ in range(2):
        out, lse = flash_bh_forward(q, k, v, causal, scale)
        delta = flash_bh_delta(do, out)
        args = (q, k, v, do, lse, delta, causal, scale)
        runs.append((out, lse, flash_bh_dq(*args)) + flash_bh_dkv(*args))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("D", [64, 128, 256])
def test_head_major_fp32_forward_takes_unaligned_tensors(D):
    """K4's fp32 forward at D 64, 128 and 256 (the 3xTF32 body) on
    tensors whose base is 4 bytes past a 16-byte boundary (staged by
    scalar loads, not cp.async) matches the plain version within
    FLASH_TOLS, causal and not, S not a multiple of the tile."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_forward

    BH, S, T, scale = 3, 200, 333, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(D)

    def unaligned(*shape):
        flat = torch.randn(int(np.prod(shape)) + 1, generator=g,
                           device="cuda")
        t = flat[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 != 0
        return t

    q, k, v = unaligned(BH, S, D), unaligned(BH, T, D), unaligned(BH, T, D)
    for causal in (True, False):
        out, lse = flash_bh_forward(q, k, v, causal, scale)
        torch.cuda.synchronize()
        want_out, want_lse = flash_bh_reference(q, k, v, causal, scale)
        for name, got, want in (("out", out, want_out),
                                ("lse", lse, want_lse)):
            ok, err = _close(got, want, FLASH_TOLS[torch.float32][0])
            assert ok, (name, causal, err)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,D", [(1000, 1000, 64), (256, 1024, 128),
                                   (1024, 300, 256)])
def test_head_major_fp32_kernels_are_bitwise_deterministic(causal, S, T, D):
    """Two launches of each fp32 K4 kernel on its 3xTF32 body (forward,
    dq, dk/dv) on the same inputs give the same bits: no atomics."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import (
        flash_bh_dkv,
        flash_bh_dq,
        flash_bh_forward,
    )

    BH, scale = 8, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(S + T + D)
    q, do = (torch.randn(BH, S, D, generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn(BH, T, D, generator=g, device="cuda")
            for _ in range(2))
    runs = []
    for _ in range(2):
        out, lse = flash_bh_forward(q, k, v, causal, scale)
        delta = flash_bh_delta(do, out)
        args = (q, k, v, do, lse, delta, causal, scale)
        runs.append((out, lse, flash_bh_dq(*args)) + flash_bh_dkv(*args))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,H,Hkv,D", [(1000, 1000, 16, 8, 128),
                                         (256, 1024, 8, 1, 256),
                                         (300, 200, 4, 4, 128)])
def test_flash_fp32_kernels_are_bitwise_deterministic(causal, S, T, H, Hkv,
                                                      D):
    """Two launches of K1 and of K2's fp32 dq and dk/dv (the flat-layout
    3xTF32 body at D 128 and 256) on the same inputs give the same bits:
    dk/dv sum the GQA group (rep 2, 8 and 1) in registers, with no
    atomics."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        launch_flash_attention_dkv,
        launch_flash_attention_dq,
        launch_flash_attention_fwd,
    )

    B = 2
    scale = 1.0 / D ** 0.5
    q, k, v, do = _flash_inputs(S, T, H, Hkv, D, torch.float32, 7)
    do = do.contiguous()
    runs = []
    for _ in range(2):
        out = torch.empty_like(q)
        lse = torch.empty(B, H, S, device="cuda")
        launch_flash_attention_fwd(q, k, v, out, lse, causal, scale)
        delta = flash_delta(do, out)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        launch_flash_attention_dq(q, k, v, do, lse, delta, dq, causal, scale)
        launch_flash_attention_dkv(q, k, v, do, lse, delta, dk, dv, causal,
                                   scale)
        runs.append((out, lse, dq, dk, dv))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("D", [128, 256])
def test_flash_fp32_backward_takes_unaligned_tensors(D):
    """K2's fp32 dq and dk/dv at D 128 and 256 (the flat-layout 3xTF32
    body) on tensors whose base is 4 bytes past a 16-byte boundary
    (scalar loads, not cp.async) match the plain versions within
    FLASH_TOLS, GQA rep 2, causal, S != T."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        launch_flash_attention_dkv,
        launch_flash_attention_dq,
    )

    B, S, T, H, Hkv, scale = 2, 200, 300, 4, 2, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(D)

    def unaligned(*shape):
        flat = torch.randn(int(np.prod(shape)) + 1, generator=g,
                           device="cuda")
        t = flat[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 != 0
        return t

    q, do = unaligned(B, S, H, D), unaligned(B, S, H, D)
    k, v = unaligned(B, T, Hkv, D), unaligned(B, T, Hkv, D)
    out, lse = flash_attention_reference(q, k, v, True, scale)
    delta = flash_delta(do, out)
    args = (q, k, v, do, lse, delta)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch_flash_attention_dq(*args, dq, True, scale)
    launch_flash_attention_dkv(*args, dk, dv, True, scale)
    torch.cuda.synchronize()
    want_dk, want_dv = flash_dkv_reference(*args, True, scale)
    tol = FLASH_TOLS[torch.float32][1]
    for name, got, want in (
            ("dq", dq, flash_dq_reference(*args, True, scale)),
            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        ok, err = _close(got, want, tol)
        assert ok, (name, err)


@pytest.mark.parametrize("D,Hkv", [(64, 4), (48, 2), (96, 1)])
def test_head_major_route_matches_plain_autograd(D, Hkv):
    """flash_attention at a head dim that is not a multiple of 128 (GQA
    included) launches K4 once forward and once each backward, and its
    gradients match the dense plain version's autograd."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_BH_DKV,
        FLASH_ATTENTION_BH_DQ,
        FLASH_ATTENTION_BH_FWD,
        FLASH_ATTENTION_FWD,
    )

    B, S, H, scale = 2, 192, 4, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(D)
    q = torch.randn(B, S, H, D, generator=g, device="cuda")
    k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda")
            for _ in range(2))
    do = torch.randn(B, H, S, D, generator=g, device="cuda").transpose(1, 2)
    kernels = (FLASH_ATTENTION_BH_FWD, FLASH_ATTENTION_BH_DQ,
               FLASH_ATTENTION_BH_DKV, FLASH_ATTENTION_FWD)
    counts = [kk.launches for kk in kernels]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, scale=scale)
    out.backward(do)
    torch.cuda.synchronize()
    assert [kk.launches for kk in kernels] == [
        counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3]]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = flash_attention_reference(*plain, True, scale)[0]
    want.backward(do)
    ok, err = _close(out.detach(), want.detach(),
                     FLASH_TOLS[torch.float32][0])
    assert ok, ("out", err)
    for name, got, ref in zip(("dq", "dk", "dv"), leaves, plain):
        ok, err = _close(got.grad, ref.grad, FLASH_TOLS[torch.float32][1])
        assert ok, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,D", [(128, 128, 48), (256, 256, 64),
                                   (200, 200, 80), (256, 256, 128),
                                   (160, 160, 256), (130, 260, 64),
                                   (256, 100, 128)])
def test_fwd_carry_kernel_matches_plain_version(dtype, causal, S, T, D):
    """K5 against its plain version: from the initial statistics and from
    a carried-in state (the plain fold of another block), S != T and S
    not a multiple of the tile included. The kernel updates m, l and acc
    in place and counts one launch a call."""
    _needs_card()
    from flexflow_tpu_torch.kernels import FLASH_ATTENTION_BH_FWD_CARRY
    from flexflow_tpu_torch.ops.flash_attention import (
        flash_bh_fwd_carry,
        flash_bh_fwd_carry_reference,
    )

    BH, scale = 6, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(S + T + D)
    q = torch.randn(BH, S, D, generator=g, device="cuda").to(dtype)
    k, v, k0, v0 = (torch.randn(BH, T, D, generator=g, device="cuda")
                    .to(dtype) for _ in range(4))
    fresh = (torch.full((BH, S), -1e30, device="cuda"),
             torch.zeros(BH, S, device="cuda"),
             torch.zeros(BH, S, D, device="cuda"))
    carried = flash_bh_fwd_carry_reference(q, k0, v0, *fresh, False, scale)
    tol = FLASH_TOLS[dtype][0]
    for stats in (fresh, carried):
        want = flash_bh_fwd_carry_reference(q, k, v, *stats, causal, scale)
        bufs = [t.clone() for t in stats]
        before = FLASH_ATTENTION_BH_FWD_CARRY.launches
        got = flash_bh_fwd_carry(q, k, v, *bufs, causal, scale)
        torch.cuda.synchronize()
        assert FLASH_ATTENTION_BH_FWD_CARRY.launches == before + 1
        assert all(a is b for a, b in zip(got, bufs))
        for name, a, b in zip(("m", "l", "acc"), got, want):
            ok, err = _close(a, b, tol)
            assert ok, (name, err)


def _carry_inputs(BH, S, T, D, seed, dtype=torch.bfloat16):
    """q (BH, S, D), k, v (BH, T, D) and the fresh statistics (m -1e30,
    l 0, acc 0) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(BH, S, D, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(BH, T, D, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    fresh = (torch.full((BH, S), -1e30, device="cuda"),
             torch.zeros(BH, S, device="cuda"),
             torch.zeros(BH, S, D, device="cuda"))
    return q, k, v, fresh


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T", [(384, 384), (300, 520), (520, 300)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_fwd_carry_tensor_core_bodies_match_plain_version(D, S, T, causal):
    """K5 in bf16 at the tensor-core widths (HeadMajorCarry): full and
    causal, S != T both ways, from fresh and from carried-in statistics
    (the plain fold of another block), m, l and acc updated in place."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import (
        flash_bh_fwd_carry,
        flash_bh_fwd_carry_reference,
    )

    scale = 1.0 / D ** 0.5
    q, k, v, fresh = _carry_inputs(6, S, T, D, seed=D + S + T)
    _, k0, v0, _ = _carry_inputs(6, S, T, D, seed=D + S + T + 1)
    carried = flash_bh_fwd_carry_reference(q, k0, v0, *fresh, False, scale)
    for stats in (fresh, carried):
        want = flash_bh_fwd_carry_reference(q, k, v, *stats, causal, scale)
        bufs = [t.clone() for t in stats]
        got = flash_bh_fwd_carry(q, k, v, *bufs, causal, scale)
        torch.cuda.synchronize()
        assert all(a is b for a, b in zip(got, bufs))
        for name, a, b in zip(("m", "l", "acc"), got, want):
            ok, err = _close(a, b, FLASH_TOLS[torch.bfloat16][0])
            assert ok, (name, err)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_fwd_carry_folds_equal_one_forward(D):
    """Four K5 folds of the quarters of k/v, normalised, equal one K4
    forward over the concatenated keys (out and lse), bf16 on the tensor
    cores."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import (
        flash_bh_forward,
        flash_bh_fwd_carry,
    )

    scale = 1.0 / D ** 0.5
    q, k, v, fresh = _carry_inputs(4, 320, 4 * 192, D, seed=D)
    m, l, acc = (t.clone() for t in fresh)
    for i in range(4):
        blk = slice(192 * i, 192 * (i + 1))
        flash_bh_fwd_carry(q, k[:, blk], v[:, blk], m, l, acc, False, scale)
    l_safe = l.clamp_min(1e-30)
    out, lse = (acc / l_safe[..., None]).bfloat16(), m + torch.log(l_safe)
    want_out, want_lse = flash_bh_forward(q, k, v, False, scale)
    torch.cuda.synchronize()
    ok, err = _close(out, want_out, FLASH_TOLS[torch.bfloat16][0])
    assert ok, ("out", err)
    assert float((lse - want_lse).abs().max()) <= 1e-2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_fwd_carry_bf16_is_bitwise_deterministic(D, causal):
    """Two K5 launches on the tensor cores from the same inputs and state
    give the same bits."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_fwd_carry

    scale = 1.0 / D ** 0.5
    q, k, v, fresh = _carry_inputs(8, 1000, 1000, D, seed=D + 7)
    runs = []
    for _ in range(2):
        bufs = [t.clone() for t in fresh]
        runs.append(flash_bh_fwd_carry(q, k, v, *bufs, causal, scale))
    torch.cuda.synchronize()
    for name, a, b in zip(("m", "l", "acc"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [512, 384])
def test_ring_on_the_card_matches_the_cpu(dtype, causal, S):
    """ring_dot_product_attention over 4 shards (B 2, H 4, Hkv 2, D 64):
    the card's output and gradients against the same ring on the CPU (the
    plain versions). At S 512 (s_loc 128) and S 384 (s_loc 96, not a
    multiple of 128: the same K5 ring, no length gate) K5 launches once
    per folded block (10 causal, 16 not) and K4's dq and dk/dv kernels
    once each per folded block in backward."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_BH_DKV,
        FLASH_ATTENTION_BH_DQ,
        FLASH_ATTENTION_BH_FWD_CARRY,
    )
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.ring import ring_dot_product_attention

    B, H, Hkv, D = 2, 4, 2, 64
    g = torch.Generator().manual_seed(int(causal))
    q, w = (torch.randn(B, S, H, D, generator=g).to(dtype)
            for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, generator=g).to(dtype)
            for _ in range(2))
    kernels = (FLASH_ATTENTION_BH_FWD_CARRY, FLASH_ATTENTION_BH_DQ,
               FLASH_ATTENTION_BH_DKV)
    results = []
    for device in ("cuda", "cpu"):
        counts = [kk.launches for kk in kernels]
        leaves = [t.to(device).requires_grad_() for t in (q, k, v)]
        out = ring_dot_product_attention(
            *leaves, mesh=make_mesh({"seq": 4}), causal=causal,
            scale=D ** -0.5)
        (out.float() * w.to(device).float()).sum().backward()
        results.append([t.detach().cpu() for t in
                        [out] + [x.grad for x in leaves]])
        folded = 10 if causal else 16
        assert [kk.launches - c for kk, c in zip(kernels, counts)] == (
            [folded] * 3 if device == "cuda" else [0] * 3)
    fwd_tol, grad_tol = FLASH_TOLS[dtype]
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), *results,
                               (fwd_tol,) + (grad_tol,) * 3):
        assert a.dtype == dtype
        ok, err = _close(a, b, tol)
        assert ok, (name, err)
