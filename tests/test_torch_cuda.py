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
    K5's tensor-core bodies (K4's at D 64 and at the padded D 96), and a
    base the cp.async copies cannot take (not 8-byte aligned) by K4's
    bodies at D 100."""
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
    # and at D 96, whose body reads tiles zero-padded to 128 columns:
    # forward, dq and dk/dv alike
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_dkv, flash_bh_dq

    flat = torch.zeros(2 * 128 * 96 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(2, 128, 96)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    stats = torch.zeros(2, 128, device="cuda")
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_forward(q, q, q, True, 0.1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_dq(q, q, q, q, stats, stats, True, 0.1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_dkv(q, q, q, q, stats, stats, True, 0.1)
    # and at D 100, whose tiles are filled by 8-byte cp.async copies: a
    # base 2 bytes off is refused by the forward, dq and dk/dv alike
    flat = torch.zeros(2 * 128 * 100 + 1, device="cuda", dtype=torch.bfloat16)
    q = flat[1:].view(2, 128, 100)
    assert q.is_contiguous() and q.data_ptr() % 8 == 2
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_forward(q, q, q, True, 0.1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_dq(q, q, q, q, stats, stats, True, 0.1)
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_dkv(q, q, q, q, stats, stats, True, 0.1)
    # the same for K5's tensor-core body (HeadMajorCarry)
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_fwd_carry

    q = torch.zeros(2 * 128 * 64 + 1, device="cuda",
                    dtype=torch.bfloat16)[1:].view(2, 128, 64)
    m, l = (torch.zeros(2, 128, device="cuda") for _ in range(2))
    acc = torch.zeros(2, 128, 64, device="cuda")
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_fwd_carry(q, q, q, m, l, acc, True, 0.1)
    # at D 100 (cp.async tiles) a q 2 bytes off; and at every tensor-core
    # width an acc 4 bytes off, which its two-float loads cannot take
    q = torch.zeros(2 * 128 * 100 + 1, device="cuda",
                    dtype=torch.bfloat16)[1:].view(2, 128, 100)
    acc = torch.zeros(2, 128, 100, device="cuda")
    with pytest.raises(RuntimeError, match="invalid argument"):
        flash_bh_fwd_carry(q, q, q, m, l, acc, True, 0.1)
    for D in (48, 64, 80, 96, 100, 128, 256):
        q = torch.zeros(2, 128, D, device="cuda", dtype=torch.bfloat16)
        acc = torch.zeros(2 * 128 * D + 1, device="cuda")[1:].view(2, 128, D)
        assert acc.is_contiguous() and acc.data_ptr() % 8 == 4
        with pytest.raises(RuntimeError, match="invalid argument"):
            flash_bh_fwd_carry(q, q, q, m, l, acc, True, 0.1)


# (S, T, D) for K4: every padded width of the CUDA-core bodies (8, 48,
# 80, 96, 100; bf16 at 48, 80, 96 and 100 runs the wgmma bodies on tiles
# zero-padded to 64 / 128 columns, D 100's filled by cp.async), S != T
# and S not a multiple of the tile, S = T 1024 at 80, 96 (Phi-3-mini's)
# and 100 (OpenLLaMA-3B's), a ragged S != T at 48 and 100;
# and the tensor-core classes (D 64, 128 and 256: wgmma in bf16, 3xTF32
# in fp32): S = T at 128, a ragged 1000 and 1024, and S != T both ways
K4_SHAPES = [
    (128, 128, 64), (200, 200, 48), (130, 260, 80), (256, 100, 96),
    (128, 128, 100), (96, 96, 8), (256, 256, 128), (160, 160, 256),
    (1024, 1024, 80), (1024, 1024, 96), (1000, 1536, 48),
    (1024, 1024, 100), (1000, 1536, 100),
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
                                   (1024, 300, 256), (1000, 1000, 96),
                                   (256, 1024, 80), (1024, 300, 48),
                                   (1000, 1000, 100), (300, 1024, 100)])
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


@pytest.mark.parametrize("causal", [True, False])
def test_head_major_d100_bf16_kernels_take_8_byte_aligned_tensors(causal):
    """K4's bf16 forward, dq and dk/dv at D 100 (tiles filled by 8-byte
    cp.async copies) on tensors whose base is 8 bytes past a 16-byte
    boundary, inputs and outputs alike, match the plain versions within
    FLASH_TOLS, as the aligned ones do."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        launch_flash_attention_bh_dkv,
        launch_flash_attention_bh_dq,
        launch_flash_attention_bh_fwd,
    )

    BH, S, T, D = 4, 333, 517, 100
    scale = 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(100 + causal)

    def off8(*shape, rand=True):
        n = int(np.prod(shape))
        flat = (torch.randn(n + 4, generator=g, device="cuda") if rand
                else torch.empty(n + 4, device="cuda")).bfloat16()
        t = flat[4:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 == 8
        return t

    q, do = off8(BH, S, D), off8(BH, S, D)
    k, v = off8(BH, T, D), off8(BH, T, D)
    out, dq = off8(BH, S, D, rand=False), off8(BH, S, D, rand=False)
    dk, dv = off8(BH, T, D, rand=False), off8(BH, T, D, rand=False)
    lse = torch.empty(BH, S, device="cuda")
    fwd_tol, grad_tol = FLASH_TOLS[torch.bfloat16]
    launch_flash_attention_bh_fwd(q, k, v, out, lse, causal, scale)
    torch.cuda.synchronize()
    want_out, want_lse = flash_bh_reference(q, k, v, causal, scale)
    for name, got, want in (("out", out, want_out), ("lse", lse, want_lse)):
        ok, err = _close(got, want, fwd_tol)
        assert ok, (name, err)
    args = (q, k, v, do, want_lse, flash_bh_delta(do, want_out))
    launch_flash_attention_bh_dq(*args, dq, causal, scale)
    launch_flash_attention_bh_dkv(*args, dk, dv, causal, scale)
    torch.cuda.synchronize()
    want_dk, want_dv = flash_bh_dkv_reference(*args, causal, scale)
    for name, got, want in (
            ("dq", dq, flash_bh_dq_reference(*args, causal, scale)),
            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        ok, err = _close(got, want, grad_tol)
        assert ok, (name, err)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [4096, 8192])
def test_head_major_fp32_backward_holds_at_long_sequences(S, D, causal):
    """K4's fp32 dq and dk/dv (the 3xTF32 bodies) at S = T 4096 and 8192,
    past the 2048 rows of every other test: each sums one head's products
    over every streamed row, so a longer sequence is a longer chain of
    tensor-core sums. Held to the plain versions within FLASH_TOLS, fed
    the forward's lse and a shifted one."""
    _needs_card()
    from flexflow_tpu_torch.ops.flash_attention import flash_bh_dkv, flash_bh_dq

    BH, scale = 2, 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(S + D)
    q, k, v, do = (torch.randn(BH, S, D, generator=g, device="cuda")
                   for _ in range(4))
    out, lse = flash_bh_reference(q, k, v, causal, scale)
    delta = flash_bh_delta(do, out)
    del out
    tol = FLASH_TOLS[torch.float32][1]
    shift = torch.rand(BH, S, generator=g, device="cuda")
    for given in (lse, lse + shift):
        args = (q, k, v, do, given, delta, causal, scale)
        dq = flash_bh_dq(*args)
        dk, dv = flash_bh_dkv(*args)
        torch.cuda.synchronize()
        want_dk, want_dv = flash_bh_dkv_reference(*args)
        for name, got, want in (("dq", dq, flash_bh_dq_reference(*args)),
                                ("dk", dk, want_dk), ("dv", dv, want_dv)):
            ok, err = _close(got, want, tol)
            assert ok, (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fp32_backward_holds_at_long_sequences(causal):
    """K2's fp32 dq and dk/dv (the flat-layout 3xTF32 body) at S = T
    4096, D 128, GQA rep 2: dk/dv sums the group's heads over every
    streamed row. Held to the plain versions within FLASH_TOLS."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        launch_flash_attention_dkv,
        launch_flash_attention_dq,
    )

    B, S, H, Hkv, D = 1, 4096, 4, 2, 128
    scale = 1.0 / D ** 0.5
    q, k, v, do = _flash_inputs(S, S, H, Hkv, D, torch.float32, S, B=B)
    do = do.contiguous()
    out, lse = flash_attention_reference(q, k, v, causal, scale)
    args = (q, k, v, do, lse, flash_delta(do, out))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch_flash_attention_dq(*args, dq, causal, scale)
    launch_flash_attention_dkv(*args, dk, dv, causal, scale)
    torch.cuda.synchronize()
    want_dk, want_dv = flash_dkv_reference(*args, causal, scale)
    tol = FLASH_TOLS[torch.float32][1]
    for name, got, want in (
            ("dq", dq, flash_dq_reference(*args, causal, scale)),
            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        ok, err = _close(got, want, tol)
        assert ok, (name, err)


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
@pytest.mark.parametrize("S,T", [(384, 384), (300, 520), (520, 300),
                                 (192, 192)])
@pytest.mark.parametrize("D", [48, 64, 80, 96, 100, 128, 256])
def test_fwd_carry_tensor_core_bodies_match_plain_version(D, S, T, causal):
    """K5 in bf16 at the tensor-core widths (HeadMajorCarry; 48, 80 and 96
    on tiles TMA zero-pads, 100 on tiles filled by cp.async): full and
    causal, S != T both ways and S 192 (a ring's s_loc that is not a
    multiple of the 128-row tile), from fresh and from carried-in
    statistics (the plain fold of another block), m, l and acc updated
    in place."""
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


@pytest.mark.parametrize("D", [64, 96, 100, 128, 256])
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
@pytest.mark.parametrize("D", [64, 96, 100, 128, 256])
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
@pytest.mark.parametrize("D", [64, 96, 100])
def test_ring_on_the_card_matches_the_cpu(dtype, causal, S, D):
    """ring_dot_product_attention over 4 shards (B 2, H 4, Hkv 2; D 64,
    Phi-3-mini's 96 and OpenLLaMA-3B's 100): the card's output and
    gradients against the same ring on the CPU (the plain versions). At
    S 512 (s_loc 128) and S 384 (s_loc 96, not a multiple of 128: the
    same K5 ring, no length gate) K5 launches once per folded block (10
    causal, 16 not) and K4's dq and dk/dv kernels once each per folded
    block in backward."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_BH_DKV,
        FLASH_ATTENTION_BH_DQ,
        FLASH_ATTENTION_BH_FWD_CARRY,
    )
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.ring import ring_dot_product_attention

    B, H, Hkv = 2, 4, 2
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


# ---------------------------------------------------------------------------
# speculative decoding and the decode megastep on the card


def _tree_case(dtype, seed, H=32, Hkv=8, D=128, P=64, N=129, MAXP=16):
    """Four entries at a tree window of 9 rows (SpecConfig(width=2,
    depth=4)'s max_nodes) at Llama-3-8B's attention: two real draft
    trees from build_tree (one with shared prefixes, one padded past its
    live nodes), each once with q_len = its live nodes (the server's
    launch) and once with every row live (verify_fn's, where a padding
    node sees only itself)."""
    from flexflow_tpu_torch.spec.tree import ancestor_masks, build_tree

    T = 9
    trees = [build_tree(5, [np.array([1, 2, 3, 4]), np.array([1, 2, 7, 8]),
                            np.array([6, 9])], T),
             build_tree(3, [np.array([4, 5])], T)]
    assert trees[0].n_nodes == T and trees[1].n_nodes < T
    rs = np.random.RandomState(seed)
    anc = ancestor_masks(np.stack([t.parents for t in trees * 2]))
    q_lens = np.array([t.n_nodes for t in trees] + [T, T], np.int32)
    pos = rs.randint(1, MAXP * P - T, size=4).astype(np.int32)
    pt = (rs.permutation(N - 1)[:4 * MAXP] + 1).reshape(4, MAXP)
    q = rs.standard_normal((4, T, H, D)).astype(np.float32)
    kc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    return [torch.from_numpy(a) for a in
            (q, kc, vc, pt.astype(np.int32), pos, q_lens, anc)]


@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernels_at_tree_window_match_plain_version(dtype, pool):
    """K3 at the tree window (S 9 under a non-triangular ancestor mask,
    padding nodes included) on fp and int8 pools, one launch each,
    against the plain version (TOLS; rows past q_len exact zeros)."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        RAGGED_PAGED_ATTENTION,
        RAGGED_PAGED_ATTENTION_INT8,
    )

    q, kc, vc, pt, pos, qls, anc = _tree_case(dtype, seed=9)
    sc = {}
    if pool == "int8":
        kc, ks, vc, vs = _int8_pools(kc, vc)
        sc = {"k_scales": ks.cuda(), "v_scales": vs.cuda()}
        kernel = RAGGED_PAGED_ATTENTION_INT8
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
        kernel = RAGGED_PAGED_ATTENTION
    args = [q.to(dtype).cuda(), kc.cuda(), vc.cuda()] + [
        a.cuda() for a in (pt, pos, qls, anc)]
    scale = 128 ** -0.5
    before = kernel.launches
    got = ragged_flash_attention(*args, scale=scale, **sc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ragged_gather_attention(*args, scale=scale, **sc)
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= TOLS[dtype] * max(1.0, float(
        want.float().abs().max()))
    for b, ql in enumerate(args[5].tolist()):
        assert not got[b, ql:].any()


def _wide_case(window, seed, H=32, Hkv=8, D=128, P=64, N=129, MAXP=32):
    """One entry at a window wider than one block's rows hold at
    Llama-3-8B's attention (rep 4, D 128): the unpacked prefill's launch
    of a 13-token chunk (window 16) or a 64-token one (window 64), or a
    65-node draft tree (SpecConfig(width=8, depth=8)'s max_nodes), every
    node live, under its ancestor mask."""
    from flexflow_tpu_torch.spec.tree import ancestor_masks, build_tree

    rs = np.random.RandomState(seed)
    anc = np.zeros((1, window, window), bool)
    if window == 65:
        chains = [np.array([10 * w + d + 1 for d in range(8)])
                  for w in range(8)]
        tree = build_tree(7, chains, 65)
        assert tree.n_nodes == 65
        anc[0] = ancestor_masks(tree.parents[None])[0]
        q_len = 65
    else:
        q_len = 13 if window == 16 else window
        anc[0, :q_len, :q_len] = np.tril(np.ones((q_len, q_len), bool))
    pos = rs.randint(1, MAXP * P - window, size=1).astype(np.int32)
    pt = (rs.permutation(N - 1)[:MAXP] + 1).reshape(1, MAXP)
    q = rs.standard_normal((1, window, H, D)).astype(np.float32)
    kc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    return [torch.from_numpy(a) for a in
            (q, kc, vc, pt.astype(np.int32), pos,
             np.array([q_len], np.int32), anc)]


@pytest.mark.parametrize("window", [16, 64, 65])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernels_at_wide_windows_match_plain_version(dtype, pool,
                                                            window):
    """K3 at the windows the unpacked prefill (16, 64) and a wide draft
    tree (65) launch, where a block cannot hold the whole window's q and
    acc rows and the kernel cuts the window into row tiles: one launch
    each, on fp and int8 pools, against the plain version (TOLS; rows
    past q_len exact zeros)."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        RAGGED_PAGED_ATTENTION,
        RAGGED_PAGED_ATTENTION_INT8,
    )

    q, kc, vc, pt, pos, qls, anc = _wide_case(window, seed=window)
    sc = {}
    if pool == "int8":
        kc, ks, vc, vs = _int8_pools(kc, vc)
        sc = {"k_scales": ks.cuda(), "v_scales": vs.cuda()}
        kernel = RAGGED_PAGED_ATTENTION_INT8
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
        kernel = RAGGED_PAGED_ATTENTION
    args = [q.to(dtype).cuda(), kc.cuda(), vc.cuda()] + [
        a.cuda() for a in (pt, pos, qls, anc)]
    scale = 128 ** -0.5
    before = kernel.launches
    got = ragged_flash_attention(*args, scale=scale, **sc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ragged_gather_attention(*args, scale=scale, **sc)
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= TOLS[dtype] * max(1.0, float(
        want.float().abs().max()))
    assert not got[0, int(qls[0]):].any()


def _tiny_llama(device, vocab=512):
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

    ff = FFModel(FFConfig(batch_size=1, seed=7, device=device))
    build_llama(ff, LlamaConfig.tiny(vocab), batch_size=1, seq_len=8,
                dtype=DataType.FLOAT)
    return ff.compile()


@pytest.mark.parametrize("kv", ["fp32", "bf16", "int8"])
def test_commit_on_card_matches_cpu(kv):
    """The accepted-path commit (Executor.paged_commit_fn) on CUDA tensors
    leaves the pools exactly as on CPU tensors: rows copied bit for bit,
    and on an int8 pool the same bytes and scales (the scale-aware copy
    re-quantizes a destination page that also holds a source row)."""
    _needs_card()
    rs = np.random.RandomState(1)
    N, P, Hkv, D = 8, 4, 2, 8
    tables = np.array([[3, 1, 2, 5], [4, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    src = np.array([[6, 8, 11, 6], [9, 9, 9, 9], [0, 0, 0, 0]], np.int32)
    dst = np.array([[6, 7, 8, 6], [9, 9, 9, 9], [0, 0, 0, 0]], np.int32)
    bufs = {}
    for n in ("k", "v"):
        if kv == "int8":
            sc = rs.uniform(0.01, 0.02, (N, Hkv)).astype(np.float32)
            sc[2] = rs.uniform(0.05, 0.06, Hkv)
            bufs[n] = torch.from_numpy(
                rs.randint(-127, 128, (N, P, Hkv, D)).astype(np.int8))
            bufs[n + "_scale"] = torch.from_numpy(sc)
        else:
            bufs[n] = torch.from_numpy(rs.standard_normal(
                (N, P, Hkv, D)).astype(np.float32)).to(
                    getattr(torch, {"fp32": "float32",
                                    "bf16": "bfloat16"}[kv]))
    out = {}
    for device in ("cuda", "cpu"):
        ex = _tiny_llama(device).executor
        caches = {"l0": {n: b.clone().to(device) for n, b in bufs.items()}}
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        out[device] = ex.paged_commit_fn(caches, t(tables), t(src), t(dst))
    for n, b in out["cpu"]["l0"].items():
        assert torch.equal(out["cuda"]["l0"][n].cpu(), b), n
    if kv == "int8":
        assert (out["cpu"]["l0"]["k_scale"][1] > bufs["k_scale"][1]).all()


def test_pick_tokens_makes_no_host_sync():
    """pick_tokens on CUDA tensors, greedy and sampled rows together,
    runs under torch.cuda.set_sync_debug_mode("error"): no read back to
    the host."""
    _needs_card()
    from flexflow_tpu_torch.serving import pick_tokens

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    probs = torch.softmax(torch.randn(4, 1000, device="cuda"), dim=-1)
    temps = torch.tensor([0.0, 0.8, 0.0, 1.2], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = pick_tokens(probs, temps, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    toks = toks.cpu()
    assert toks.dtype == torch.int32
    assert toks[0] == probs[0].argmax() and toks[2] == probs[2].argmax()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_megastep_makes_no_host_sync_and_matches_one_tick(temperature):
    """Executor.paged_megastep_fn runs 8 ticks of a tiny Llama under
    torch.cuda.set_sync_debug_mode("error"), so no tick reads the device
    from the host; its tokens, pools and generator equal 8 one-tick
    ragged steps with pick_tokens on the same seed, and K3 launches once
    a layer a tick."""
    _needs_card()
    from flexflow_tpu_torch.kernels import RAGGED_PAGED_ATTENTION
    from flexflow_tpu_torch.serving import pick_tokens

    ff = _tiny_llama("cuda")
    ex = ff.executor
    tr, ntr = ff._params
    S, P, N = 4, 8, 16
    tables = torch.arange(1, 1 + S * 3, dtype=torch.int32,
                          device="cuda").reshape(S, 3)
    pos = torch.tensor([5, 9, 0, 14], dtype=torch.int32, device="cuda")
    active = torch.tensor([True, True, False, True], device="cuda")
    toks = torch.tensor([3, 7, 0, 11], dtype=torch.int32, device="cuda")
    temps = torch.full((S,), temperature, device="cuda")
    rem = torch.full((S,), 20, dtype=torch.int32, device="cuda")
    cap = torch.full((S,), 24, dtype=torch.int32, device="cuda")

    def pools():
        g = torch.Generator(device="cuda")
        g.manual_seed(2)
        caches = ex.init_paged_kv_cache(N, P)
        for b in caches.values():
            for t in b.values():
                t.normal_(generator=g)
        return caches

    def gen():
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        return g

    # the one-tick reference (it also builds the kernel, off the clock)
    caches, g1 = pools(), gen()
    p, tk, want = pos.clone(), toks.clone(), []
    depths = torch.zeros((S, 1), dtype=torch.int32, device="cuda")
    anc = torch.ones((S, 1, 1), dtype=torch.bool, device="cuda")
    for _ in range(8):
        probs, caches = ex.ragged_step_fn(tr, ntr, caches, tables, p,
                                          active.to(torch.int32), depths,
                                          anc, tk[:, None])
        nxt = pick_tokens(probs[:, -1, :], temps, g1)
        want.append(torch.where(active, nxt, -1))
        tk = torch.where(active, nxt, tk)
        p = torch.where(active, p + 1, p)
    mcaches, g8 = pools(), gen()
    torch.cuda.synchronize()
    before = RAGGED_PAGED_ATTENTION.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        mcaches, out, done, ran, _ = ex.paged_megastep_fn(
            tr, ntr, mcaches, tables, pos, toks, temps, rem, cap, active,
            g8, max_ticks=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert RAGGED_PAGED_ATTENTION.launches - before == 8 * 2
    assert int(ran) == 8 and not done.any()
    assert torch.equal(out, torch.stack(want))
    assert torch.equal(g8.get_state(), g1.get_state())
    for k in caches:
        for n in ("k", "v"):
            assert torch.equal(mcaches[k][n], caches[k][n])


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
@pytest.mark.parametrize("alpha", [2.0, 1.25])
def test_experts_on_card_match_cpu(alpha, dispatch):
    """The EXPERTS lowering (PyTorch ops: sort, searchsorted, gathers,
    batched matmuls) on CUDA tensors, fp32 with TF32 off, against the
    same call on CPU tensors: the same top-k choices and dropped pairs,
    and the output, load-balance term and gradients within 1e-5 (summation
    order only). The sort plan runs under set_sync_debug_mode("error"):
    no read back to the host."""
    _needs_card()
    from flexflow_tpu_torch.ffconst import ActiMode
    from flexflow_tpu_torch.ops import torch_ops
    from flexflow_tpu_torch.ops.attrs import ExpertsAttrs
    from flexflow_tpu_torch.ops.registry import LowerCtx

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(2)
    t, d, n, k, h = 256, 64, 8, 2, 128
    # gate logits skewed toward the last experts, so capacity binds at
    # alpha 1.25 (evenly spread choices would fill ~64 of 80 rows each)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (
        rs.randn(t, d), rs.randn(t, n) * 2 + np.linspace(0.0, 2.0, n),
        rs.randn(n, d, h) * 0.1, rs.randn(n, h, d) * 0.1, rs.randn(t, d))]
    at = ExpertsAttrs(n, k, h, d, alpha, ActiMode.SILU, dispatch=dispatch)
    res = {}
    for device in ("cuda", "cpu"):
        x, gl, w1, w2, cot = (a.to(device).requires_grad_(i < 4)
                              for i, a in enumerate(host))
        ctx = LowerCtx(training=True)
        if device == "cuda" and dispatch == "sort":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            y = torch_ops._experts(at, [x, gl], {"w1": w1, "w2": w2}, ctx)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ((y * cot).sum() + ctx.aux_loss).backward()
        probs = torch.softmax(gl.detach(), dim=-1)
        _, topi = torch_ops.topk_lower_first(probs, k)
        slot, _ = torch_ops.sorted_dispatch(topi, n, at.capacity(t))
        res[device] = [v.detach().cpu() for v in (
            y, ctx.aux_loss, x.grad, gl.grad, w1.grad, w2.grad, topi, slot)]
    for i, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
        if i >= 6:
            assert torch.equal(a, b), ("topi", "slot")[i - 6]
        else:
            assert torch.allclose(a, b, atol=1e-5, rtol=1e-5), i
    if alpha < 2.0:
        assert int((res["cpu"][7] == n * at.capacity(t)).sum()) > 0


def _card_vs_cpu(lower, attrs, host_ins, host_params, host_cot,
                 training=False, rng_seed=None):
    """One lowering on CUDA and on CPU tensors, fp32 with TF32 off for
    matmul and cuDNN: (outputs, input grads, param grads, state updates)
    per device, on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flexflow_tpu_torch.ops.registry import LowerCtx

    res = {}
    for device in ("cuda", "cpu"):
        ins = [a.to(device).requires_grad_(a.is_floating_point())
               for a in host_ins]
        ps = {k: v.to(device).requires_grad_(k not in ("running_mean",
                                                       "running_var"))
              for k, v in host_params.items()}
        ctx = LowerCtx(training=training, rng_seed=rng_seed)
        outs = lower(attrs, ins, ps, ctx)
        sum((o * c.to(device)).sum() for o, c in zip(outs, host_cot)
            if c is not None).backward()
        res[device] = (
            [o.detach().cpu() for o in outs],
            [a.grad.cpu() for a in ins if a.grad is not None],
            {k: v.grad.cpu() for k, v in ps.items() if v.grad is not None},
            {k: v.cpu() for k, v in ctx.state_updates.items()})
    return res


def _assert_card_matches_cpu(res, tol=1e-4):
    (go, gi, gp, gs), (co, ci, cp, cs) = res["cuda"], res["cpu"]
    for a, b in zip(go + gi + list(gp.values()) + list(gs.values()),
                    co + ci + list(cp.values()) + list(cs.values())):
        assert torch.allclose(a, b, atol=tol, rtol=tol), float(
            (a - b).abs().max())
    assert sorted(gp) == sorted(cp) and sorted(gs) == sorted(cs)


@pytest.mark.parametrize("groups,stride,pad", [(1, (1, 1), (1, 1)),
                                               (4, (2, 2), (3, 3))])
def test_conv2d_on_card_matches_cpu(groups, stride, pad):
    """CONV2D (cuDNN) on the card against the CPU, fp32 with TF32 off:
    the output and the gradients of x, kernel and bias within 1e-4
    (summation order only)."""
    _needs_card()
    from flexflow_tpu_torch.ffconst import ActiMode
    from flexflow_tpu_torch.ops import torch_ops
    from flexflow_tpu_torch.ops.attrs import Conv2DAttrs

    rs = np.random.RandomState(3)
    k = (7, 7) if pad == (3, 3) else (3, 3)
    x = torch.from_numpy(rs.randn(4, 16, 28, 28).astype(np.float32))
    w = torch.from_numpy((rs.randn(32, 16 // groups, *k) * 0.1)
                         .astype(np.float32))
    b = torch.from_numpy(rs.randn(32).astype(np.float32))
    at = Conv2DAttrs(32, k, stride, pad, groups, True, ActiMode.RELU)
    oh = (28 + 2 * pad[0] - k[0]) // stride[0] + 1
    cot = torch.from_numpy(rs.randn(4, 32, oh, oh).astype(np.float32))
    _assert_card_matches_cpu(_card_vs_cpu(
        torch_ops._conv2d, at, [x], {"kernel": w, "bias": b}, [cot]))


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_on_card_matches_cpu(training):
    """BATCH_NORM on the card against the CPU, fp32: the output, the
    gradients of x, scale and bias, and in training both moved running
    statistics within 1e-4."""
    _needs_card()
    from flexflow_tpu_torch.ops import torch_ops
    from flexflow_tpu_torch.ops.attrs import BatchNormAttrs

    rs = np.random.RandomState(4)
    x = torch.from_numpy((rs.randn(8, 32, 14, 14) * 2 + 1)
                         .astype(np.float32))
    ps = {"scale": torch.from_numpy(rs.rand(32).astype(np.float32) + 0.5),
          "bias": torch.from_numpy(rs.randn(32).astype(np.float32)),
          "running_mean": torch.zeros(32), "running_var": torch.ones(32)}
    cot = torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
    res = _card_vs_cpu(torch_ops._batch_norm, BatchNormAttrs(True), [x], ps,
                       [cot], training=training)
    _assert_card_matches_cpu(res)
    assert bool(res["cuda"][3]) == training


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_on_card_matches_cpu(reverse):
    """LSTM (the step loop in torch ops) on the card against the CPU, fp32
    with TF32 off, from an initial state: y, h_n, c_n and the gradients
    of x, h0, c0, wx, wh and bias within 1e-4."""
    _needs_card()
    from flexflow_tpu_torch.ops import torch_ops
    from flexflow_tpu_torch.ops.attrs import LSTMAttrs

    rs = np.random.RandomState(5)
    B, S, D, H = 4, 12, 32, 48

    def t(*shape, s=1.0):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32))

    ins = [t(B, S, D), t(B, H, s=0.5), t(B, H, s=0.5)]
    ps = {"wx": t(D, 4 * H, s=0.2), "wh": t(H, 4 * H, s=0.2),
          "bias": t(4 * H, s=0.1)}
    cots = [t(B, S, H), t(B, H), t(B, H)]
    _assert_card_matches_cpu(_card_vs_cpu(
        torch_ops._lstm, LSTMAttrs(H, True, reverse), ins, ps, cots))


def _k4_counts():
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_BH_DKV,
        FLASH_ATTENTION_BH_DQ,
        FLASH_ATTENTION_BH_FWD,
    )

    return [k.launches for k in (FLASH_ATTENTION_BH_FWD,
                                 FLASH_ATTENTION_BH_DQ,
                                 FLASH_ATTENTION_BH_DKV)]


@pytest.mark.parametrize("model", ["bert", "encoder_decoder"])
def test_zoo_attention_reaches_k4(model):
    """A two-layer BERT (biased, non-causal, head dim 64, dropout 0) and
    a one-layer encoder-decoder (fp32; non-causal encoder, causal
    decoder, cross-attention with S 6 != T 10) train one step on the
    card: each attention node launches K4's forward, dq and dk/dv once
    (remat none), the dense dropout route never; the loss is finite."""
    _needs_card()
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models import (
        BertConfig,
        TransformerConfig,
        build_bert,
        build_transformer_encoder_decoder,
    )
    from flexflow_tpu_torch.ops import torch_ops

    rs = np.random.RandomState(6)
    ff = FFModel(FFConfig(batch_size=2, device="cuda", remat="none"))
    if model == "bert":
        build_bert(ff, BertConfig(vocab_size=128, hidden=128, layers=2,
                                  heads=2, intermediate=256, dropout=0.0),
                   batch_size=2, seq_len=16)
        loss, n_attn = LossType.SPARSE_CATEGORICAL_CROSSENTROPY, 2
        xs = [rs.randint(0, 128, (2, 16)).astype(np.int32)]
        y = rs.randint(0, 2, 2).astype(np.int32)
    else:
        build_transformer_encoder_decoder(
            ff, TransformerConfig(dim=128, heads=2, hidden=256, layers=1),
            batch_size=2, src_len=10, tgt_len=6)
        loss, n_attn = LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, 3
        xs = [rs.randn(2, 10, 128).astype(np.float32),
              rs.randn(2, 6, 128).astype(np.float32)]
        y = rs.randn(2, 6, 1).astype(np.float32)
    ff.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=loss)
    before, dense = _k4_counts(), torch_ops.DENSE_DROPOUT_ATTENTION.launches
    tr, ntr = ff._params
    *_, m = ff.executor.train_step(
        tr, ntr, ff._opt_state, torch.from_numpy(y).cuda(),
        *(torch.from_numpy(a).cuda() for a in xs))
    assert [a - b for a, b in zip(_k4_counts(), before)] == [n_attn] * 3
    assert torch_ops.DENSE_DROPOUT_ATTENTION.launches == dense
    assert bool(torch.isfinite(m["loss"]))


def test_dense_dropout_route_only_in_training_above_rate_zero():
    """A BERT at attention dropout 0.1 on the card: a train step takes
    the dense route once a layer and launches no K4 forward; predict
    (eval) at the same rate launches K4's forward once a layer and the
    dense route never."""
    _needs_card()
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.ops import torch_ops

    rs = np.random.RandomState(7)
    ff = FFModel(FFConfig(batch_size=2, device="cuda", remat="none"))
    build_bert(ff, BertConfig(vocab_size=128, hidden=128, layers=2, heads=2,
                              intermediate=256, dropout=0.1),
               batch_size=2, seq_len=16)
    ff.compile(optimizer=SGDOptimizer(lr=0.01))
    x = rs.randint(0, 128, (2, 16)).astype(np.int32)
    y = rs.randint(0, 2, 2).astype(np.int32)
    before, dense = _k4_counts(), torch_ops.DENSE_DROPOUT_ATTENTION.launches
    ff.fit(x, y, verbose=False)
    assert torch_ops.DENSE_DROPOUT_ATTENTION.launches - dense == 2
    assert _k4_counts() == before
    out = ff.predict(x)
    assert torch_ops.DENSE_DROPOUT_ATTENTION.launches - dense == 2
    assert _k4_counts()[0] - before[0] == 2
    assert np.isfinite(out).all()


def test_pipeline_train_step_launches_k1_k2_once_a_layer(monkeypatch):
    """build_llama(use_pipeline=True) at head dim 128 (K1/K2's route),
    bf16, remat none, trains one step on the card: K1's forward, K2's dq
    and K2's dk/dv each launch once per layer of the stack (2 layers),
    no plain version runs, and the loss is finite."""
    _needs_card()
    from flexflow_tpu_torch import AdamOptimizer, DataType, FFConfig, FFModel
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_DKV,
        FLASH_ATTENTION_DQ,
        FLASH_ATTENTION_FWD,
    )
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
    from flexflow_tpu_torch.ops import flash_attention as fa

    def plain(*args, **kwargs):
        raise AssertionError("a plain flash version ran on the card")

    for name in ("flash_attention_reference", "flash_dq_reference",
                 "flash_dkv_reference"):
        monkeypatch.setattr(fa, name, plain)
    cfg = LlamaConfig(vocab_size=512, dim=256, layers=2, heads=2,
                      kv_heads=1, hidden=512)
    ff = FFModel(FFConfig(batch_size=2, device="cuda", remat="none"))
    build_llama(ff, cfg, batch_size=2, seq_len=256,
                dtype=DataType.BFLOAT16, use_pipeline=True)
    ff.compile(optimizer=AdamOptimizer(lr=1e-4))
    x = np.random.RandomState(8).randint(0, 512, (2, 256)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    kernels = (FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ, FLASH_ATTENTION_DKV)
    before = [k.launches for k in kernels]
    tr, ntr = ff._params
    *_, m = ff.executor.train_step(tr, ntr, ff._opt_state,
                                   torch.from_numpy(y).cuda(),
                                   torch.from_numpy(x).cuda())
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 2]
    assert bool(torch.isfinite(m["loss"]))


def test_batch_server_forward_reaches_k4():
    """A two-layer BERT (head dim 64, declared bf16: fp32 from its
    position add on) behind the batch server on the card: a 3-row request
    runs one padded batch of 4, K4's forward launches once a layer, and
    the answer is predict's."""
    _needs_card()
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models import BertConfig, build_bert

    ff = FFModel(FFConfig(batch_size=4, device="cuda"))
    build_bert(ff, BertConfig(vocab_size=128, hidden=128, layers=2,
                              heads=2, intermediate=256, dropout=0.0),
               batch_size=4, seq_len=32, dtype=DataType.BFLOAT16)
    ff.compile()
    x = np.random.RandomState(9).randint(0, 128, (3, 32)).astype(np.int32)
    server = ff.serve(batch_sizes=(1, 4), max_delay_ms=1.0, warmup=False)
    try:
        before = _k4_counts()[0]
        got = server.predict(x)
        assert _k4_counts()[0] - before == 2
    finally:
        server.stop()
    np.testing.assert_allclose(got, ff.predict(x), atol=1e-5, rtol=1e-4)


def test_canary_shadow_launch_matches_plain_version():
    """The kv_quant_canary's shadow launch: bf16 q over an fp32 pool at the
    serving decode's shape (Llama-3-8B's attention: 32 heads over 8 of
    128, page 64, 4 slots at position 1024, a 32-page table). The fp
    kernel converts the fp32 rows on load; it must agree with the plain
    version's cast."""
    _needs_card()
    H, Hkv, D, P, MAXP, B = 32, 8, 128, 64, 32, 4
    N = B * MAXP + 1
    rs = np.random.RandomState(20)
    pt = (rs.permutation(N - 1)[:B * MAXP] + 1).reshape(B, MAXP)
    q = torch.from_numpy(rs.standard_normal((B, 1, H, D)).astype(
        np.float32)).cuda().bfloat16()
    kc = torch.from_numpy(rs.standard_normal((N, P, Hkv, D)).astype(
        np.float32)).cuda()
    vc = torch.from_numpy(rs.standard_normal((N, P, Hkv, D)).astype(
        np.float32)).cuda()
    args = (q, kc, vc, torch.from_numpy(pt.astype(np.int32)).cuda(),
            torch.full((B,), 1024, dtype=torch.int32, device="cuda"),
            torch.ones((B,), dtype=torch.int32, device="cuda"),
            torch.ones((B, 1, 1), dtype=torch.bool, device="cuda"))
    scale = 1.0 / D ** 0.5
    got = ragged_flash_attention(*args, scale=scale)
    torch.cuda.synchronize()
    want = ragged_gather_attention(*args, scale=scale)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOLS[torch.bfloat16] * max(1.0, float(
        want.float().abs().max()))


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_host_tier_page_roundtrip_is_bit_exact(kv_dtype):
    """A page's tier payload on the card: the page's rows of every leaf
    (an int8 pool's scales too) in one pinned host buffer, written back
    bit for bit; and a tiny Llama served through a pool too small for its
    prefixes gives, with a host tier that spills and fetches, the tokens
    of the untiered server, and with kv_quant_canary=1 the same again."""
    _needs_card()
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

    ff = FFModel(FFConfig(batch_size=1, seed=3, device="cuda"))
    build_llama(ff, LlamaConfig(vocab_size=512, dim=256, layers=2, heads=2,
                                kv_heads=1, hidden=512),
                batch_size=1, seq_len=64, dtype=DataType.BFLOAT16)
    ff.compile()
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (19, 23, 17)]
    traffic = prompts + [prompts[0]]
    outs, servers = {}, {}
    for key, kw in (("plain", {}), ("tier", {"host_tier": 32}),
                    ("canary", {"host_tier": 32, "kv_quant_canary": 1})):
        server = ff.serve_generation(paged=True, slots=1, max_len=64,
                                     page_size=8, num_pages=8,
                                     kv_dtype=kv_dtype, **kw)
        try:
            outs[key] = [server.generate(p, 6, timeout=300)
                         for p in traffic]
        finally:
            server.stop()
        server.pool.check_invariants(owners={})
        servers[key] = server
    for key in ("tier", "canary"):
        for a, b in zip(outs[key], outs["plain"]):
            np.testing.assert_array_equal(a, b)
    tiered = servers["tier"]
    assert tiered.pool.spilled_pages > 0 and tiered.pool.fetched_pages > 0
    page = next(iter(tiered.pool._full.values()))
    before = {k: {n: b[page].clone() for n, b in bufs.items()}
              for k, bufs in tiered._caches.items()}
    payload = tiered._tier_read_page(page)
    assert all(t.is_pinned() and t.device.type == "cpu"
               for bufs in payload.values() for t in bufs.values())
    for bufs in tiered._caches.values():
        for b in bufs.values():
            b[page].fill_(5)
    tiered._tier_write_page(page, payload)
    torch.cuda.synchronize()
    for k, bufs in tiered._caches.items():
        for n, b in bufs.items():
            assert torch.equal(b[page], before[k][n]), (k, n)


def test_prefetch_on_the_card_gives_the_cpu_batches(tmp_path):
    """PrefetchLoader on the card (pinned buffers, non_blocking copies on
    a side stream, the step's stream waiting on an event) yields the
    batches the CPU path yields, in order, for the in-memory and the file
    loader, shuffled."""
    _needs_card()
    from flexflow_tpu_torch import FFConfig, FFModel, LossType
    from flexflow_tpu_torch.runtime.dataloader import PrefetchLoader

    rs = np.random.RandomState(0)
    x = rs.standard_normal((96, 10)).astype(np.float32)
    y = rs.randint(0, 4, 96).astype(np.int32)
    np.save(tmp_path / "x.npy", x)
    batches = {}
    for device in ("cuda", "cpu"):
        ff = FFModel(FFConfig(batch_size=16, device=device))
        t = ff.create_tensor((16, 10), name="input")
        ff.softmax(ff.dense(t, 4, name="d"))
        ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        loaders = [ff.create_data_loader(t, str(tmp_path / "x.npy"),
                                         shuffle=True, seed=4),
                   ff.create_data_loader(None, y, shuffle=True, seed=4)]
        got = []
        for _ in range(2):  # two epochs: reshuffled
            for bx, by in PrefetchLoader(ff, loaders):
                assert bx.device.type == device
                got.append((bx.cpu().numpy(), by.cpu().numpy()))
        batches[device] = got
    assert len(batches["cuda"]) == len(batches["cpu"]) == 12
    for (gx, gy), (wx, wy) in zip(batches["cuda"], batches["cpu"]):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_checkpoint_saved_on_the_card_restores_bit_exact(tmp_path):
    """A bf16 Llama trained two steps on the card (bf16 Adam moments),
    saved and rebuilt by restore_model on the card and on the CPU: every
    leaf bit for bit, the step count, and the card model's next step
    equal on both card models."""
    _needs_card()
    from flexflow_tpu_torch import (
        AdamOptimizer, DataType, FFConfig, FFModel, LossType,
    )
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
    from flexflow_tpu_torch.runtime import checkpoint as ckpt

    ff = FFModel(FFConfig(batch_size=2, device="cuda"))
    build_llama(ff, LlamaConfig.tiny(), batch_size=2, seq_len=128,
                dtype=DataType.BFLOAT16)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3, state_dtype="bfloat16"),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    rs = np.random.RandomState(1)
    x = rs.randint(0, 512, (4, 128)).astype(np.int32)
    y = np.roll(x, -1, 1)
    ff.fit(x, y, verbose=False)
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, ff)

    def flat(m):
        tr, ntr = m._params
        return ckpt._flatten({"trainable": tr, "nontrainable": ntr,
                              "opt_state": m._opt_state})

    want = flat(ff)
    for device in ("cuda", "cpu"):
        back = ckpt.restore_model(path, device=device)
        got = flat(back)
        assert sorted(got) == sorted(want) and back._step_count == 2
        for k, v in want.items():
            if isinstance(v, int):
                assert got[k] == v
                continue
            assert got[k].dtype == v.dtype and got[k].device.type == device
            assert torch.equal(got[k].cpu(), v.cpu()), k
    back = ckpt.restore_model(path, device="cuda")
    ff.fit(x[:2], y[:2], verbose=False)
    back.fit(x[:2], y[:2], verbose=False)
    for k, v in flat(ff).items():
        if not isinstance(v, int):
            assert torch.equal(flat(back)[k], v), k


def test_ragged_kernel_launches_from_two_threads():
    """Three host threads launch K3 at once with other windows (1, 16 and
    64: other dynamic shared memory), as a disaggregated pair's prefill
    and decode workers do: no launch is refused (the shared-memory limit
    is the function's, shared by every thread), and each thread's last
    result matches the plain version (TOLS)."""
    _needs_card()
    import threading

    cases = []
    for window in (1, 16, 64):
        q, kc, vc, pt, pos, qls, anc = _wide_case(window, seed=window)
        cases.append([t.cuda() for t in (q.to(torch.bfloat16),
                                         kc.to(torch.bfloat16),
                                         vc.to(torch.bfloat16))]
                     + [t.cuda() for t in (pt, pos, qls, anc)])
    scale = 128 ** -0.5
    errors, outs = [], [None] * len(cases)
    start = threading.Barrier(len(cases))

    def worker(i):
        try:
            start.wait()
            for _ in range(3000):
                outs[i] = ragged_flash_attention(*cases[i], scale=scale)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for args, got in zip(cases, outs):
        want = ragged_gather_attention(*args, scale=scale)
        err = (got.float() - want.float()).abs()
        assert float(err.max()) <= TOLS[torch.bfloat16] * max(
            1.0, float(want.float().abs().max()))


def _bench_1b_attention():
    """bench_1b's graph (batch 8, seq 1024, bf16) and one attention node,
    shapes only: nothing is drawn."""
    from flexflow_tpu_torch import FFConfig, FFModel, OpType
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

    ff = FFModel(FFConfig(batch_size=8, device="cuda"))
    build_llama(ff, LlamaConfig.bench_1b(), batch_size=8, seq_len=1024)
    ff.graph.infer_shapes()
    return ff.graph, next(n for n in ff.graph.nodes
                          if n.op_type == OpType.MULTIHEAD_ATTENTION)


def test_measured_cost_model_times_attention_through_k1():
    """The search's measured path times bench_1b's attention shard (B 8,
    S 1024, H 16, Hkv 8, D 128, bf16) through the port's lowering on the
    card: K1's forward launches at every warm-up and timed repeat, and
    the time is positive."""
    _needs_card()
    from flexflow_tpu_torch.kernels import FLASH_ATTENTION_FWD
    from flexflow_tpu_torch.search.machine_model import H100MachineModel
    from flexflow_tpu_torch.search.measured import MeasuredCostModel

    g, attn = _bench_1b_attention()
    cost = MeasuredCostModel(H100MachineModel.make("h100", 1), {"data": 1},
                             device="cuda")
    before = FLASH_ATTENTION_FWD.launches
    t = cost.measure_node(g, attn, None, training=False)
    assert FLASH_ATTENTION_FWD.launches - before == cost.warmup + cost.repeats
    assert t is not None and t > 0


def test_kernel_build_failure_raises_through_measured_cost_model(
        monkeypatch, tmp_path):
    """A K1 source nvcc refuses fails the measurement with nvcc's error:
    the op is not silently left unmeasured (the reference's broad except
    returned None)."""
    _needs_card()
    from flexflow_tpu_torch.kernels import FLASH_ATTENTION_FWD
    from flexflow_tpu_torch.search.machine_model import H100MachineModel
    from flexflow_tpu_torch.search.measured import MeasuredCostModel

    bad = tmp_path / "flash_attention_fwd.cu"
    bad.write_text("this is not CUDA\n")
    monkeypatch.setattr(FLASH_ATTENTION_FWD, "source", bad)
    monkeypatch.setattr(FLASH_ATTENTION_FWD, "_fn", None)
    g, attn = _bench_1b_attention()
    cost = MeasuredCostModel(H100MachineModel.make("h100", 1), {"data": 1},
                             device="cuda")
    with pytest.raises(RuntimeError):
        cost.measure_node(g, attn, None, training=False)
