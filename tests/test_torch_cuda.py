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


# flash attention. fp32: summation order only (out and lse 1e-5; the
# gradients sum up to 1000 products per element, 1e-4). bf16: p and ds
# are rounded to bf16 at other points than in the plain version, and
# every output is bf16.
FLASH_TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    return err <= tol * max(1.0, float(want.float().abs().max())), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(128, 64), (1000, 64), (256, 128),
                                 (1000, 128), (256, 256), (200, 256)])
def test_flash_kernels_match_plain_version(dtype, causal, S, D):
    """K1 (out, lse) and K2 (dq, dk, dv from a fixed, non-contiguous dO)
    against the plain version's forward and autograd gradients, GQA
    (H 4, Hkv 2), S = T including a ragged 1000 and 200; D 256 runs K2 on
    32-row tiles. K1/K2 are driven through FlashAttentionFunction:
    flash_attention sends D 64 to K4."""
    _needs_card()
    from flexflow_tpu_torch.kernels import (
        FLASH_ATTENTION_DKV,
        FLASH_ATTENTION_DQ,
        FLASH_ATTENTION_FWD,
        launch_flash_attention_fwd,
    )

    B, H, Hkv = 2, 4, 2
    scale = 1.0 / D ** 0.5
    g = torch.Generator(device="cuda").manual_seed(S + D)
    q, k, v = (torch.randn(B, S, h, D, generator=g, device="cuda")
               .to(dtype) for h in (H, Hkv, Hkv))
    # dO as the output projection's backward may hand it over: strided
    do = torch.randn(B, H, S, D, generator=g, device="cuda").to(
        dtype).transpose(1, 2)
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


def test_flash_wrapper_refuses_what_the_kernels_do_not_take():
    """D 384 (a multiple of 128 above 256) is refused by K1/K2; above 256
    by K4; float16 by both."""
    _needs_card()
    q = torch.zeros(1, 8, 2, 384, device="cuda")
    with pytest.raises(ValueError, match="64, 128 and 256"):
        flash_attention(q, q, q, causal=True, scale=0.1)
    q = torch.zeros(1, 8, 2, 264, device="cuda")
    with pytest.raises(ValueError, match="up to 256"):
        flash_attention(q, q, q, causal=True, scale=0.1)
    for D in (64, 48):
        q = torch.zeros(1, 8, 2, D, device="cuda", dtype=torch.float16)
        with pytest.raises(ValueError):
            flash_attention(q, q, q, causal=True, scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,D", [(128, 128, 64), (200, 200, 48),
                                   (130, 260, 80), (256, 100, 96),
                                   (128, 128, 100), (96, 96, 8),
                                   (256, 256, 128), (160, 160, 256)])
def test_head_major_kernels_match_plain_version(dtype, causal, S, T, D):
    """K4's forward (out, lse), dq and dk/dv kernels against their plain
    versions on head-major (BH, S, D) tensors: every padded width the
    kernels are built for, S != T and S not a multiple of the tile; the
    backward fed its forward's lse and a shifted one (the ring
    contract)."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [512, 384])
def test_ring_on_the_card_matches_the_cpu(dtype, causal, S):
    """ring_dot_product_attention over 4 shards (B 2, H 4, Hkv 2, D 64):
    the card's output and gradients against the same ring on the CPU (the
    plain versions). At S 512 (s_loc 128, the K5 ring) K5 launches once
    per folded block (10 causal, 16 not) and K4's dq and dk/dv kernels
    once each per folded block in backward; at S 384 (s_loc 96, the
    einsum ring) no kernel launches."""
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
        folded = (10 if causal else 16) if S % (4 * 128) == 0 else 0
        assert [kk.launches - c for kk, c in zip(kernels, counts)] == (
            [folded] * 3 if device == "cuda" else [0] * 3)
    fwd_tol, grad_tol = FLASH_TOLS[dtype]
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), *results,
                               (fwd_tol,) + (grad_tol,) * 3):
        assert a.dtype == dtype
        ok, err = _close(a, b, tol)
        assert ok, (name, err)
