"""Tests of the port's hand-written CUDA kernels; they need an NVIDIA card
(Hopper, sm_90a) and the CUDA toolkit, and skip without a card. Run them
on the card with:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same inputs."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
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
                                 (1000, 128)])
def test_flash_kernels_match_plain_version(dtype, causal, S, D):
    """K1 (out, lse) and K2 (dq, dk, dv from a fixed, non-contiguous dO)
    against the plain version's forward and autograd gradients, GQA
    (H 4, Hkv 2), S = T including a ragged 1000."""
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
    flash_attention(*leaves, causal=causal, scale=scale).backward(do)
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
    _needs_card()
    q = torch.zeros(1, 8, 2, 96, device="cuda")
    with pytest.raises(ValueError, match="K4"):
        flash_attention(q, q, q, causal=True, scale=0.1)
    q = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, causal=True, scale=0.1)
