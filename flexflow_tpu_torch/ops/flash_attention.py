"""Flash attention with a hand-written forward and backward (counterpart of
flexflow_tpu/ops/pallas/flash_attention.py).

`flash_attention(q, k, v, causal=, scale=)` takes the reference's layout,
q (B, S, H, D) and k/v (B, T, Hkv, D) with H % Hkv == 0, and returns
(B, S, H, D) in q's dtype. On CUDA tensors it is `FlashAttentionFunction`,
whose forward is kernel K1 (csrc/flash_attention_fwd.cu) and whose
backward is kernel K2's two launches, dq and dk/dv
(csrc/flash_attention_bwd.cu), or it raises on what the kernels do not
take. On CPU tensors it is the plain version, `flash_attention_reference`,
whose gradient comes from autograd through its dense ops. There is no
availability gate and no switch: the reference's
`flash_attention_available` is not carried over.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.kernels import (
    KERNEL_DTYPES,
    launch_flash_attention_dkv,
    launch_flash_attention_dq,
    launch_flash_attention_fwd,
)

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_reference(q, k, v, causal: bool, scale: float):
    """The plain version of K1's contract: (out, lse). Dense fp32 logits
    times `scale`; under `causal` the top-left mask (query qpos sees key
    kpos when qpos >= kpos) sets masked logits to -1e30; probabilities
    are rounded to q's dtype before the value product; out in q's dtype;
    lse is the fp32 logsumexp of the masked, scaled logits, (B, H, S).
    GQA: q head h reads kv head h // rep."""
    S, H = q.shape[1], q.shape[2]
    T, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        visible = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~visible, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype), lse


def _backward_terms(q, k, v, dout, lse, delta, causal, scale):
    """What both backward kernels recompute, densely: k and v repeated to
    the q heads, p = exp(s - lse) and ds = p * (dp - delta) * scale, all
    fp32 (B, H, S, T)."""
    S, H = q.shape[1], q.shape[2]
    T, Hkv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Hkv, dim=2).float()
    vr = v.repeat_interleave(H // Hkv, dim=2).float()
    s = torch.einsum("bshd,bthd->bhst", q.float(), kr) * scale
    if causal:
        visible = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bshd,bthd->bhst", dout.float(), vr)
    ds = p * (dp - delta[..., None]) * scale
    return kr, p, ds


def flash_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                       scale: float):
    """The plain version of K2's dq kernel: dq = ds (rounded to k's
    dtype) . k, summed in fp32, in q's dtype."""
    kr, _, ds = _backward_terms(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.einsum("bhst,bthd->bshd", ds.to(k.dtype).float(), kr)
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                        scale: float):
    """The plain version of K2's dk/dv kernel: dk = ds (rounded to q's
    dtype) . q and dv = p (rounded to dO's dtype) . dO, summed in fp32
    over the queries and the GQA group's heads, at Hkv heads."""
    _, p, ds = _backward_terms(q, k, v, dout, lse, delta, causal, scale)
    B, T, Hkv, D = k.shape
    rep = q.shape[2] // Hkv
    dk = torch.einsum("bhst,bshd->bthd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhst,bshd->bthd", p.to(dout.dtype).float(),
                      dout.float())
    return (dk.reshape(B, T, Hkv, rep, D).sum(3).to(k.dtype),
            dv.reshape(B, T, Hkv, rep, D).sum(3).to(v.dtype))


def flash_delta(dout, out):
    """The backward's pre-pass, delta = sum_d dO * O per (b, h, s), fp32
    (B, H, S) (the reference's einsum outside its kernels)."""
    return torch.einsum("bshd,bshd->bhs", dout.float(),
                        out.float()).contiguous()


def _check_kernel_args(q, k, v):
    B, S, H, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, T, Hkv, D) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the flash kernels take head dim 64 or 128, got {D}; other "
            "head dims are the reference's head-major path, kernel K4 "
            "(ROADMAP.md, queue 2)")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the flash kernels take float32 or bfloat16 q, k "
                         f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward, K2 backward. Saves (q, k, v, out, lse), as the
    reference's `_flash_bshd_fwd` does; the backward computes delta with
    torch ops, then launches the dq and the dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        B, S, H, _ = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        launch_flash_attention_fwd(q, k, v, out, lse, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # the output projection's backward may hand over a strided view
        dout = dout.contiguous()
        delta = flash_delta(dout, out)
        dq = torch.empty_like(q)
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        launch_flash_attention_dq(q, k, v, dout, lse, delta, dq, ctx.causal,
                                  ctx.scale)
        launch_flash_attention_dkv(q, k, v, dout, lse, delta, dk, dv,
                                   ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, scale: float = 1.0):
    """Flash attention, (B, S, H, D) in q's dtype. CUDA tensors launch the
    kernels (and raise on anything they do not take); CPU tensors take
    the plain version. Mixed devices raise."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_reference(q, k, v, causal, scale)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"q on {q.device}")
    _check_kernel_args(q, k, v)
    return FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale))
