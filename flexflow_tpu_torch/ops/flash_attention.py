"""Flash attention with a hand-written forward and backward (counterpart of
flexflow_tpu/ops/pallas/flash_attention.py).

`flash_attention(q, k, v, causal=, scale=)` takes the reference's layout,
q (B, S, H, D) and k/v (B, T, Hkv, D) with H % Hkv == 0, and returns
(B, S, H, D) in q's dtype. It routes as the reference does:

- head dim a multiple of 128 (128 to 512 are built; bf16 at 128 and 256
  runs on the tensor cores): the flat-layout kernels on the projection
  layout, `FlashAttentionFunction`, whose forward is kernel K1
  (csrc/flash_attention_fwd.cu) and whose backward is kernel K2's dq and
  dk/dv launches (csrc/flash_attention_bwd.cu), GQA resolved in-kernel;
- any other head dim: the head-major route. kv heads are repeated to H
  (jnp.repeat's order), q/k/v transposed to (B * H, S, D) and handed to
  `FlashAttentionHeadMajorFunction`: kernel K4's forward
  (csrc/flash_attention_bh_fwd.cu), and in backward the delta pre-pass
  and K4's dq and dk/dv kernels (csrc/flash_attention_bh_bwd.cu). The
  repeat's autograd sums dk/dv over each GQA group. The reference also
  zero-pads D to 128 lanes; that is TPU tiling, and K4 takes D as it is.
  K4 in bf16 at D 64 (GPT-2's and bench.py's 200m Llama's heads), 128
  and 256, at D 48, 80 and 96 (Phi-3-mini's heads) on tiles that TMA
  zero-pads to 64 / 128 columns, and at D 100 (OpenLLaMA-3B's heads,
  200-byte rows that are no TMA stride) on the same tiles filled by
  cp.async, runs on the tensor cores, through the bodies K1/K2 run
  (csrc/flash_wgmma_fwd.cuh, csrc/flash_wgmma_bwd.cuh); in fp32 at D 64,
  128 and 256 (forward, dq and dk/dv) on them too, in 3xTF32
  (csrc/flash_tf32.cuh; the arithmetic `einsum_3xtf32` emulates). The
  other cases run K4's CUDA-core bodies: fp32 at every other width, bf16
  at the others. A tensor a tensor-core body cannot load (a base that is
  not 16-byte aligned for TMA, not 8-byte aligned for D 100's cp.async)
  raises; no other body takes over. K2's fp32 dq and dk/dv at D
  128 and 256 run the same 3xTF32 body on the flat layout; K1 in fp32
  stays on the CUDA cores. Which body runs is the C entry's choice by
  dtype and D; the route here is by D alone.

The ring's step kernel K5 (`flash_bh_fwd_carry`, the reference's
`_fwd_carry`) sits beside K4: it folds one head-major k/v block into
carried fp32 statistics (m, l, acc) and is driven by ops/ring_flash.py.
In bf16 it runs K4's tensor-core forward body at K4's tensor-core widths
(48, 64, 80, 96, 100, 128 and 256; the ring at Phi-3-mini's D 96 and
OpenLLaMA-3B's D 100 among them), the carried state loaded into its
accumulators and written back; in fp32, and in bf16 at other widths, the
CUDA-core body. An acc that is not 8-byte aligned (the tensor-core body's
two-float loads) raises, as the K4 bases above do.

On CUDA tensors each kernel launches or the wrapper raises on what it does
not take. On CPU tensors the flat route is the plain version
`flash_attention_reference` with autograd through its dense ops, and the
head-major route runs the same autograd.Function over the plain versions
of K4's three contracts (`flash_bh_reference`, `flash_bh_dq_reference`,
`flash_bh_dkv_reference`); K5's is `flash_bh_fwd_carry_reference`. There
is no availability gate and no switch: the reference's
`flash_attention_available` is not carried over.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.kernels import (
    BH_MAX_HEAD_DIM,
    BH_MAX_HEADS,
    KERNEL_DTYPES,
    launch_flash_attention_bh_dkv,
    launch_flash_attention_bh_dq,
    launch_flash_attention_bh_fwd,
    launch_flash_attention_bh_fwd_carry,
    launch_flash_attention_dkv,
    launch_flash_attention_dq,
    launch_flash_attention_fwd,
)

NEG_INF = -1e30
LANES = 128
# the head dims the flat-layout kernels K1/K2 are built for: the
# reference's flat route takes every multiple of 128; the kernels' fp32
# tiles (and no model of the repo) go past 512 (csrc/flash_common.cuh,
# kMaxFlatHeadDim)
FLAT_MAX_HEAD_DIM = 512
FLAT_HEAD_DIMS = (64, 128, 256, 384, 512)


def flash_attention_reference(q, k, v, causal: bool, scale: float, *,
                              einsum=torch.einsum):
    """The plain version of K1's contract: (out, lse). Dense fp32 logits
    times `scale`; under `causal` the top-left mask (query qpos sees key
    kpos when qpos >= kpos) sets masked logits to -1e30; probabilities
    are rounded to q's dtype before the value product; out in q's dtype;
    lse is the fp32 logsumexp of the masked, scaled logits, (B, H, S).
    GQA: q head h reads kv head h // rep. `einsum` computes both products
    (einsum_3xtf32 emulates the card's fp32 tensor-core arithmetic)."""
    S, H = q.shape[1], q.shape[2]
    T, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        visible = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~visible, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    out = einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype), lse


def _backward_terms(q, k, v, dout, lse, delta, causal, scale,
                    einsum=torch.einsum):
    """What both backward kernels recompute, densely: k and v repeated to
    the q heads, p = exp(s - lse) and ds = p * (dp - delta) * scale, all
    fp32 (B, H, S, T)."""
    S, H = q.shape[1], q.shape[2]
    T, Hkv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Hkv, dim=2).float()
    vr = v.repeat_interleave(H // Hkv, dim=2).float()
    s = einsum("bshd,bthd->bhst", q.float(), kr) * scale
    if causal:
        visible = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~visible, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = einsum("bshd,bthd->bhst", dout.float(), vr)
    ds = p * (dp - delta[..., None]) * scale
    return kr, p, ds


def flash_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                       scale: float, *, einsum=torch.einsum):
    """The plain version of K2's dq kernel: dq = ds (rounded to k's
    dtype) . k, summed in fp32, in q's dtype; `einsum` computes every
    product (einsum_3xtf32 emulates the fp32 card body's arithmetic)."""
    kr, _, ds = _backward_terms(q, k, v, dout, lse, delta, causal, scale,
                                einsum)
    dq = einsum("bhst,bthd->bshd", ds.to(k.dtype).float(), kr)
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                        scale: float, *, einsum=torch.einsum):
    """The plain version of K2's dk/dv kernel: dk = ds (rounded to q's
    dtype) . q and dv = p (rounded to dO's dtype) . dO, summed in fp32
    over the queries and the GQA group's heads, at Hkv heads; `einsum`
    as for dq."""
    _, p, ds = _backward_terms(q, k, v, dout, lse, delta, causal, scale,
                               einsum)
    B, T, Hkv, D = k.shape
    rep = q.shape[2] // Hkv
    dk = einsum("bhst,bshd->bthd", ds.to(q.dtype).float(), q.float())
    dv = einsum("bhst,bshd->bthd", p.to(dout.dtype).float(), dout.float())
    return (dk.reshape(B, T, Hkv, rep, D).sum(3).to(k.dtype),
            dv.reshape(B, T, Hkv, rep, D).sum(3).to(v.dtype))


def flash_delta(dout, out):
    """The backward's pre-pass, delta = sum_d dO * O per (b, h, s), fp32
    (B, H, S) (the reference's einsum outside its kernels)."""
    return torch.einsum("bshd,bshd->bhs", dout.float(),
                        out.float()).contiguous()


# ---------------------------------------------------------------------------
# K4: the head-major contracts on (BH, S, D) q and (BH, T, D) k/v


def tf32_round(x):
    """fp32 x rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32: add half of the dropped 13 bits'
    weight to the bit pattern, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def einsum_3xtf32(eq: str, a, b):
    """The fp32 products of the 3xTF32 bodies on the card (K4's fp32
    forward, dq and dk/dv; K2's fp32 dq and dk/dv): each operand split as
    hi = tf32(x), lo = tf32(x - hi), and a . b summed as a_lo . b_hi +
    a_hi . b_lo + a_hi . b_hi in fp32 (lo . lo dropped). A plain
    emulation for checking the numerics against the reference."""
    a, b = a.float(), b.float()
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _bh_scores(q, k, causal, scale, einsum=torch.einsum):
    """fp32 (BH, S, T) scores times `scale`, -1e30 where the top-left
    causal mask hides a key."""
    s = einsum("bsd,btd->bst", q.float(), k.float()) * scale
    if causal:
        visible = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                             device=q.device).tril()
        s = s.masked_fill(~visible, NEG_INF)
    return s


def flash_bh_reference(q, k, v, causal: bool, scale: float, *,
                       einsum=torch.einsum):
    """The plain version of K4's forward (`_fwd`): (out, lse) of attention
    over head-major q (BH, S, D) and k/v (BH, T, D). Probabilities are
    rounded to v's dtype before the value product; out in q's dtype; lse
    the fp32 (BH, S) logsumexp of the masked, scaled scores. `einsum`
    computes both products (einsum_3xtf32 emulates the fp32 card body's
    arithmetic)."""
    s = _bh_scores(q, k, causal, scale, einsum)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    out = einsum("bst,btd->bsd", p.float(), v.float())
    return out.to(q.dtype), lse


def flash_bh_fwd_carry_reference(q, k, v, m, l, acc, causal: bool,
                                 scale: float):
    """The plain version of K5 (`_fwd_carry`, tile math `_online_block`):
    fold head-major k/v (BH, T, D) into the carried fp32 statistics of q
    (BH, S, D), m and l (BH, S) and acc (BH, S, D). With fp32 scores s
    (masked -1e30 under `causal`): m' = max(m, rowmax s), corr =
    exp(m - m'), p = exp(s - m'), l' = l corr + sum p, acc' = acc corr +
    (p rounded to v's dtype) . v, summed in fp32. Returns new (m', l',
    acc'), not normalised."""
    s = _bh_scores(q, k, causal, scale)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bst,btd->bsd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * corr[..., None] + pv


def _bh_backward_terms(q, k, v, dout, lse, delta, causal, scale,
                       einsum=torch.einsum):
    """p = exp(s - lse) and ds = p * (dp - delta) * scale, fp32 (BH, S,
    T), from the lse and delta the caller gives."""
    p = torch.exp(_bh_scores(q, k, causal, scale, einsum) - lse[..., None])
    dp = einsum("bsd,btd->bst", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bh_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                          scale: float, *, einsum=torch.einsum):
    """The plain version of K4's dq kernel (`_dq_kernel`): dq = ds
    (rounded to k's dtype) . k, summed in fp32, in q's dtype. `einsum`
    computes every product (einsum_3xtf32 emulates the fp32 card body's
    arithmetic)."""
    _, ds = _bh_backward_terms(q, k, v, dout, lse, delta, causal, scale,
                               einsum)
    dq = einsum("bst,btd->bsd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_bh_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                           scale: float, *, einsum=torch.einsum):
    """The plain version of K4's dk/dv kernel (`_dkv_kernel`): dk = ds
    (rounded to q's dtype) . q and dv = p (rounded to dO's dtype) . dO,
    summed in fp32 over the queries, at BH heads; `einsum` as for dq."""
    p, ds = _bh_backward_terms(q, k, v, dout, lse, delta, causal, scale,
                               einsum)
    dk = einsum("bst,bsd->btd", ds.to(q.dtype).float(), q.float())
    dv = einsum("bst,bsd->btd", p.to(dout.dtype).float(), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bh_delta(dout, out):
    """delta = sum_d dO * O per (bh, s), fp32 (BH, S): the reference's
    einsum in `_bwd` (flash_attention.py:486)."""
    return torch.einsum("bsd,bsd->bs", dout.float(),
                        out.float()).contiguous()


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check_bh_args(q, k, v, *grads):
    """Raise on what K4 does not take: q (BH, S, D), k/v (BH, T, D) of one
    float32/bfloat16 dtype on one CUDA device, D <= 256, BH <= 65535;
    `grads` (dO) are (BH, S, D) in q's dtype. What only the tensor-core
    bodies refuse (a base address TMA cannot map: not 16-byte aligned)
    comes back from the C entry as cudaErrorInvalidValue, and the launch
    raises (kernels.CudaKernel.check): no other body takes over."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"K4 takes q (BH, S, D) and k, v (BH, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, _, D = q.shape
    if D > BH_MAX_HEAD_DIM:
        raise ValueError(f"K4 takes head dims up to {BH_MAX_HEAD_DIM} "
                         f"(csrc/flash_bh_common.cuh), got {D}")
    if BH > BH_MAX_HEADS:
        raise ValueError(f"K4 takes B * H up to {BH_MAX_HEADS}, got {BH}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            ("dO", g) for g in grads):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"K4 runs on one CUDA device; {name} is on "
                             f"{t.device}, q on {q.device}")
        if t.dtype not in KERNEL_DTYPES or t.dtype != q.dtype:
            raise ValueError(f"K4 takes float32 or bfloat16 tensors of one "
                             f"dtype; {name} is {t.dtype}, q {q.dtype}")
    for g in grads:
        if g.shape != q.shape:
            raise ValueError(f"dO {tuple(g.shape)} must match q "
                             f"{tuple(q.shape)}")


def _check_stats(q, *stats):
    """lse and delta (or K5's m and l): fp32 (BH, S) on q's device."""
    for t in stats:
        if t.dtype != torch.float32 or t.shape != q.shape[:2] \
                or t.device != q.device:
            raise ValueError(f"row statistics must be float32 "
                             f"{tuple(q.shape[:2])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_bh_forward(q, k, v, causal: bool, scale: float):
    """K4's forward: (out (BH, S, D) in q's dtype, lse (BH, S) fp32). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if _on_cpu(q, k, v):
        return flash_bh_reference(q, k, v, causal, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_bh_args(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return launch_flash_attention_bh_fwd(q, k, v, out, lse, causal, scale)


def flash_bh_fwd_carry(q, k, v, m, l, acc, causal: bool, scale: float):
    """K5, one ring step: (m', l', acc') after folding k/v into the
    carried statistics. CPU tensors take the plain version (new tensors);
    CUDA tensors launch the kernel, which updates m, l and acc in place
    and returns them, or raise."""
    if _on_cpu(q, k, v, m, l, acc):
        return flash_bh_fwd_carry_reference(q, k, v, m, l, acc, causal,
                                            scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_bh_args(q, k, v)
    _check_stats(q, m, l)
    if acc.dtype != torch.float32 or acc.shape != q.shape \
            or acc.device != q.device:
        raise ValueError(f"acc must be float32 {tuple(q.shape)} on "
                         f"{q.device}, got {acc.dtype} {tuple(acc.shape)} "
                         f"on {acc.device}")
    for name, t in (("m", m), ("l", l), ("acc", acc)):
        if not t.is_contiguous():
            raise ValueError(f"K5 updates {name} in place: it must be "
                             "contiguous")
    return launch_flash_attention_bh_fwd_carry(q, k, v, m, l, acc, causal,
                                               scale)


def flash_bh_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K4's dq from the caller's lse and delta (the forward's own, or the
    ring's final lse). CPU: plain version; CUDA: the kernel or raise."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_bh_dq_reference(q, k, v, dout, lse, delta, causal,
                                     scale)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    lse, delta = lse.contiguous(), delta.contiguous()
    _check_bh_args(q, k, v, dout)
    _check_stats(q, lse, delta)
    return launch_flash_attention_bh_dq(q, k, v, dout, lse, delta,
                                        torch.empty_like(q), causal, scale)


def flash_bh_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K4's (dk, dv) at BH heads from the caller's lse and delta. CPU:
    plain version; CUDA: the kernel or raise."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_bh_dkv_reference(q, k, v, dout, lse, delta, causal,
                                      scale)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    lse, delta = lse.contiguous(), delta.contiguous()
    _check_bh_args(q, k, v, dout)
    _check_stats(q, lse, delta)
    return launch_flash_attention_bh_dkv(q, k, v, dout, lse, delta,
                                         torch.empty_like(k),
                                         torch.empty_like(v), causal, scale)


class FlashAttentionHeadMajorFunction(torch.autograd.Function):
    """K4 forward and backward on head-major (BH, S, D) tensors (the
    reference's `_flash` custom VJP). Saves (q, k, v, out, lse); the
    backward computes delta with torch ops, then runs the dq and the
    dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_bh_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_bh_delta(dout, out)
        dq = flash_bh_dq(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bh_dkv(q, k, v, dout, lse, delta, ctx.causal,
                              ctx.scale)
        return dq, dk, dv, None, None


def _head_major_attention(q, k, v, causal: bool, scale: float):
    """The reference's fallback route (flash_attention.py:625-642) without
    its lane padding: repeat kv to H heads, transpose to (B * H, S, D),
    run K4, transpose back to (B, S, H, D)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)

    def to_bh(x):
        return x.transpose(1, 2).reshape(B * H, x.shape[1], D)

    out = FlashAttentionHeadMajorFunction.apply(to_bh(q), to_bh(k), to_bh(v),
                                                bool(causal), float(scale))
    return out.reshape(B, H, S, D).transpose(1, 2)


# ---------------------------------------------------------------------------
# K1/K2 and the public entry


def _check_kernel_args(q, k, v):
    """Raise on what the flat-layout kernels K1/K2 do not take."""
    B, S, H, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, T, Hkv, D) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if D not in FLAT_HEAD_DIMS:
        raise ValueError(
            f"the flat-layout kernels K1/K2 take head dims 64 and the "
            f"multiples of 128 up to {FLAT_MAX_HEAD_DIM}, got {D}; other "
            "head dims take K4")
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
    """Flash attention, (B, S, H, D) in q's dtype, routed by head dim as
    the reference routes it: D % 128 == 0 to K1/K2, any other D to K4 on
    the head-major layout. CUDA tensors launch the kernels (and raise on
    anything they do not take); CPU tensors take the plain versions.
    Mixed devices raise."""
    B, S, H, D = q.shape
    if H % k.shape[2] != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k.shape[2]}")
    on_cpu = _on_cpu(q, k, v)
    if not on_cpu and q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"q on {q.device}")
    if D % LANES != 0:
        return _head_major_attention(q, k, v, causal, scale)
    if on_cpu:
        return flash_attention_reference(q, k, v, causal, scale)[0]
    _check_kernel_args(q, k, v)
    return FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale))
