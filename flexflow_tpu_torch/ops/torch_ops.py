"""PyTorch lowerings of the Llama serving path's operators (counterpart of
flexflow_tpu/ops/jax_ops.py).

Each lowering reproduces the reference's numerics discipline: weights
are cast to the activation dtype at the use site, matmuls accumulate in
fp32 and round to the activation dtype, RMSNorm computes in fp32. Plain
matmuls and elementwise ops go to PyTorch, as the JAX package left them
to XLA; the one hand-written kernel on this path is the ragged paged
attention behind the MULTIHEAD_ATTENTION lowering's paged branch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, OpType
from flexflow_tpu_torch.ops.registry import register_lowering


def apply_activation(x, act: ActiMode):
    if act == ActiMode.NONE:
        return x
    if act == ActiMode.RELU:
        return F.relu(x)
    if act == ActiMode.SIGMOID:
        return torch.sigmoid(x)
    if act == ActiMode.TANH:
        return torch.tanh(x)
    if act == ActiMode.GELU:
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if act == ActiMode.SILU:
        return F.silu(x)
    raise ValueError(f"unknown activation {act}")


@register_lowering(OpType.LINEAR)
def _linear(attrs, inputs, params, ctx):
    (x,) = inputs
    y = torch.matmul(x, params["kernel"].to(x.dtype))
    if attrs.use_bias:
        y = y + params["bias"].to(x.dtype)
    return [apply_activation(y, attrs.activation)]


@register_lowering(OpType.EMBEDDING)
def _embedding(attrs, inputs, params, ctx):
    (ids,) = inputs
    out = params["kernel"][ids.long()]
    if attrs.aggr == AggrMode.SUM:
        out = out.sum(dim=-2)
    elif attrs.aggr == AggrMode.AVG:
        out = out.mean(dim=-2)
    # the op's declared dtype sets the activation dtype downstream
    return [out.to(attrs.dtype.torch_dtype)]


# ---------------------------------------------------------------------------
# attention


def apply_rope(x, theta: float, pos_offset=0):
    """Rotary position embedding, half-split (rotate_half) convention.
    x: (B, S, H, D). `pos_offset` is a scalar, a (B,) vector of per-row
    offsets, or a (B, S) matrix of ABSOLUTE per-token positions. Angles
    and sin/cos are computed in fp32; the rotation runs in x's dtype."""
    B, S, H, D = x.shape
    if D % 2 != 0:
        raise ValueError(f"RoPE requires an even head dim, got {D}")
    d2 = D // 2
    dev = x.device
    # a Python-scalar base: torch.tensor(theta, device=cuda) would be a
    # blocking host-to-device copy in every layer
    freqs = float(theta) ** (
        -torch.arange(0, d2, dtype=torch.float32, device=dev) / d2)
    off = torch.as_tensor(pos_offset, dtype=torch.float32, device=dev)
    if off.ndim == 2:
        pos = off                                              # (B, S)
    else:
        pos = (torch.arange(S, dtype=torch.float32, device=dev)[None, :]
               + off.reshape(-1, 1))                          # (B|1, S)
    ang = pos[:, :, None] * freqs[None, None, :]              # (B|1, S, d2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def qkv_project(x, w, dt):
    """(B,S,E) x (E,H,D) -> (B,S,H,D) through the weight's [E, H*D] view."""
    E, H, D = w.shape
    y = torch.matmul(x, w.reshape(E, H * D).to(dt))
    return y.reshape(*x.shape[:-1], H, D)


def attn_out_project(o, w, dt):
    """(B,S,H,D) x (H,D,E) -> (B,S,E) through the [H*D, E] view."""
    H, D, E = w.shape
    return torch.matmul(o.reshape(*o.shape[:-2], H * D),
                        w.reshape(H * D, E).to(dt))


def dot_product_attention(q, k, v, scale: float, mask):
    """q: (B,S,H,D), k/v: (B,T,Hkv,D), mask (B,S,T) bool -> (B,S,H,D).
    fp32 logits and softmax; probabilities rounded to q's dtype before
    the value product. GQA: q head h reads kv head h // rep (heads are
    grouped contiguously, jnp.repeat's order)."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[:, None],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


@register_lowering(OpType.MULTIHEAD_ATTENTION)
def _mha(attrs, inputs, params, ctx):
    q_in = inputs[0]
    k_in = inputs[1] if len(inputs) > 1 else q_in
    v_in = inputs[2] if len(inputs) > 2 else k_in
    dt = q_in.dtype
    q = qkv_project(q_in, params["wq"], dt)
    k = qkv_project(k_in, params["wk"], dt)
    v = qkv_project(v_in, params["wv"], dt)
    if attrs.use_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if ctx.kv_cache is None or ctx.page_tables is None:
        raise NotImplementedError(
            "the port lowers attention only on the paged serving path; "
            "dense and training attention (flash kernels) are ROADMAP.md "
            "queue 2")
    # every paged step — decode rows and chunked-prefill pieces — is the
    # same ragged call: rope, write this step's K/V rows into their pool
    # pages, attend through the page table (paged/attention.py)
    from flexflow_tpu_torch.paged.attention import ragged_paged_attention

    out, kc, vc = ragged_paged_attention(
        q, k, v, ctx.kv_cache["k"], ctx.kv_cache["v"], ctx.page_tables,
        ctx.cache_position, ctx.ragged_q_lens, ctx.ragged_depths,
        ctx.ragged_anc, scale=1.0 / (attrs.kdim ** 0.5),
        rope_theta=attrs.rope_theta if attrs.rope else None)
    ctx.cache_updates["k"] = kc
    ctx.cache_updates["v"] = vc
    y = attn_out_project(out, params["wo"], dt)
    if attrs.use_bias:
        y = y + params["bo"].to(dt)
    return [y]


# ---------------------------------------------------------------------------
# elementwise / norm / softmax


_BINARY = {
    "add": torch.add,
    "subtract": torch.subtract,
    "multiply": torch.multiply,
    "divide": torch.divide,
    "max": torch.maximum,
    "min": torch.minimum,
}


@register_lowering(OpType.ELEMENT_BINARY)
def _element_binary(attrs, inputs, params, ctx):
    if attrs.position_table:
        raise NotImplementedError(
            "learned position tables are not ported yet (ROADMAP.md, "
            "queue 1)")
    a, b = inputs
    return [_BINARY[attrs.kind](a, b)]


_UNARY = {
    "exp": torch.exp,
    "sin": torch.sin,
    "cos": torch.cos,
    "relu": F.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "rsqrt": torch.rsqrt,
    "silu": F.silu,
    "identity": lambda v: v,
}


@register_lowering(OpType.ELEMENT_UNARY)
def _element_unary(attrs, inputs, params, ctx):
    (x,) = inputs
    k, s = attrs.kind, attrs.scalar
    if k == "pow":
        return [torch.pow(x, s)]
    if k == "scalar_add":
        return [x + s]
    if k == "scalar_sub":
        return [x - s]
    if k == "scalar_multiply":
        return [x * s]
    if k == "scalar_truediv":
        return [x / s]
    return [_UNARY[k](x)]


@register_lowering(OpType.RMS_NORM)
def _rms_norm(attrs, inputs, params, ctx):
    (x,) = inputs
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + attrs.eps) * params["scale"].float()
    return [y.to(x.dtype)]


@register_lowering(OpType.SOFTMAX)
def _softmax(attrs, inputs, params, ctx):
    return [torch.softmax(inputs[0], dim=attrs.axis)]
