"""PyTorch lowerings of the ported operators (counterpart of
flexflow_tpu/ops/jax_ops.py): every op the JAX package lowers.

Each lowering reproduces the reference's numerics discipline: weights
are cast to the activation dtype at the use site, matmuls accumulate in
fp32 and round to the activation dtype, RMSNorm and LayerNorm compute in
fp32. Plain matmuls and elementwise ops go to PyTorch, as the JAX package
left them
to XLA; the hand-written kernels on this path are behind the
MULTIHEAD_ATTENTION lowering: the ragged paged attention on its paged
branch (serving), the flash-attention forward and backward on its
no-cache branch (training, eval and predict); and behind RING_ATTENTION's
no-cache branch, the ring of K5 steps (parallel/ring.py); and behind
PIPELINE, whose decoder blocks take MULTIHEAD_ATTENTION's route. Its
dense-cache branch (FFModel.generate, the dense GenerationServer) and
PIPELINE's are plain PyTorch,
as the reference computes it outside any Pallas kernel, and so is the
attention of a training step at a dropout rate above 0: the reference
sends dropout to no kernel (flash_attention_available is False for it)
and computes it densely, and so does the port (dense_dropout_attention,
counted in DENSE_DROPOUT_ATTENTION). Conv, pooling, BatchNorm and the
LSTM are PyTorch ops (cuDNN's convolution among them), as the
reference's are lax/jnp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, OpType, PoolType
from flexflow_tpu_torch.ops.flash_attention import flash_attention
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


@register_lowering(OpType.INPUT)
def _input(attrs, inputs, params, ctx):
    raise RuntimeError("INPUT nodes are bound by the executor, not lowered")


@register_lowering(OpType.NOOP)
def _noop(attrs, inputs, params, ctx):
    return [inputs[0]]


def _reshard(attrs, inputs, params, ctx):
    """A parallel op (REPARTITION, COMBINE, REPLICATE, REDUCTION,
    ALL_TO_ALL, FUSED_PARALLEL) changes where a tensor's pieces live, not
    its value; on the port's one device every piece lives on that device,
    so the node passes its input on, as the reference's sharding
    constraint does on a one-device mesh."""
    return [inputs[0]]


for _op in (OpType.REPARTITION, OpType.COMBINE, OpType.REPLICATE,
            OpType.REDUCTION, OpType.ALL_TO_ALL, OpType.FUSED_PARALLEL):
    register_lowering(_op)(_reshard)


@register_lowering(OpType.WEIGHT)
def _weight(attrs, inputs, params, ctx):
    # the stored parameter as it is, as the reference returns it: a
    # floating weight is stored fp32 (its fp32 master; Executor
    # .storage_dtype), so a bf16 model's position add promotes the
    # residual stream to fp32 from there on, as jnp promotion does
    return [params["weight"]]


@register_lowering(OpType.LINEAR)
def _linear(attrs, inputs, params, ctx):
    (x,) = inputs
    y = torch.matmul(x, params["kernel"].to(x.dtype))
    if attrs.use_bias:
        y = y + params["bias"].to(x.dtype)
    return [apply_activation(y, attrs.activation)]


@register_lowering(OpType.CONV2D)
def _conv2d(attrs, inputs, params, ctx):
    """NCHW x OIHW, symmetric padding, feature groups; the bias added
    after the convolution in x's dtype, as the reference adds it."""
    (x,) = inputs
    y = F.conv2d(x, params["kernel"].to(x.dtype), stride=attrs.stride,
                 padding=attrs.padding, groups=attrs.groups)
    if attrs.use_bias:
        y = y + params["bias"].to(x.dtype)[None, :, None, None]
    return [apply_activation(y, attrs.activation)]


def matmul_f32(a, b):
    """a @ b summed in fp32 and rounded once to a's dtype (the
    reference's preferred_element_type=float32 then astype)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


@register_lowering(OpType.BATCH_MATMUL)
def _batch_matmul(attrs, inputs, params, ctx):
    a, b = inputs
    if ctx.seq_length is not None:
        # the iteration config's truncation of the marked dims
        if attrs.a_seq_length_dim >= 0:
            a = a.narrow(attrs.a_seq_length_dim, 0, ctx.seq_length)
        if attrs.b_seq_length_dim >= 0:
            b = b.narrow(attrs.b_seq_length_dim, 0, ctx.seq_length)
    return [matmul_f32(a, b)]


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
    ar = torch.arange(S, dtype=torch.float32, device=dev)[None, :]
    if isinstance(pos_offset, (int, float)):
        # a Python offset (the training path's 0) stays on the host: a
        # device tensor made from it would be a blocking copy per layer
        pos = ar + float(pos_offset)                           # (1, S)
    else:
        off = torch.as_tensor(pos_offset, dtype=torch.float32, device=dev)
        pos = off if off.ndim == 2 else ar + off.reshape(-1, 1)  # (B|1, S)
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


def cached_attention(q, k, v, cache_k, cache_v, pos, *, scale: float,
                     rope_theta=None):
    """One autoregressive step over a DENSE KV cache (counterpart of
    jax_ops.cached_attention): rope at absolute positions (when
    `rope_theta`), write k/v into the (B, T, Hkv, D) caches at `pos`, in
    place, then attend over the whole buffer under the absolute-position
    mask (cache row kpos is visible to query row i when kpos <= pos + i;
    rows past the write head stay masked until written) in
    dot_product_attention's numerics. `pos` is a Python int (lockstep
    generate and the dense admission's prefill) or a (B,) tensor (the
    dense server's per-slot positions). As the reference's
    dynamic_update_slice, a write that would run past T starts at T - S
    instead; the mask keeps the unclamped positions. Returns (output,
    cache_k, cache_v)."""
    B, S = q.shape[0], q.shape[1]
    T = cache_k.shape[1]
    dev = q.device
    if rope_theta is not None:
        q = apply_rope(q, rope_theta, pos_offset=pos)
        k = apply_rope(k, rope_theta, pos_offset=pos)
    ar = torch.arange(S, device=dev)
    kpos = torch.arange(T, device=dev)
    if isinstance(pos, int):
        start = min(max(pos, 0), T - S)
        cache_k[:, start:start + S] = k.to(cache_k.dtype)
        cache_v[:, start:start + S] = v.to(cache_v.dtype)
        mask = (kpos[None, :] <= (pos + ar)[:, None]).expand(B, S, T)
    else:
        p = pos.long()
        rows = p.clamp(0, T - S)[:, None] + ar[None, :]          # (B, S)
        bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
        cache_k[bidx, rows] = k.to(cache_k.dtype)
        cache_v[bidx, rows] = v.to(cache_v.dtype)
        mask = kpos[None, None, :] <= (p[:, None] + ar[None, :])[:, :, None]
    out = dot_product_attention(q, cache_k.to(q.dtype),
                                cache_v.to(q.dtype), scale, mask)
    return out, cache_k, cache_v


class RouteCounter:
    """Counts the calls of a route that is not a kernel of the port, as a
    kernel counts its launches (kernels.CudaKernel.launches), so a run can
    show which route its attention took."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


DENSE_DROPOUT_ATTENTION = RouteCounter("dense_dropout_attention")


def dropout_mask(shape, keep: float, gen: torch.Generator, device):
    """Bernoulli(keep) as a bool tensor of `shape`, from `gen`."""
    return torch.rand(shape, generator=gen, device=device) < keep


def dense_dropout_attention(q, k, v, *, causal: bool, scale: float,
                            rate: float, gen: torch.Generator):
    """The reference's `_dot_product_attention` with dropout on the
    probabilities (jax_ops.py:175): fp32 logits and softmax, the
    probabilities rounded to q's dtype, each kept with probability
    1 - rate and scaled by 1 / (1 - rate) in q's dtype, then the value
    product summed in fp32. The route a training step's attention takes
    at a dropout rate above 0, on the card and on the CPU; each call adds
    one to DENSE_DROPOUT_ATTENTION.launches (twice a layer and step under
    remat="attention", whose backward recomputes the forward)."""
    DENSE_DROPOUT_ATTENTION.launches += 1
    B, S, H, _ = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        tri = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tri, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    keep = 1.0 - rate
    probs = (probs / keep).masked_fill(
        ~dropout_mask(probs.shape, keep, gen, q.device), 0)
    out = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
    return out.to(q.dtype)


def fused_attention(q, k, v, *, causal: bool, scale: float,
                    dropout: float = 0.0, gen=None):
    """Attention over the whole sequence (counterpart of
    jax_ops.fused_attention): the flash kernels on the card, their plain
    version on the CPU (ops/flash_attention.py); at a dropout rate above
    0 (a training step's) the dense route with dropout, as the
    reference routes it."""
    if dropout > 0.0:
        return dense_dropout_attention(q, k, v, causal=causal, scale=scale,
                                       rate=dropout, gen=gen)
    return flash_attention(q, k, v, causal=causal, scale=scale)


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
    scale = 1.0 / (attrs.kdim ** 0.5)
    if ctx.kv_cache is None:
        if attrs.rope:
            q = apply_rope(q, attrs.rope_theta)
            k = apply_rope(k, attrs.rope_theta)
        rate = attrs.dropout if ctx.training else 0.0
        out = fused_attention(
            q, k, v, causal=attrs.causal, scale=scale, dropout=rate,
            gen=ctx.generator(q.device) if rate > 0.0 else None)
    elif ctx.page_tables is None:
        # the dense cache (FFModel.generate, the dense GenerationServer):
        # rope, write this step's rows at pos, attend over the buffer
        out, kc, vc = cached_attention(
            q, k, v, ctx.kv_cache["k"], ctx.kv_cache["v"],
            ctx.cache_position, scale=scale,
            rope_theta=attrs.rope_theta if attrs.rope else None)
        ctx.cache_updates.update(k=kc, v=vc)
    else:
        # every paged step — decode rows and chunked-prefill pieces — is
        # the same ragged call: rope, write this step's K/V rows into
        # their pool pages, attend through the page table
        # (paged/attention.py). An int8 pool carries its scale sidecar
        # in the same per-node dict: the write quantizes under grow-only
        # scales and the attention dequantizes on load
        from flexflow_tpu_torch.paged.attention import ragged_paged_attention

        cache = ctx.kv_cache
        res = ragged_paged_attention(
            q, k, v, cache["k"], cache["v"], ctx.page_tables,
            ctx.cache_position, ctx.ragged_q_lens, ctx.ragged_depths,
            ctx.ragged_anc, scale=scale,
            rope_theta=attrs.rope_theta if attrs.rope else None,
            k_scales=cache.get("k_scale"), v_scales=cache.get("v_scale"))
        out = res[0]
        ctx.cache_updates.update(zip(("k", "v", "k_scale", "v_scale"),
                                     res[1:]))
    y = attn_out_project(out, params["wo"], dt)
    if attrs.use_bias:
        y = y + params["bo"].to(dt)
    return [y]


@register_lowering(OpType.RING_ATTENTION)
def _ring_attention(attrs, inputs, params, ctx):
    if ctx.kv_cache is not None:
        # a cached (paged) step has no sequence to cut: ring attention's
        # weights and math are MULTIHEAD_ATTENTION's, so it takes that
        # lowering verbatim, as the reference does
        return _mha(attrs, inputs, params, ctx)
    from flexflow_tpu_torch.parallel.ring import ring_attention_lowering

    return ring_attention_lowering(attrs, inputs, params, ctx)


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


def position_rows(table, seq: int, ctx):
    """The rows of a learned (rows, E) position table that a (B, seq)
    window adds under the cache state of `ctx` (jax_ops._element_binary's
    cases): without a cache the whole table, broadcast over the batch; at
    a scalar position (lockstep dense decode) rows pos .. pos + seq - 1,
    the start clamped so they fit, as the reference's dynamic_slice; in a
    ragged paged step row pos[b] + depths[b, i] for window row i; with
    per-row positions alone rows pos[b] .. pos[b] + seq - 1. Gathered
    indices are clamped into the table, as the reference's gathers clamp:
    only padded rows reach past it, and their outputs are never read."""
    pos = ctx.cache_position
    if pos is None:
        return table
    if isinstance(pos, int):
        start = min(max(pos, 0), table.shape[0] - seq)
        return table[start:start + seq][None]
    depths = ctx.ragged_depths
    if depths is None:
        depths = torch.arange(seq, device=table.device)
    idx = pos.long()[:, None] + depths.long()
    return table[idx.clamp(0, table.shape[0] - 1)]


@register_lowering(OpType.ELEMENT_BINARY)
def _element_binary(attrs, inputs, params, ctx):
    a, b = inputs
    if attrs.position_table:
        b = position_rows(b, a.shape[1], ctx)
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


# ---------------------------------------------------------------------------
# shape ops


@register_lowering(OpType.RESHAPE)
def _reshape(attrs, inputs, params, ctx):
    return [inputs[0].reshape(attrs.shape)]


@register_lowering(OpType.FLAT)
def _flat(attrs, inputs, params, ctx):
    x = inputs[0]
    return [x.reshape(x.shape[0], -1)]


@register_lowering(OpType.TRANSPOSE)
def _transpose(attrs, inputs, params, ctx):
    return [inputs[0].permute(attrs.perm)]


@register_lowering(OpType.REVERSE)
def _reverse(attrs, inputs, params, ctx):
    return [torch.flip(inputs[0], dims=(attrs.axis,))]


@register_lowering(OpType.CONCAT)
def _concat(attrs, inputs, params, ctx):
    return [torch.cat(inputs, dim=attrs.axis)]


@register_lowering(OpType.SPLIT)
def _split(attrs, inputs, params, ctx):
    return list(torch.split(inputs[0], list(attrs.sizes), dim=attrs.axis))


@register_lowering(OpType.CAST)
def _cast(attrs, inputs, params, ctx):
    return [inputs[0].to(attrs.dtype.torch_dtype)]


# ---------------------------------------------------------------------------
# pooling / BatchNorm / dropout


@register_lowering(OpType.POOL2D)
def _pool2d(attrs, inputs, params, ctx):
    """Max pooling pads with -inf; average pooling sums in fp32 and
    divides by kh * kw, the padding included (lax.reduce_window's). The
    padding is explicit, since F.max_pool2d refuses one above half the
    kernel, which the reference takes."""
    (x,) = inputs
    ph, pw = attrs.padding
    pad = (pw, pw, ph, ph)
    if attrs.pool_type == PoolType.MAX:
        if ph or pw:
            x = F.pad(x, pad, value=float("-inf"))
        y = F.max_pool2d(x, attrs.kernel, attrs.stride)
    else:
        xf = x.float()
        if ph or pw:
            xf = F.pad(xf, pad)
        y = F.avg_pool2d(xf, attrs.kernel, attrs.stride).to(x.dtype)
    return [apply_activation(y, attrs.activation)]


@register_lowering(OpType.BATCH_NORM)
def _batch_norm(attrs, inputs, params, ctx):
    """Training normalises with the batch's mean and biased variance over
    (N, H, W) in fp32 and moves the running statistics as (1 - m) *
    running + m * batch, the biased variance included (F.batch_norm's own
    update takes the unbiased one, so the update is written here); eval
    normalises with the running statistics. The affine runs in fp32, the
    result in x's dtype, then the fused ReLU."""
    (x,) = inputs
    xf = x.float()
    scale, bias = params["scale"].float(), params["bias"].float()
    if ctx.training:
        y = F.batch_norm(xf, None, None, scale, bias, training=True,
                         eps=attrs.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            m = attrs.momentum
            for name, stat in (("running_mean", mean), ("running_var", var)):
                old = params[name]
                ctx.state_updates[name] = ((1 - m) * old.float()
                                           + m * stat).to(old.dtype)
    else:
        y = F.batch_norm(xf, params["running_mean"].float(),
                         params["running_var"].float(), scale, bias,
                         training=False, eps=attrs.eps)
    y = y.to(x.dtype)
    return [F.relu(y) if attrs.relu else y]


@register_lowering(OpType.DROPOUT)
def _dropout(attrs, inputs, params, ctx):
    """Identity outside training or at rate 0; otherwise each element kept
    with probability 1 - rate (from the node's stream, ctx.generator) and
    scaled by 1 / (1 - rate) in x's dtype."""
    (x,) = inputs
    if not ctx.training or attrs.rate == 0.0:
        return [x]
    keep = 1.0 - attrs.rate
    mask = dropout_mask(x.shape, keep, ctx.generator(x.device), x.device)
    return [(x / keep).masked_fill(~mask, 0)]


# ---------------------------------------------------------------------------
# gather / reduce


@register_lowering(OpType.GATHER)
def _gather(attrs, inputs, params, ctx):
    """take_along_axis: torch.gather, whose indices are int64 (the graph
    carries int32)."""
    x, idx = inputs
    return [torch.gather(x, attrs.axis, idx.long())]


@register_lowering(OpType.REDUCE_SUM)
def _reduce(attrs, inputs, params, ctx):
    (x,) = inputs
    fn = torch.sum if attrs.kind == "sum" else torch.mean
    return [fn(x, dim=tuple(attrs.axes), keepdim=attrs.keepdims)]


@register_lowering(OpType.MEAN)
def _mean(attrs, inputs, params, ctx):
    (x,) = inputs
    return [torch.mean(x, dim=tuple(attrs.axes), keepdim=attrs.keepdims)]


# ---------------------------------------------------------------------------
# recurrent


@register_lowering(OpType.LSTM)
def _lstm(attrs, inputs, params, ctx):
    """One LSTM layer over the whole sequence, as the reference's
    lax.scan computes it: the input projection of every step is one
    product outside the recurrence; each step adds h @ wh (rounded to x's
    dtype) to it, takes the gates i, f, g, o in fp32, keeps c in fp32 and
    h in x's dtype. `reverse` runs the sequence backwards and flips the
    outputs back. Returns (y, h_n, c_n), c_n in x's dtype. torch.nn.LSTM
    (cuDNN) keeps another weight layout and other rounding points, so the
    loop is written in torch ops."""
    x = inputs[0]
    B, S, _ = x.shape
    dt = x.dtype
    wx = params["wx"].to(dt)
    wh = params["wh"].to(dt)
    h = inputs[1] if len(inputs) > 1 else x.new_zeros(B, attrs.hidden)
    c = (inputs[2] if len(inputs) > 2
         else x.new_zeros(B, attrs.hidden)).float()
    if attrs.reverse:
        x = torch.flip(x, dims=(1,))
    xg = matmul_f32(x, wx)
    if attrs.use_bias:
        xg = xg + params["bias"].to(dt)
    ys = []
    for t in range(S):
        gates = (xg[:, t] + matmul_f32(h, wh)).float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(dt)
        ys.append(h)
    y = torch.stack(ys, dim=1)
    if attrs.reverse:
        y = torch.flip(y, dims=(1,))
    return [y, h, c.to(dt)]


@register_lowering(OpType.LAYER_NORM)
def _layer_norm(attrs, inputs, params, ctx):
    """fp32 statistics (biased variance), the affine in fp32, the result
    cast back to x's dtype. Over trailing axes this is F.layer_norm on the
    fp32 input, which saves for backward only that input and the row
    statistics; other axes take the reference's formula."""
    (x,) = inputs
    axes = tuple(sorted(a % x.ndim for a in attrs.axes))
    xf = x.float()
    affine = attrs.elementwise_affine
    scale = params["scale"].float() if affine else None
    bias = params["bias"].float() if affine else None
    if axes == tuple(range(x.ndim - len(axes), x.ndim)):
        y = F.layer_norm(xf, xf.shape[x.ndim - len(axes):], scale, bias,
                         attrs.eps)
    else:
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + attrs.eps)
        if affine:
            y = y * scale + bias
    return [y.to(x.dtype)]


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


# ---------------------------------------------------------------------------
# top-k and the MoE ops: group_by / aggregate / fused experts
#
# The reference computes all of them in jnp, outside any Pallas kernel,
# so they are PyTorch ops here too: sorts, gathers and batched matmuls.


def topk_lower_first(x, k: int):
    """(values, int64 indices) of the k largest entries along the last
    dim, largest first and, among equal values, the lower index first, as
    lax.top_k orders them (torch.topk promises no order on ties): a
    stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_lowering(OpType.TOPK)
def _topk(attrs, inputs, params, ctx):
    (x,) = inputs
    vals, idx = topk_lower_first(x, attrs.k)
    return [vals, idx.to(torch.int32)]


def dispatch_mask(assign, n_experts: int, capacity: int):
    """assign (b, k) int expert ids -> the (b, k, n, capacity) fp32
    one-hot dispatch, (row, choice) pairs past their expert's capacity
    dropped. Each expert's queue fills in k-major order (choice 0 of
    every row, then choice 1, ...), rows in batch order within a choice."""
    b, k = assign.shape
    onehot = F.one_hot(assign.long(), n_experts).float()        # (b, k, n)
    flat = onehot.transpose(0, 1).reshape(b * k, n_experts)     # k-major
    pos = torch.cumsum(flat, dim=0) - flat
    pos = pos.reshape(k, b, n_experts).transpose(0, 1)          # (b, k, n)
    onehot = onehot * (pos < capacity)
    slot = F.one_hot(pos.long().clamp(max=capacity), capacity + 1)[
        ..., :capacity].float()
    return onehot[..., None] * slot


@register_lowering(OpType.GROUP_BY)
def _group_by(attrs, inputs, params, ctx):
    x, assign = inputs                                  # (b, d), (b, k)
    cap = attrs.capacity(x.shape[0], assign.shape[-1])
    disp = dispatch_mask(assign, attrs.n_experts, cap).sum(dim=1)
    outs = torch.einsum("bnc,bd->ncd", disp.to(x.dtype), x)
    return list(outs.unbind(0))


def _moe_combine_inputs(inputs, n_experts: int):
    """AGGREGATE's inputs: gate_preds (b, k), gate_assign (b, k), the
    stacked expert outputs (n, cap, d), and the dispatch mask."""
    gate_preds, gate_assign = inputs[0], inputs[1]
    experts = torch.stack(inputs[4:], dim=0)
    disp = dispatch_mask(gate_assign, n_experts, experts.shape[1])
    return gate_preds, experts, disp


@register_lowering(OpType.AGGREGATE)
def _aggregate(attrs, inputs, params, ctx):
    gate_preds, experts, disp = _moe_combine_inputs(inputs, attrs.n_experts)
    combine = (disp * gate_preds.float()[..., None, None]).sum(dim=1)
    y = torch.einsum("bnc,ncd->bd", combine.to(experts.dtype), experts)
    if attrs.lambda_bal > 0.0 and ctx.training:
        # the Switch-style load-balance term n * sum_e f_e * p_e, its
        # gradient reaching the gate through the full distribution
        full_gate = inputs[3].float()                           # (b, n)
        counts = disp.sum(dim=(0, 1, 3))          # rows kept per expert
        frac = counts / counts.sum().clamp_min(1.0)
        ctx.aux_loss = (attrs.n_experts * torch.sum(
            frac * full_gate.mean(dim=0)) * attrs.lambda_bal)
    return [y]


@register_lowering(OpType.AGGREGATE_SPEC)
def _aggregate_spec(attrs, inputs, params, ctx):
    gate_preds, experts, disp = _moe_combine_inputs(inputs, attrs.n_experts)
    b, k = gate_preds.shape
    per_slot = torch.einsum("bknc,ncd->bkd", disp.to(experts.dtype), experts)
    return [per_slot.reshape(b * k, -1)]


def sorted_dispatch(topi, n_experts: int, cap: int):
    """The token-sort dispatch plan of (t, k) expert ids `topi`.

    The flat slots f = choice * t + row (k-major, dispatch_mask's arrival
    order, so both dispatches drop the same pairs) are stably sorted by
    expert; a slot's rank within its expert is its sorted position less
    the expert's first position (searchsorted). Returns
      slot_of_flat (t * k,) int64: the buffer row e * cap + rank of each
        slot, or n * cap where its expert was full (dropped);
      kept (n,) int64: the rows each expert keeps.
    No (t, n, cap) tensor is made, and nothing is read back to the host."""
    t, k = topi.shape
    flat_e = topi.long().transpose(0, 1).reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    rank = (torch.arange(t * k, device=topi.device)
            - torch.searchsorted(sorted_e, sorted_e, side="left"))
    buf_slot = torch.where(rank < cap, sorted_e * cap + rank,
                           n_experts * cap)
    slot_of_flat = torch.empty_like(buf_slot).scatter_(0, order, buf_slot)
    ids = torch.arange(n_experts, device=topi.device)
    counts = (torch.searchsorted(sorted_e, ids, side="right")
              - torch.searchsorted(sorted_e, ids, side="left"))
    return slot_of_flat, counts.clamp(max=cap)


def expert_ffn(buf, w1, w2, act: ActiMode):
    """The expert bank on its (n, cap, d) rows: two batched matmuls over
    the stacked weights, in the rows' dtype."""
    h = apply_activation(torch.bmm(buf, w1.to(buf.dtype)), act)
    return torch.bmm(h, w2.to(buf.dtype))


@register_lowering(OpType.EXPERTS)
def _experts(attrs, inputs, params, ctx):
    """Fused MoE FFN: softmax of the gate in fp32, top-k (lower expert
    first on ties), optional renormalisation, capacity dispatch, the
    expert bank, the weighted k-sum; in training the Switch load-balance
    term n * sum_e f_e * p_e * lambda_bal goes to ctx.aux_loss. Every row of
    x is routed and counts toward capacity (in a serving step the
    window's pad rows too, as in the reference).

    dispatch "sort": sorted_dispatch's plan. Each buffer row gathers its
    token (an empty row gathers a zero row), so dropped slots move no
    data and take no gradient; the expert outputs gather back per slot
    from a zero-padded (n * cap + 1, out) table. "dense": the one-hot
    dispatch and combine einsums."""
    x, gate_logits = inputs
    n, k = attrs.n_experts, attrs.k
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1])
    t, d = xt.shape
    probs = torch.softmax(gate_logits.reshape(-1, n).float(), dim=-1)
    topv, topi = topk_lower_first(probs, k)                     # (t, k)
    if attrs.normalize:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    cap = attrs.capacity(t)
    if attrs.dispatch == "sort":
        slot_of_flat, kept = sorted_dispatch(topi, n, cap)
        token_of_flat = torch.arange(t, device=x.device).repeat(k)
        # which token fills each buffer row: kept slots own their rows
        # alone; the dropped ones all land on row n * cap, cut off
        src = torch.full((n * cap + 1,), t, dtype=torch.long,
                         device=x.device)
        src.scatter_(0, slot_of_flat, token_of_flat)
        xpad = torch.cat([xt, xt.new_zeros(1, d)])
        buf = xpad[src[:-1]].view(n, cap, d)
        o = expert_ffn(buf, params["w1"], params["w2"], attrs.activation)
        o_flat = torch.cat([o.reshape(n * cap, attrs.out_dim),
                            o.new_zeros(1, attrs.out_dim)])
        per_slot = o_flat[slot_of_flat]                  # (t * k, out)
        w = topv.transpose(0, 1).reshape(-1, 1).to(per_slot.dtype)
        y = (per_slot * w).view(k, t, attrs.out_dim).sum(dim=0)
        kept = kept.float()
        frac = kept / kept.sum().clamp_min(1.0)
    elif attrs.dispatch == "dense":
        disp = dispatch_mask(topi, n, cap)                  # (t, k, n, c)
        combine = disp * topv[..., None, None]
        disp_tok = disp.sum(dim=1)                             # (t, n, c)
        buf = torch.einsum("tnc,td->ncd", disp_tok.to(xt.dtype), xt)
        o = expert_ffn(buf, params["w1"], params["w2"], attrs.activation)
        y = torch.einsum("tknc,nco->to", combine.to(o.dtype), o)
        frac = disp_tok.sum(dim=(0, 2)) / disp_tok.sum().clamp_min(1.0)
    else:
        raise ValueError(f"ExpertsAttrs.dispatch must be one of "
                         f"('sort', 'dense'), got {attrs.dispatch!r}")
    if ctx.training:
        # only the train step reads it (the reference writes it always
        # and its other steps drop it)
        ctx.aux_loss = (n * torch.sum(frac * probs.mean(dim=0))
                        * attrs.lambda_bal)
    return [y.reshape(*lead, attrs.out_dim)]


# ---------------------------------------------------------------------------
# the activation cache and the pipeline composite (the reference's
# _cache, _decoder_block and _pipeline, jax_ops.py)


@register_lowering(OpType.CACHE)
def _cache(attrs, inputs, params, ctx):
    """A training step writes its input into the non-trainable "cached"
    buffer (state_updates, merged by the train step) and passes it on;
    outside training the node returns the buffer."""
    (x,) = inputs
    if ctx.training:
        ctx.state_updates["cached"] = x.detach().to(params["cached"].dtype)
        return [x]
    return [params["cached"]]


def _decoder_block(p, h, attrs, cache=None):
    """One Llama decoder block on one layer's params `p` (the unstacked
    builder's RMSNorm -> GQA attention with RoPE -> RMSNorm -> SwiGLU,
    residuals around both halves). Attention goes through
    fused_attention, the route of an unstacked MHA node (K1/K2 at head
    dims that are multiples of 128, K4 at the others). `cache` = (cache_k,
    cache_v, pos) switches it to the dense-cache step (cached_attention),
    which writes this step's rows into the caches in place; the return
    is then (h, cache_k, cache_v)."""
    dt = h.dtype

    def rms(x, scale):
        xf = x.float()
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + attrs.norm_eps)
                * scale.float()).to(dt)

    scale = 1.0 / ((h.shape[-1] // attrs.heads) ** 0.5)
    a = rms(h, p["ln1"])
    q = qkv_project(a, p["wq"], dt)
    k = qkv_project(a, p["wk"], dt)
    v = qkv_project(a, p["wv"], dt)
    kc = vc = None
    if cache is not None:
        cache_k, cache_v, pos = cache
        o, kc, vc = cached_attention(q, k, v, cache_k, cache_v, pos,
                                     scale=scale,
                                     rope_theta=attrs.rope_theta)
    else:
        q = apply_rope(q, attrs.rope_theta)
        k = apply_rope(k, attrs.rope_theta)
        o = fused_attention(q, k, v, causal=attrs.causal, scale=scale)
    h = h + attn_out_project(o, p["wo"], dt)
    m = rms(h, p["ln2"])
    g = torch.matmul(m, p["gate"].to(dt))
    u = torch.matmul(m, p["up"].to(dt))
    h = h + torch.matmul(F.silu(g) * u, p["down"].to(dt))
    return h if cache is None else (h, kc, vc)


@register_lowering(OpType.PIPELINE)
def _pipeline(attrs, inputs, params, ctx):
    """The stacked decoder blocks, layer i on params[name][i], in turn:
    the reference's path without a `pipe` mesh axis (a lax.scan over the
    stack); the GPipe schedule needs one and the port's mesh has none.
    With a dense KV cache each layer's slice of the (L, B, T, Hkv, D)
    "k"/"v" caches goes through the block's cached step, written in
    place. The paged pool has no PIPELINE path (Executor
    .paged_kv_cache_specs raises)."""
    (h,) = inputs
    # one unbind a leaf: its backward stacks the layers' gradients in one
    # write, where indexing each layer would build a stack-sized gradient
    # a layer and sum them
    layers = [dict(zip(params, ws))
              for ws in zip(*(w.unbind(0) for w in params.values()))]
    if ctx.kv_cache is not None:
        ck, cv = ctx.kv_cache["k"], ctx.kv_cache["v"]
        for p, k_i, v_i in zip(layers, ck.unbind(0), cv.unbind(0)):
            h, _, _ = _decoder_block(p, h, attrs,
                                    cache=(k_i, v_i, ctx.cache_position))
        ctx.cache_updates.update(k=ck, v=cv)
        return [h]
    for p in layers:
        h = _decoder_block(p, h, attrs)
    return [h]
