"""Ring attention: sequence-parallel attention over the mesh's `seq` axis
(counterpart of flexflow_tpu/parallel/ring.py).

q/k/v are cut into `n` sequence blocks, one per position of the `seq`
axis. Each shard attends its queries to the k/v block it holds while the
blocks rotate around the ring, with an online softmax (running max and
denominator in fp32), so the result equals full attention. On one device
every shard is held by the one process and the rotation passes block
references (ops/ring_flash.py `_ppermute`).

`ring_dot_product_attention` routes as the reference does on its TPU:
no seq axis -> plain (flash) attention; a local sequence that the
reference's flash ring tiles (a multiple of 128) -> the ring of kernel K5
(`ring_flash_attention`); otherwise -> `ring_attention_core`, the einsum
online-softmax ring in plain torch. The reference's `FF_TPU_NO_FLASH` and
`FF_TPU_FLASH_INTERPRET` switches are not carried over. The lowering of
OpType.RING_ATTENTION is `ring_attention_lowering`.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ops.flash_attention import LANES, NEG_INF
from flexflow_tpu_torch.ops.ring_flash import _ppermute, ring_flash_attention
from flexflow_tpu_torch.ops.torch_ops import (
    apply_rope,
    attn_out_project,
    fused_attention,
    qkv_project,
)
from flexflow_tpu_torch.parallel.comm_spec import ring_repeats_kv
from flexflow_tpu_torch.parallel.mesh import mesh_axis_size


def repeat_kv(k, v, rep: int):
    """Materialize the GQA head repeat (jnp.repeat's order: kv head g
    serves q heads g * rep .. g * rep + rep - 1)."""
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def ring_attention_core(q, k, v, *, n_shards: int, causal: bool,
                        scale: float):
    """The reference's einsum ring (parallel/ring.py:42) over all shards
    at once: q (B, S, H, D), k, v (B, S, Hkv, D) cut into n_shards blocks
    of S / n_shards rows; GQA kv rides the ring unrepeated and is
    repeated per block. fp32 logits and probabilities (not rounded
    before the value product), out in q's dtype."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    s_loc = S // n_shards
    qf = q.float().split(s_loc, dim=1)
    k_blk, v_blk = list(k.split(s_loc, dim=1)), list(v.split(s_loc, dim=1))
    f32 = dict(dtype=torch.float32, device=q.device)
    ms = [torch.full((B, H, s_loc), NEG_INF, **f32)] * n_shards
    ls = [torch.zeros(B, H, s_loc, **f32)] * n_shards
    accs = [torch.zeros(B, s_loc, H, D, **f32)] * n_shards
    iota = torch.arange(s_loc, device=q.device)
    for i in range(n_shards):
        for my in range(n_shards):
            src = (my - i) % n_shards  # which sequence block my holds
            kb, vb = repeat_kv(k_blk[my], v_blk[my], rep)
            logits = torch.einsum("bshd,bthd->bhst", qf[my],
                                  kb.float()) * scale
            pmask = 1.0
            if causal:
                mask = (my * s_loc + iota[:, None]) >= (src * s_loc
                                                        + iota[None, :])
                logits = torch.where(mask, logits, NEG_INF)
                pmask = mask.float()
            m, l, acc = ms[my], ls[my], accs[my]
            new_m = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - new_m)
            p = torch.exp(logits - new_m[..., None]) * pmask
            ls[my] = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhst,bthd->bshd", p, vb.float())
            accs[my] = acc * corr.transpose(1, 2)[..., None] + pv
            ms[my] = new_m
        k_blk, v_blk = _ppermute(k_blk), _ppermute(v_blk)
    out = [acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
           for acc, l in zip(accs, ls)]
    return torch.cat(out, dim=1).to(q.dtype)


def reference_ring_tiles(s_loc: int) -> bool:
    """Whether the reference's ring takes its flash body for a local
    sequence of s_loc rows: its `_pick_block(s_loc, 512)` is defined
    (flexflow_tpu/ops/pallas/flash_attention.py:565), which is when s_loc
    is a multiple of its 128 lanes. The port's kernels take any length;
    only the route, and so the numerics, depend on it."""
    return s_loc % LANES == 0


def ring_dot_product_attention(q, k, v, *, mesh, causal: bool,
                               scale: float):
    """q (B, S, H, D), k, v (B, S, Hkv, D) over the whole sequence, S cut
    over the mesh's `seq` axis. Exact attention by ring rotation; plain
    attention (the flash kernels) when that axis has size 1."""
    n = mesh_axis_size(mesh, "seq")
    if n == 1:
        return fused_attention(q, k, v, causal=causal, scale=scale)
    S, H, Hkv = q.shape[1], q.shape[2], k.shape[2]
    if S % n != 0:
        raise ValueError(f"sequence {S} does not split over the {n} "
                         "positions of mesh axis 'seq'")
    # the head degree is 1 on one device, so GQA kv stays unrepeated
    if ring_repeats_kv(H, Hkv, mesh_axis_size(mesh, "model")):
        k, v = repeat_kv(k, v, H // Hkv)
    if reference_ring_tiles(S // n):
        return ring_flash_attention(q, k, v, n_shards=n, causal=causal,
                                    scale=scale)
    return ring_attention_core(q, k, v, n_shards=n, causal=causal,
                               scale=scale)


def ring_attention_lowering(attrs, inputs, params, ctx):
    """Lowering of OpType.RING_ATTENTION without a KV cache: the same
    projections as MULTIHEAD_ATTENTION (no biases), RoPE at the global
    positions before the sequence is cut, the ring, the output
    projection."""
    q_in = inputs[0]
    k_in = inputs[1] if len(inputs) > 1 else q_in
    v_in = inputs[2] if len(inputs) > 2 else k_in
    dt = q_in.dtype
    q = qkv_project(q_in, params["wq"], dt)
    k = qkv_project(k_in, params["wk"], dt)
    v = qkv_project(v_in, params["wv"], dt)
    if attrs.rope:
        q = apply_rope(q, attrs.rope_theta)
        k = apply_rope(k, attrs.rope_theta)
    out = ring_dot_product_attention(q, k, v, mesh=ctx.mesh,
                                     causal=attrs.causal,
                                     scale=1.0 / (attrs.kdim ** 0.5))
    return [attn_out_project(out, params["wo"], dt)]
