"""Ring attention: sequence-parallel attention over the mesh's `seq` axis
(counterpart of flexflow_tpu/parallel/ring.py).

q/k/v are cut into `n` sequence blocks, one per position of the `seq`
axis. Each shard attends its queries to the k/v block it holds while the
blocks rotate around the ring, with an online softmax (running max and
denominator in fp32), so the result equals full attention. On one device
every shard is held by the one process and the rotation passes block
references (ops/ring_flash.py `_ppermute`).

`ring_dot_product_attention` routes by the mesh alone: no seq axis ->
plain (flash) attention; otherwise the ring of kernel K5
(`ring_flash_attention`), whatever the local sequence's length. The
reference sends a local sequence that is not a multiple of its 128 lanes
to an einsum online-softmax ring instead (its `_pick_block` gate); that
gate is TPU tiling, not a contract, and K5 and K4 take any length, so the
port keeps one rule for both attention routes: no length gate (plain
attention sends every length to K1/K4 too). The tests hold the K5 ring at
such lengths to the reference's einsum ring. The reference's
`FF_TPU_NO_FLASH` and `FF_TPU_FLASH_INTERPRET` switches are not carried
over. The lowering of OpType.RING_ATTENTION is `ring_attention_lowering`.
"""

from __future__ import annotations

from flexflow_tpu_torch.ops.ring_flash import ring_flash_attention
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


def ring_dot_product_attention(q, k, v, *, mesh, causal: bool,
                               scale: float):
    """q (B, S, H, D), k, v (B, S, Hkv, D) over the whole sequence, S cut
    over the mesh's `seq` axis. Exact attention by the K5 ring at any
    local length; plain attention (the flash kernels) when that axis has
    size 1."""
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
    return ring_flash_attention(q, k, v, n_shards=n, causal=causal,
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
