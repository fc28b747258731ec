"""Ring attention: sequence-parallel attention over the mesh's `seq` axis
(counterpart of flexflow_tpu/parallel/ring.py).

q/k/v are cut into `n` sequence blocks, one per position of the `seq`
axis. Each shard attends its queries to the k/v block it holds while the
blocks rotate around the ring, with an online softmax (running max and
denominator in fp32), so the result equals full attention. On one device
every shard is held by the one process and the rotation passes block
references (ops/ring_flash.py `_ppermute`). When `seq` spans processes
(the lowering's ctx.pmesh has it: parallel/mesh.process_axes) each rank
holds its own block, and the blocks rotate between the ranks
(`ring_flash_attention_ranks`).

`ulysses_dot_product_attention` is the other exchange (seq_mode=
"ulysses"): an all-to-all trades the sequence cut for a head cut, each
shard attends over the whole sequence for its heads, and a second
all-to-all trades back. Across processes these are the process mesh's
all-to-alls over `seq` (the reference's lax.all_to_all(..., tiled=True)
pair), around the rank's flash attention (K1/K2 at head dims that are
multiples of 128, K4 otherwise). When one process holds every shard, as
on the one card, the two exchanges cancel and what is left is full
attention through the same flash route. `comm_spec.ulysses_plan`'s
fallback takes the K5 ring.

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

from flexflow_tpu_torch.ops.ring_flash import (
    ring_flash_attention,
    ring_flash_attention_ranks,
)
from flexflow_tpu_torch.ops.torch_ops import (
    apply_rope,
    attn_out_project,
    fused_attention,
    qkv_project,
)
from flexflow_tpu_torch.parallel import spmd
from flexflow_tpu_torch.parallel.comm_spec import (
    ring_repeats_kv,
    ulysses_plan,
)
from flexflow_tpu_torch.parallel.mesh import mesh_axis_size


def seq_ranks(pm) -> bool:
    """True when `seq` spans processes on the process mesh `pm`."""
    return pm is not None and bool(pm.live(("seq",)))


def repeat_kv(k, v, rep: int):
    """Materialize the GQA head repeat (jnp.repeat's order: kv head g
    serves q heads g * rep .. g * rep + rep - 1)."""
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def ring_dot_product_attention(q, k, v, *, mesh, causal: bool,
                               scale: float, pm=None):
    """q (B, S, H, D), k, v (B, S, Hkv, D) over the whole sequence, S cut
    over the mesh's `seq` axis. Exact attention by the K5 ring at any
    local length; plain attention (the flash kernels) when that axis has
    size 1. When `seq` spans the processes of `pm`, q, k and v are this
    rank's pieces (its sequence block, its `model` heads) and the ring
    runs between the ranks."""
    if seq_ranks(pm):
        return ring_flash_attention_ranks(q, k, v, pm=pm, causal=causal,
                                          scale=scale)
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


def _ulysses_ranks(q, k, v, pm, causal: bool, scale: float):
    """Ulysses between ranks (the reference's shard_map body): each of
    q, k, v (B, s, h, D) goes through an all-to-all over `seq` that
    splits its heads and gathers the sequence, (B, S, h / n, D); the
    rank's flash attention runs over the whole sequence; an all-to-all
    back splits the sequence and gathers the heads. The all-to-alls are
    autograd Functions, whose backward is the inverse exchange."""
    ex = [spmd.all_to_all(t, pm, 1, 2, ("seq",)) for t in (q, k, v)]
    out = fused_attention(*ex, causal=causal, scale=scale)
    return spmd.all_to_all(out, pm, 2, 1, ("seq",))


def ulysses_dot_product_attention(q, k, v, *, mesh, causal: bool,
                                  scale: float, pm=None):
    """DeepSpeed-Ulysses over the mesh's `seq` axis (the reference's
    parallel/ring.py:168). The reference's first all-to-all gives each
    shard every position of H/n heads and its second one gives the
    sequence cut back; on one process, which holds all n shards, the two
    exchanges are inverse permutations of the same tensor and cancel, so
    the shards' attentions together are full attention over the whole
    sequence. The plan's decisions (parallel/comm_spec.py) are the
    reference's: local heads that do not split n ways fall back to the
    ring, and GQA kv is repeated when its heads do not split. When `seq`
    spans the processes of `pm`, q, k and v are this rank's pieces (as
    for ring_dot_product_attention) and the exchanges run between the
    ranks (`_ulysses_ranks`)."""
    n = mesh_axis_size(mesh, "seq")
    if n == 1:
        return fused_attention(q, k, v, causal=causal, scale=scale)
    ranks = seq_ranks(pm)
    m = pm.degree(pm.live(("model",))) if ranks else 1
    H = q.shape[2] * m
    Hkv = k.shape[2] * m
    plan = ulysses_plan(H, Hkv, mesh_axis_size(mesh, "model"), n)
    if plan.fallback_to_ring:
        return ring_dot_product_attention(q, k, v, mesh=mesh, causal=causal,
                                          scale=scale, pm=pm)
    if plan.repeat_kv:
        k, v = repeat_kv(k, v, q.shape[2] // k.shape[2])
    if ranks:
        return _ulysses_ranks(q, k, v, pm, causal, scale)
    return fused_attention(q, k, v, causal=causal, scale=scale)


def ring_attention_lowering(attrs, inputs, params, ctx):
    """Lowering of OpType.RING_ATTENTION without a KV cache: the same
    projections as MULTIHEAD_ATTENTION (no biases), RoPE at the global
    positions before the sequence is cut, the exchange `seq_mode` names
    (the ring or Ulysses), the output projection. When `seq` spans
    processes (ctx.pmesh) the inputs are this rank's sequence block,
    which starts at global position seq index * s, and RoPE takes that
    offset."""
    q_in = inputs[0]
    k_in = inputs[1] if len(inputs) > 1 else q_in
    v_in = inputs[2] if len(inputs) > 2 else k_in
    dt = q_in.dtype
    q = qkv_project(q_in, params["wq"], dt)
    k = qkv_project(k_in, params["wk"], dt)
    v = qkv_project(v_in, params["wv"], dt)
    pm = ctx.pmesh if seq_ranks(ctx.pmesh) else None
    if attrs.rope:
        off = pm.coords["seq"] * q.shape[1] if pm is not None else 0
        q = apply_rope(q, attrs.rope_theta, pos_offset=off)
        k = apply_rope(k, attrs.rope_theta, pos_offset=off)
    seq_attn = (ulysses_dot_product_attention
                if attrs.seq_mode == "ulysses"
                else ring_dot_product_attention)
    out = seq_attn(q, k, v, mesh=ctx.mesh, causal=attrs.causal,
                   scale=1.0 / (attrs.kdim ** 0.5), pm=pm)
    return [attn_out_project(out, params["wo"], dt)]
