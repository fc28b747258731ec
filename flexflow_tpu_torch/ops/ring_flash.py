"""Ring attention with kernel K5 as the per-block body (counterpart of
flexflow_tpu/ops/pallas/ring_flash.py).

The sequence is cut into `n_shards` blocks, shard `my` holding queries,
keys and values of block `my`. At ring step i shard `my` holds the k/v
block of shard `src = (my - i) mod n` and folds it into its carried fp32
(m, l, acc) with K5 (`flash_bh_fwd_carry`); then the k/v blocks rotate by
one (`_ppermute`). Causality per step is fixed by the block positions:

  src <  my : full block (K5, causal=False)
  src == my : causal block (K5, causal=True, the top-left diagonal)
  src >  my : wholly masked, skipped (no launch)

Without `causal` every step is full. Finally out = acc / max(l, 1e-30) in
q's dtype and lse = m + log(max(l, 1e-30)).

The backward is a second ring pass: with the FINAL lse and delta =
sum_d dO * O (computed once), each block's dq and dk/dv contributions are
independent, so K4's dq and dk/dv kernels run per visible block, on kv
heads repeated to the q heads (`_rep_heads`) and summed back per GQA
group (`_sum_heads`). The per-step results come out in the op dtype and
are added into fp32 accumulators; the dk/dv accumulators rotate with
their blocks and are home after n steps.

The reference runs one shard per device inside shard_map and rotates
with `lax.ppermute`. The port runs one ring body (`_ring_fwd`,
`_ring_bwd`, one custom autograd Function, so no autograd runs through a
hop) over the shards held where it runs, with that place's hop:

  - `ring_flash_attention`: one process holds every shard on its device
    (the one card's `{"seq": n}`) and the hop moves block references
    (`_ppermute`);
  - `ring_flash_attention_ranks`: `seq` spans processes, each rank holds
    its own block, and the hop is the process mesh's
    (spmd.ProcessMesh.ring_shift: a send to rank j + 1 and a receive
    from j - 1). Each rank launches K5 (and in the backward K4's dq and
    dk/dv) only for its own query block's visible blocks, `my + 1`
    under causality, and takes part in every hop, the steps whose block
    it skips included: a rank that skipped a hop would stall the ring.
    Only k/v blocks and, in the backward, the dk/dv accumulators travel.

The reference's zero-pad of D to 128 lanes is TPU tiling and is dropped,
as for K4.
"""

from __future__ import annotations

from typing import List

import torch

from flexflow_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_bh_delta,
    flash_bh_dkv,
    flash_bh_dq,
    flash_bh_fwd_carry,
)

FULL, CAUSAL, SKIP = 0, 1, 2


def _modes(src: int, my: int) -> int:
    """The step's mode: FULL, CAUSAL or SKIP (the reference's static
    branch index)."""
    if src == my:
        return CAUSAL
    return FULL if src < my else SKIP


def _rep_heads(x, rep: int):
    """(B * Hkv, s, D) -> (B * H, s, D): each kv head repeated `rep` times
    in the head-major b * H + h order."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=0)


def _sum_heads(g, rep: int):
    """(B * H, s, D) -> (B * Hkv, s, D): the sum of the `rep` q-head
    gradients that share each kv head (the backward of _rep_heads), in
    g's dtype."""
    if rep == 1:
        return g
    BH, s, D = g.shape
    return g.reshape(BH // rep, rep, s, D).sum(dim=1)


def _ppermute(blocks: List[List]) -> List[List]:
    """One hop of the one-process ring, over each list of per-shard
    blocks: shard j's block moves to shard j + 1 (mod n), the reference's
    perm [(j, (j + 1) % n)]."""
    return [b[-1:] + b[:-1] for b in blocks]


def _rank_hop(pm):
    """One hop of the ring between ranks, for lists that hold this rank's
    one block each (spmd.ProcessMesh.ring_shift over `seq`)."""
    def hop(blocks: List[List]) -> List[List]:
        return [[t] for t in pm.ring_shift([b[0] for b in blocks], "seq")]
    return hop


def _ring_fwd(q, k, v, ring, causal: bool, scale: float, rep: int):
    """The ring pass over the shards a ring holds. `ring` is (n, shards,
    hop): the ring's size, the positions of the shards held here (every
    one in one process, a rank's own one between ranks) and one hop of
    per-shard block lists. q: (len(shards), B * H, s, D); k, v:
    (len(shards), B * Hkv, s, D); GQA kv rides the ring unrepeated.
    Returns out in q's dtype and the fp32 lse (len(shards), B * H, s)."""
    n, shards, hop = ring
    _, BH, s, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    ms = [torch.full((BH, s), NEG_INF, **f32) for _ in shards]
    ls = [torch.zeros(BH, s, **f32) for _ in shards]
    accs = [torch.zeros(BH, s, D, **f32) for _ in shards]
    k_blk, v_blk = list(k.unbind(0)), list(v.unbind(0))
    for i in range(n):
        for j, my in enumerate(shards):
            mode = _modes((my - i) % n, my) if causal else FULL
            if mode != SKIP:
                ms[j], ls[j], accs[j] = flash_bh_fwd_carry(
                    q[j], _rep_heads(k_blk[j], rep),
                    _rep_heads(v_blk[j], rep), ms[j], ls[j], accs[j],
                    mode == CAUSAL, scale)
        if i < n - 1:  # every shard hops, whether it folded or not
            k_blk, v_blk = hop([k_blk, v_blk])
    l_safe = torch.stack(ls).clamp_min(1e-30)
    out = (torch.stack(accs) / l_safe[..., None]).to(q.dtype)
    return out, torch.stack(ms) + torch.log(l_safe)


def _ring_bwd(q, k, v, out, lse, dout, ring, causal: bool, scale: float,
              rep: int):
    """The second ring pass: (dq, dk, dv) at q's, k's and v's shapes and
    dtypes. The dk/dv fp32 accumulators travel with their k/v blocks;
    after the last step one more hop of the accumulators alone brings
    each home (n hops in all)."""
    n, shards, hop = ring
    m, BH, s, D = q.shape
    delta = flash_bh_delta(dout.reshape(m * BH, s, D),
                           out.reshape(m * BH, s, D)).reshape(m, BH, s)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = [torch.zeros(BH, s, D, **f32) for _ in shards]
    dk_acc = [torch.zeros(k.shape[1:], **f32) for _ in shards]
    dv_acc = [torch.zeros(v.shape[1:], **f32) for _ in shards]
    k_blk, v_blk = list(k.unbind(0)), list(v.unbind(0))
    for i in range(n):
        for j, my in enumerate(shards):
            mode = _modes((my - i) % n, my) if causal else FULL
            if mode != SKIP:
                args = (q[j], _rep_heads(k_blk[j], rep),
                        _rep_heads(v_blk[j], rep), dout[j], lse[j],
                        delta[j], mode == CAUSAL, scale)
                dq[j] += flash_bh_dq(*args).float()
                dk_r, dv_r = flash_bh_dkv(*args)
                dk_acc[j] += _sum_heads(dk_r, rep).float()
                dv_acc[j] += _sum_heads(dv_r, rep).float()
        if i < n - 1:
            k_blk, v_blk, dk_acc, dv_acc = hop([k_blk, v_blk, dk_acc,
                                                dv_acc])
    dk_acc, dv_acc = hop([dk_acc, dv_acc])
    return (torch.stack(dq).to(q.dtype), torch.stack(dk_acc).to(k.dtype),
            torch.stack(dv_acc).to(v.dtype))


class RingFlashFunction(torch.autograd.Function):
    """The reference's `ring_flash` custom VJP on the shards a ring holds:
    forward `_ring_fwd`, backward `_ring_bwd`. Saves (q, k, v, out,
    lse)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal: bool, scale: float, rep: int):
        out, lse = _ring_fwd(q, k, v, ring, causal, scale, rep)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (ring, causal, scale, rep)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, dout.contiguous(),
                               *ctx.args)
        return dq, dk, dv, None, None, None, None


def ring_flash_attention(q, k, v, *, n_shards: int, causal: bool,
                         scale: float):
    """Ring attention over the whole sequence of q (B, S, H, D) and k, v
    (B, S, Hkv, D), H % Hkv == 0, cut into n_shards blocks (S % n_shards
    == 0), every shard held by this process: each shard's blocks go
    head-major, (B * h, S / n, D) (the reference's `to_bh`), the ring
    runs, and the output comes back as (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    s_loc = S // n_shards

    def to_bh(x):
        h = x.shape[2]
        return x.reshape(B, n_shards, s_loc, h, D).permute(1, 0, 3, 2, 4) \
            .reshape(n_shards, B * h, s_loc, D)

    ring = (n_shards, tuple(range(n_shards)), _ppermute)
    out = RingFlashFunction.apply(to_bh(q), to_bh(k), to_bh(v), ring,
                                  bool(causal), float(scale), H // Hkv)
    return out.reshape(n_shards, B, H, s_loc, D).permute(1, 0, 3, 2, 4) \
        .reshape(B, S, H, D)


def ring_flash_attention_ranks(q, k, v, *, pm, causal: bool, scale: float):
    """Ring attention when `seq` spans processes: q (B, s, H, D) and k, v
    (B, s, Hkv, D), H % Hkv == 0, this rank's block of the sequence
    (position pm.coords["seq"] of the `seq` axis); the blocks go head-
    major, (B * h, s, D), the ring runs over the ranks, and this rank's
    output comes back as (B, s, H, D) in q's dtype."""
    B, s, H, D = q.shape

    def to_bh(x):
        return x.permute(0, 2, 1, 3).reshape(1, B * x.shape[2], s, D) \
            .contiguous()

    ring = (pm.sizes["seq"], (pm.coords["seq"],), _rank_hop(pm))
    out = RingFlashFunction.apply(to_bh(q), to_bh(k), to_bh(v), ring,
                                  bool(causal), float(scale),
                                  H // k.shape[2])
    return out.reshape(B, H, s, D).permute(0, 2, 1, 3)
