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
with `lax.ppermute`. Here one process holds every shard on its device and
the rotation moves block references: `_ppermute` is the one place where a
process group's send/recv goes when shards live on several cards
(ROADMAP.md, queue 1 item 12). The reference's zero-pad of D to 128 lanes
is TPU tiling and is dropped, as for K4.
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


def _ppermute(blocks: List) -> List:
    """One hop of the ring: shard j's block moves to shard j + 1 (mod n),
    the reference's perm [(j, (j + 1) % n)]."""
    return blocks[-1:] + blocks[:-1]


def _step_modes(n_shards: int, causal: bool):
    """(step, shard, src, mode) of every visible block, in ring order."""
    for i in range(n_shards):
        for my in range(n_shards):
            src = (my - i) % n_shards
            mode = _modes(src, my) if causal else FULL
            if mode != SKIP:
                yield i, my, mode


def _ring_fwd_impl(q, k, v, n_shards: int, causal: bool, scale: float,
                   rep: int):
    """q: (n, B * H, s, D); k, v: (n, B * Hkv, s, D), the shards stacked
    on dim 0; GQA kv rides the ring unrepeated. Returns out (n, B * H, s,
    D) in q's dtype and the fp32 lse (n, B * H, s)."""
    n, BH, s, D = q.shape
    ms = [torch.full((BH, s), NEG_INF, dtype=torch.float32,
                     device=q.device) for _ in range(n)]
    ls = [torch.zeros(BH, s, dtype=torch.float32, device=q.device)
          for _ in range(n)]
    accs = [torch.zeros(BH, s, D, dtype=torch.float32, device=q.device)
            for _ in range(n)]
    k_blk, v_blk = list(k.unbind(0)), list(v.unbind(0))
    step = 0
    for i, my, mode in _step_modes(n, causal):
        while step < i:  # the ring turns once per step
            k_blk, v_blk = _ppermute(k_blk), _ppermute(v_blk)
            step += 1
        ms[my], ls[my], accs[my] = flash_bh_fwd_carry(
            q[my], _rep_heads(k_blk[my], rep), _rep_heads(v_blk[my], rep),
            ms[my], ls[my], accs[my], mode == CAUSAL, scale)
    l_safe = torch.stack(ls).clamp_min(1e-30)
    out = (torch.stack(accs) / l_safe[..., None]).to(q.dtype)
    return out, torch.stack(ms) + torch.log(l_safe)


def _ring_bwd(q, k, v, out, lse, dout, n_shards: int, causal: bool,
              scale: float, rep: int):
    """The second ring pass: (dq, dk, dv) at q's, k's and v's shapes and
    dtypes."""
    n, BH, s, D = q.shape
    delta = flash_bh_delta(dout.reshape(n * BH, s, D),
                           out.reshape(n * BH, s, D)).reshape(n, BH, s)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = [torch.zeros(BH, s, D, **f32) for _ in range(n)]
    dk_acc = [torch.zeros(k.shape[1:], **f32) for _ in range(n)]
    dv_acc = [torch.zeros(v.shape[1:], **f32) for _ in range(n)]
    k_blk, v_blk = list(k.unbind(0)), list(v.unbind(0))
    step = 0
    for i, my, mode in _step_modes(n, causal):
        while step < i:
            # dk/dv accumulators travel with their k/v blocks
            k_blk, v_blk = _ppermute(k_blk), _ppermute(v_blk)
            dk_acc, dv_acc = _ppermute(dk_acc), _ppermute(dv_acc)
            step += 1
        args = (q[my], _rep_heads(k_blk[my], rep),
                _rep_heads(v_blk[my], rep), dout[my], lse[my], delta[my],
                mode == CAUSAL, scale)
        dq[my] += flash_bh_dq(*args).float()
        dk_r, dv_r = flash_bh_dkv(*args)
        dk_acc[my] += _sum_heads(dk_r, rep).float()
        dv_acc[my] += _sum_heads(dv_r, rep).float()
    # after n hops in all, every accumulator is back on its block's owner
    for _ in range(n - step):
        dk_acc, dv_acc = _ppermute(dk_acc), _ppermute(dv_acc)
    return (torch.stack(dq).to(q.dtype), torch.stack(dk_acc).to(k.dtype),
            torch.stack(dv_acc).to(v.dtype))


class RingFlashFunction(torch.autograd.Function):
    """The reference's `ring_flash` custom VJP: forward `_ring_fwd_impl`,
    backward `_ring_bwd`. Saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, n_shards: int, causal: bool, scale: float,
                rep: int):
        out, lse = _ring_fwd_impl(q, k, v, n_shards, causal, scale, rep)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (n_shards, causal, scale, rep)
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
    == 0): each shard's blocks go head-major, (B * h, S / n, D) (the
    reference's `to_bh`), the ring runs, and the output comes back as
    (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    s_loc = S // n_shards

    def to_bh(x):
        h = x.shape[2]
        return x.reshape(B, n_shards, s_loc, h, D).permute(1, 0, 3, 2, 4) \
            .reshape(n_shards, B * h, s_loc, D)

    out = RingFlashFunction.apply(to_bh(q), to_bh(k), to_bh(v), n_shards,
                                  bool(causal), float(scale), H // Hkv)
    return out.reshape(n_shards, B, H, s_loc, D).permute(1, 0, 3, 2, 4) \
        .reshape(B, S, H, D)
