"""Ragged paged attention: ONE attention call for decode rows and chunked
prefill pieces (counterpart of flexflow_tpu/paged/attention.py).

Every unit of paged work is S query rows per batch entry whose K/V rows
land at cache rows pos..pos+S-1 through a page table, attending over the
committed prefix plus some subset of the in-flight window. The per-entry
descriptor:

  * ``pos``    (B,)     absolute committed position (the write head);
  * ``q_lens`` (B,)     how many of the S query rows are real work
                        (decode 1, a chunk piece its token count, 0 for a
                        padded batch entry);
  * ``depths`` (B, S)   rope offset of row i relative to pos;
  * ``anc``    (B, S, S) visibility INSIDE the window (chunks: lower
                        triangular; decode: ones((1, 1))).

`ragged_flash_attention` is the kernel wrapper: on CUDA tensors it
launches the hand-written Hopper kernel (csrc/ragged_paged_attention.cu)
or raises; on CPU tensors it runs the plain PyTorch version of the same
contract, `ragged_gather_attention`. There is no other path and no switch.
"""

from __future__ import annotations

from typing import Optional

import torch

from flexflow_tpu_torch.kernels import (
    KERNEL_DTYPES,
    launch_ragged_paged_attention,
)
from flexflow_tpu_torch.ops.torch_ops import apply_rope, dot_product_attention


def ragged_visibility_mask(page_tables, pos, q_lens, anc_mask,
                           page_size: int):
    """(B, S, L) bool visibility, L = max_pages x P: cache row kpos is
    visible to window row t of entry b when it is committed
    (kpos < pos[b]) or lies in the entry's in-flight window
    (rel = kpos - pos[b] in [0, q_lens[b])) on t's visibility path
    (anc_mask[b, t, rel])."""
    B, S, _ = anc_mask.shape
    L = page_tables.shape[1] * page_size
    kpos = torch.arange(L, device=anc_mask.device)
    rel = (kpos[None, None, :] - pos[:, None, None].long()).expand(B, S, L)
    in_window = (rel >= 0) & (rel < q_lens[:, None, None].long())
    anc = torch.gather(anc_mask, 2, rel.clamp(0, S - 1))
    return (kpos[None, None, :] < pos[:, None, None]) | (in_window & anc)


def ragged_gather_attention(q, kc_pages, vc_pages, page_tables, pos,
                            q_lens, anc_mask, *, scale: float):
    """The plain PyTorch version of the kernel's contract: gather every
    table-mapped page (`pool[page_table]`) and run dense masked attention
    under ragged_visibility_mask. q: (B, S, H, D); kc/vc_pages:
    (N, P, Hkv, D); page_tables: (B, max_pages) int32; pos/q_lens: (B,)
    int32; anc_mask: (B, S, S) bool. Rows at or past q_lens[b] are zeroed,
    as the kernel writes them."""
    B, S, _, D = q.shape
    P, Hkv = kc_pages.shape[1], kc_pages.shape[2]
    pt = page_tables.long()
    kg = kc_pages[pt].reshape(B, -1, Hkv, D).to(q.dtype)
    vg = vc_pages[pt].reshape(B, -1, Hkv, D).to(q.dtype)
    mask = ragged_visibility_mask(page_tables, pos, q_lens, anc_mask, P)
    out = dot_product_attention(q, kg, vg, scale, mask)
    live = (torch.arange(S, device=q.device)[None, :]
            < q_lens[:, None].long())
    return out * live[:, :, None, None].to(out.dtype)


def _check_kernel_args(q, kc, vc, page_tables, pos, q_lens, anc):
    B, S, H, D = q.shape
    if kc.ndim != 4 or kc.shape != vc.shape:
        raise ValueError(f"pools must share one (N, P, Hkv, D) shape, got "
                         f"{tuple(kc.shape)} and {tuple(vc.shape)}")
    N, P, Hkv, Dk = kc.shape
    if Dk != D or H % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(kc.shape)} (head dim, GQA grouping)")
    if q.dtype not in KERNEL_DTYPES or kc.dtype != q.dtype \
            or vc.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q and pools of "
                         f"the same dtype, got {q.dtype}, {kc.dtype}, "
                         f"{vc.dtype}")
    shapes = {"page_tables": (page_tables, (B, page_tables.shape[-1]),
                              torch.int32),
              "pos": (pos, (B,), torch.int32),
              "q_lens": (q_lens, (B,), torch.int32),
              "anc": (anc, (B, S, S), torch.bool)}
    for name, (t, shape, dt) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("kc", kc), ("vc", vc),
                    ("page_tables", page_tables), ("pos", pos),
                    ("q_lens", q_lens), ("anc", anc)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ragged_flash_attention(q, kc_pages, vc_pages, page_tables, pos, q_lens,
                           anc_mask, *, scale: float):
    """The kernel wrapper: (B, S, H, D) attention output under the ragged
    descriptor, rows at or past q_lens[b] exact zeros. CUDA tensors launch
    the hand-written kernel (and raise on anything it does not take);
    CPU tensors take the plain version. Mixed devices raise."""
    tensors = (q, kc_pages, vc_pages, page_tables, pos, q_lens, anc_mask)
    if all(t.device.type == "cpu" for t in tensors):
        return ragged_gather_attention(q, kc_pages, vc_pages, page_tables,
                                       pos, q_lens, anc_mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged attention runs on CUDA or CPU tensors, "
                         f"got q on {q.device}")
    _check_kernel_args(q, kc_pages, vc_pages, page_tables, pos, q_lens,
                       anc_mask)
    out = torch.empty_like(q)
    return launch_ragged_paged_attention(q, kc_pages, vc_pages, page_tables,
                                         pos, q_lens, anc_mask, out, scale)


def ragged_paged_attention(q, k, v, cache_k, cache_v, page_tables, pos,
                           q_lens, depths, anc_mask, *, scale: float,
                           rope_theta: Optional[float] = None):
    """The single paged-attention step every paged call lowers to: rope
    q/k at pos + depths, write the live K/V rows into their table-mapped
    pages, then attend through ragged_flash_attention.

    The pools are written IN PLACE (index_put_), and the write comes
    before the attention in every layer: that ordering is what lets a
    packed prefill piece see the rows an earlier piece of the same prompt
    wrote in this very step, as committed rows (kpos < pos). Rows past
    q_len or past the table land in the null page 0 with the other
    garbage, never in a real row. Returns (output, cache_k, cache_v) —
    the same pool tensors, updated."""
    B, S = q.shape[0], q.shape[1]
    P = cache_k.shape[1]
    dev = q.device
    if rope_theta is not None:
        positions = pos[:, None] + depths                      # (B, S)
        q = apply_rope(q, rope_theta, pos_offset=positions)
        k = apply_rope(k, rope_theta, pos_offset=positions)
    L = page_tables.shape[1] * P
    ar = torch.arange(S, device=dev)
    rows = pos[:, None].long() + ar[None, :]                   # (B, S)
    safe = rows.clamp(max=L - 1)
    page = torch.gather(page_tables.long(), 1, safe // P)
    live = (rows < L) & (ar[None, :] < q_lens[:, None].long())
    page = torch.where(live, page, torch.zeros_like(page))
    off = safe % P
    cache_k.index_put_((page, off), k.to(cache_k.dtype))
    cache_v.index_put_((page, off), v.to(cache_v.dtype))
    out = ragged_flash_attention(q, cache_k, cache_v, page_tables, pos,
                                 q_lens, anc_mask, scale=scale)
    return out, cache_k, cache_v


def chain_descriptor(batch: int, window: int, device=None):
    """The causal-chain ragged descriptor: every window row live, row i at
    depth i, lower-triangular visibility. Returns (q_lens, depths, anc)."""
    q_lens = torch.full((batch,), window, dtype=torch.int32, device=device)
    depths = torch.arange(window, dtype=torch.int32,
                          device=device).expand(batch, window).contiguous()
    anc = torch.tril(torch.ones((window, window), dtype=torch.bool,
                                device=device)).expand(
        batch, window, window).contiguous()
    return q_lens, depths, anc
