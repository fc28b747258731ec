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
launches a hand-written Hopper kernel (csrc/ragged_paged_attention.cu: a
page walk split by `ragged_split_plan` plus a combine pass, for an fp
pool, whose dtype may differ from q's, or for an int8 pool, whose pages
it dequantizes with their per-(page, head) scales, paged/quant.py) or
raises; on CPU tensors it runs the plain PyTorch version of the same
contract, `ragged_gather_attention`. There is no other path and no
switch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from flexflow_tpu_torch.kernels import (
    KERNEL_DTYPES,
    KV_KERNEL_DTYPES,
    launch_ragged_paged_attention,
    launch_ragged_paged_attention_int8,
)
from flexflow_tpu_torch.ops.torch_ops import apply_rope, dot_product_attention
from flexflow_tpu_torch.paged.quant import dequantize_pages, quantized_append


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
                            q_lens, anc_mask, *, scale: float,
                            k_scales=None, v_scales=None):
    """The plain PyTorch version of the kernels' contract: gather every
    table-mapped page (`pool[page_table]`) and run dense masked attention
    under ragged_visibility_mask. q: (B, S, H, D); kc/vc_pages:
    (N, P, Hkv, D); page_tables: (B, max_pages) int32; pos/q_lens: (B,)
    int32; anc_mask: (B, S, S) bool. An fp pool is cast to q's dtype. For
    an int8 pool, k_scales/v_scales are its (N, Hkv) fp32 sidecar: the
    gathered pages are dequantized, q is upcast, the whole attention runs
    in fp32 and only the output is cast back to q's dtype. Rows at or
    past q_lens[b] are zeroed, as the kernels write them."""
    B, S, _, D = q.shape
    P, Hkv = kc_pages.shape[1], kc_pages.shape[2]
    pt = page_tables.long()
    if k_scales is not None:
        kg = dequantize_pages(kc_pages[pt], k_scales[pt])
        vg = dequantize_pages(vc_pages[pt], v_scales[pt])
        qa = q.float()
    else:
        kg, vg, qa = kc_pages[pt].to(q.dtype), vc_pages[pt].to(q.dtype), q
    mask = ragged_visibility_mask(page_tables, pos, q_lens, anc_mask, P)
    out = dot_product_attention(qa, kg.reshape(B, -1, Hkv, D),
                                vg.reshape(B, -1, Hkv, D), scale,
                                mask).to(q.dtype)
    live = (torch.arange(S, device=q.device)[None, :]
            < q_lens[:, None].long())
    return out * live[:, :, None, None].to(out.dtype)


# The kernels' split plan (fp and int8 pools): a split walks at least
# SPLIT_MIN_ROWS cache rows, and at least SPLIT_ROWS_PER_Q_ROW per query
# row of its GQA group (rep x window), so a partial's fp32 write stays
# small beside the K/V it read; and no more splits than fill the card
# SPLIT_WAVES times over when an entry's whole table is live.
SPLIT_MIN_ROWS = 128
SPLIT_ROWS_PER_Q_ROW = 16
SPLIT_WAVES = 4


class SplitPlan(NamedTuple):
    pages_per_split: int
    n_splits: int


def ragged_split_plan(B: int, S: int, H: int, Hkv: int, P: int, maxp: int,
                      sm_count: int) -> SplitPlan:
    """How the kernels split each entry's page walk: split s of an
    (entry, kv head) walks pages s * pages_per_split .. of its table,
    n_splits = ceil(maxp / pages_per_split). Static shapes only (batch,
    window, heads, page size, table width, the card's SM count): never
    pos or q_lens, so the launch reads nothing back and a CUDA graph can
    hold it."""
    rows = max(SPLIT_MIN_ROWS, SPLIT_ROWS_PER_Q_ROW * (H // Hkv) * S)
    most = max(1, -(-SPLIT_WAVES * sm_count // (B * Hkv)))
    pps = min(maxp, max(-(-rows // P), -(-maxp // most)))
    return SplitPlan(pps, -(-maxp // pps))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_kernel_args(q, kc, vc, page_tables, pos, q_lens, anc,
                       k_scales=None, v_scales=None):
    B, S, H, D = q.shape
    if kc.ndim != 4 or kc.shape != vc.shape or kc.dtype != vc.dtype:
        raise ValueError(f"pools must share one (N, P, Hkv, D) shape and "
                         f"dtype, got {tuple(kc.shape)} {kc.dtype} and "
                         f"{tuple(vc.shape)} {vc.dtype}")
    N, P, Hkv, Dk = kc.shape
    if Dk != D or H % Hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(kc.shape)} (head dim, GQA grouping)")
    quant = k_scales is not None
    if q.dtype not in KERNEL_DTYPES or not (
            quant or kc.dtype in KV_KERNEL_DTYPES):
        raise ValueError(f"kernels take float32 or bfloat16 q and float32, "
                         f"bfloat16, float16 or int8 pools, got {q.dtype} "
                         f"and {kc.dtype}")
    shapes = {"page_tables": (page_tables, (B, page_tables.shape[-1]),
                              torch.int32),
              "pos": (pos, (B,), torch.int32),
              "q_lens": (q_lens, (B,), torch.int32),
              "anc": (anc, (B, S, S), torch.bool)}
    if quant:
        shapes["k_scales"] = (k_scales, (N, Hkv), torch.float32)
        shapes["v_scales"] = (v_scales, (N, Hkv), torch.float32)
    for name, (t, shape, dt) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("q", q), ("kc", kc), ("vc", vc),
                    ("page_tables", page_tables), ("pos", pos),
                    ("q_lens", q_lens), ("anc", anc)) + (
                        (("k_scales", k_scales), ("v_scales", v_scales))
                        if quant else ()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ragged_flash_attention(q, kc_pages, vc_pages, page_tables, pos, q_lens,
                           anc_mask, *, scale: float, k_scales=None,
                           v_scales=None):
    """The kernel wrapper: (B, S, H, D) attention output under the ragged
    descriptor, rows at or past q_lens[b] exact zeros. CUDA tensors launch
    a hand-written kernel — the int8 kernel for an int8 pool (with its
    k_scales/v_scales), the fp-pool kernel otherwise, whose K/V may be of
    another float dtype than q — and raise on anything they do not take;
    CPU tensors take the plain version. Mixed devices raise. Any window
    launches, as the reference's does: where one block cannot hold an
    entry's rep x S q and acc rows (rep 4, D 128: windows 64 and 65) the
    launcher cuts the window into row tiles, each walking the same
    pages."""
    if (kc_pages.dtype == torch.int8) != (k_scales is not None) or (
            k_scales is None) != (v_scales is None):
        raise ValueError("an int8 pool needs k_scales and v_scales, and "
                         "only an int8 pool takes them")
    tensors = (q, kc_pages, vc_pages, page_tables, pos, q_lens, anc_mask) \
        + tuple(t for t in (k_scales, v_scales) if t is not None)
    if all(t.device.type == "cpu" for t in tensors):
        return ragged_gather_attention(q, kc_pages, vc_pages, page_tables,
                                       pos, q_lens, anc_mask, scale=scale,
                                       k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged attention runs on CUDA or CPU tensors, "
                         f"got q on {q.device}")
    _check_kernel_args(q, kc_pages, vc_pages, page_tables, pos, q_lens,
                       anc_mask, k_scales, v_scales)
    out = torch.empty_like(q)
    B, S, H, _ = q.shape
    plan = ragged_split_plan(B, S, H, kc_pages.shape[2], kc_pages.shape[1],
                             page_tables.shape[1], _sm_count(q.device.index))
    if k_scales is not None:
        return launch_ragged_paged_attention_int8(
            q, kc_pages, vc_pages, k_scales, v_scales, page_tables, pos,
            q_lens, anc_mask, out, scale, plan)
    return launch_ragged_paged_attention(q, kc_pages, vc_pages, page_tables,
                                         pos, q_lens, anc_mask, out, scale,
                                         plan)


def ragged_paged_attention(q, k, v, cache_k, cache_v, page_tables, pos,
                           q_lens, depths, anc_mask, *, scale: float,
                           rope_theta: Optional[float] = None,
                           k_scales=None, v_scales=None):
    """The single paged-attention step every paged call lowers to: rope
    q/k at pos + depths, write the live K/V rows into their table-mapped
    pages, then attend through ragged_flash_attention.

    The pools are written IN PLACE (index_put_), and the write comes
    before the attention in every layer: that ordering is what lets a
    packed prefill piece see the rows an earlier piece of the same prompt
    wrote in this very step, as committed rows (kpos < pos). Rows past
    q_len or past the table land in the null page 0 with the other
    garbage, never in a real row. With k_scales/v_scales the pools are
    int8 and the write is quantize-on-append under grow-only per-(page,
    head) scales (paged/quant.py), scales updated in place too.

    Returns (output, cache_k, cache_v) — the same pool tensors, updated —
    plus (k_scales, v_scales) in the quantized case."""
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
    if k_scales is not None:
        quantized_append(cache_k, k_scales, k, page, off, live)
        quantized_append(cache_v, v_scales, v, page, off, live)
    else:
        cache_k.index_put_((page, off), k.to(cache_k.dtype))
        cache_v.index_put_((page, off), v.to(cache_v.dtype))
    out = ragged_flash_attention(q, cache_k, cache_v, page_tables, pos,
                                 q_lens, anc_mask, scale=scale,
                                 k_scales=k_scales, v_scales=v_scales)
    if k_scales is not None:
        return out, cache_k, cache_v, k_scales, v_scales
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
