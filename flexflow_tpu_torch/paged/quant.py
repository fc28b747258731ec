"""Quantized KV pages: int8 payload with per-page, per-KV-head scales
(counterpart of flexflow_tpu/paged/quant.py).

A quantized pool keeps, per attention node, four buffers in the caches
dict instead of two::

    {"k":       (num_pages, page_size, Hkv, D)  int8,
     "v":       (num_pages, page_size, Hkv, D)  int8,
     "k_scale": (num_pages, Hkv)                float32,
     "v_scale": (num_pages, Hkv)                float32}

One symmetric scale per (page, kv head, K or V): stored = round(x /
scale) clipped to [-127, 127], loaded = stored * scale. The sidecar lives
in the same dict as its pages, so every operation that maps over a
node's dict — the copy-on-write clone, the defrag permutation — moves
scales with pages by construction.

Quantize-on-append with rescale-on-grow: a page's scale only grows while
the page is allocated (the scheduler zeroes it when the page comes off
the free list). When an append's rows need a larger scale, the touched
pages' existing int8 rows are re-quantized to the grown scale in place.
Zero scales make empty pages dequantize to exact zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

QMAX = 127.0  # symmetric int8 grid: round(x / scale) in [-127, 127]

# Floor for the rescale ratio's divisor: far below any real scale but
# large enough that old_scale / SCALE_EPS stays finite in fp32.
SCALE_EPS = 1e-30

# kv_dtype knob values -> (dtype name, itemsize bytes, quantized?). "auto"
# (the default) means the model's own dtype with no scale sidecar and is
# absent here: callers treat it as None.
KV_DTYPES = {
    "fp32": ("float32", 4, False),
    "float32": ("float32", 4, False),
    "bf16": ("bfloat16", 2, False),
    "bfloat16": ("bfloat16", 2, False),
    "fp16": ("float16", 2, False),
    "float16": ("float16", 2, False),
    "int8": ("int8", 1, True),
}

SCALE_BYTES = 4  # the sidecar is float32 per (page, head, K or V)


def kv_dtype_info(kv_dtype: Optional[str]) -> Optional[Tuple[str, int, bool]]:
    """(dtype name, itemsize, quantized) for a kv_dtype knob value, or
    None for "auto"/None. Raises on unknown names."""
    if kv_dtype is None or kv_dtype == "auto":
        return None
    try:
        return KV_DTYPES[kv_dtype]
    except KeyError:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; expected 'auto' or one of "
            f"{sorted(set(KV_DTYPES))}") from None


def resolve_kv_dtype(kv_dtype: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype for a kv_dtype knob value (None for "auto")."""
    info = kv_dtype_info(kv_dtype)
    return None if info is None else getattr(torch, info[0])


def is_quantized_dtype(dtype) -> bool:
    """True when a pool at this dtype needs the scale sidecar."""
    return dtype == torch.int8


def quantized_append(pool, scales, x, page, off, live):
    """Write fp rows ``x`` into an int8 ``pool`` under grow-only
    per-(page, head) ``scales``, both IN PLACE. pool: (N, P, Hkv, D)
    int8; scales: (N, Hkv) fp32; x: (B, S, Hkv, D) fp; page/off/live:
    (B, S). Returns (pool, scales), the same tensors.

    Three scatters, each touching only the B*S addressed pages:
      1. grow: scatter-max each live row's needed scale (amax / 127) into
         its page's entry (duplicate pages combine under max);
      2. rescale: re-quantize the touched pages' existing rows from the
         old scale to the grown one (duplicate pages write identical
         content);
      3. write: quantize the new rows at the grown scale. Dead rows
         (live False) are redirected to the null page by the caller and
         excluded from step 1, so padding never inflates a real scale.
    torch.round rounds half to even, as jnp.round does, so the bytes
    equal the JAX package's."""
    Hkv = x.shape[2]
    pg = page.reshape(-1).long()
    of = off.reshape(-1).long()
    xf = x.float().reshape(-1, Hkv, x.shape[3])                # (B*S, Hkv, D)
    amax = xf.abs().amax(dim=-1)                               # (B*S, Hkv)
    need = torch.where(live.reshape(-1, 1), amax / QMAX,
                       torch.zeros_like(amax))
    old_t = scales[pg]
    scales.scatter_reduce_(0, pg[:, None].expand(-1, Hkv), need, "amax",
                           include_self=True)
    new_t = scales[pg]
    grown = new_t > 0
    ratio = torch.where(grown, old_t / new_t.clamp_min(SCALE_EPS),
                        torch.zeros_like(old_t))
    blk = pool[pg].float() * ratio[:, None, :, None]           # (B*S, P, Hkv, D)
    pool[pg] = torch.round(blk).clamp_(-QMAX, QMAX).to(pool.dtype)
    s_rows = torch.where(grown, new_t, torch.ones_like(new_t))[..., None]
    pool[pg, of] = torch.round(xf / s_rows).clamp_(-QMAX, QMAX).to(pool.dtype)
    return pool, scales


def dequantize_pages(pages, scales):
    """pages: (..., P, Hkv, D) int8 gathered by page; scales: (..., Hkv)
    fp32 gathered the same way. Returns fp32 pages."""
    return pages.float() * scales[..., None, :, None]


def quantize_leaf(arr: torch.Tensor) -> torch.Tensor:
    """Per-leaf symmetric int8 fake quantization for weight storage
    (Executor.init_params(weight_dtype="int8")): every element snaps to
    the 255-point grid scale * [-127..127], scale = max |arr| / 127 (1
    for an all-zero leaf), and the result is stored bf16, as the
    reference stores it: the matmuls downstream stay dense float. fp32
    arithmetic and round-half-to-even throughout, so the values equal the
    JAX package's bit for bit."""
    a = arr.float()
    scale = a.abs().max() / QMAX
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(a / scale).clamp_(-QMAX, QMAX)
    return (q * scale).to(torch.bfloat16)
