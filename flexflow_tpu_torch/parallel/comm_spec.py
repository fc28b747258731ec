"""Communication decisions shared by the lowerings and (later) the cost
model: a copy of the piece of flexflow_tpu/parallel/comm_spec.py that the
ring needs (the package imports nothing of flexflow_tpu)."""

from __future__ import annotations


def ring_repeats_kv(H: int, Hkv: int, h_deg: int) -> bool:
    """True when ring_dot_product_attention repeats GQA kv up front (the
    head-TP sharding needs the kv head dim divisible); the ring then moves
    H-head blocks instead of Hkv-head blocks
    (flexflow_tpu/parallel/comm_spec.py:85)."""
    return h_deg > 1 and Hkv % h_deg != 0 and Hkv != H
