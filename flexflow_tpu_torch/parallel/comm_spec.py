"""Declarative comm-specs for sequence-parallel attention (counterpart of
flexflow_tpu/parallel/comm_spec.py).

Round-5 review caught two silent divergences between what the cost model
PRICED and what the lowering EMITTED (ulysses `h_deg` read from the wrong
place, ring `Hkv//h_deg` applied without head-TP). Both happened because
the exchange-shape decisions lived twice: once in `parallel/ring.py`
(runtime) and once in `search/cost_model.py` (pricing). This module is the
single home for those decisions, expressed as pure functions of (attrs,
mesh axis sizes) with no jax imports:

  - `ulysses_plan` / `ring_repeats_kv` / `flash_repeats_kv` are the
    decision procedures the lowerings call at trace time;
  - `attention_lowered_comm_spec` turns a node's attrs + the mesh into the
    list of collectives the lowering will emit (kind, mesh axes, global
    forward bytes) — the comparison surface `fflint`'s consistency pass
    checks the cost model's priced comm-spec against
    (CostModel.attention_comm_spec).

Keeping both sides on these helpers makes the historical bug class a
machine-checked invariant instead of a review finding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


def axes_degree(axes, axis_sizes: Dict[str, int]) -> int:
    """Product of the named mesh axes' sizes — THE sharding-degree
    helper shared by the pricing (cost_model) and checking (analysis)
    sides so the two can never diverge on how degrees are computed."""
    d = 1
    for a in axes:
        d *= axis_sizes.get(a, 1)
    return d


@dataclasses.dataclass(frozen=True)
class CommStep:
    """One collective: `kind` in {"all_to_all", "all_gather", "ppermute",
    "all_reduce"}, `axes` the mesh axes it runs over, `nbytes` the GLOBAL
    forward-pass bytes it moves (training multipliers are applied by the
    cost model when it converts steps to seconds)."""

    kind: str
    axes: Tuple[str, ...]
    nbytes: int

    def key(self) -> Tuple[str, Tuple[str, ...], int]:
        return (self.kind, tuple(sorted(self.axes)), int(self.nbytes))


@dataclasses.dataclass(frozen=True)
class UlyssesPlan:
    """Exchange-shape decisions of ulysses_dot_product_attention for
    (H, Hkv, h_deg, n): whether it falls back to the ring path, whether
    head-TP is active, whether GQA kv must be repeated up front, and how
    many kv heads each exchange leg therefore moves."""

    fallback_to_ring: bool
    head_tp: bool
    repeat_kv: bool
    kv_heads_exchanged: int


def ulysses_plan(H: int, Hkv: int, h_deg: int, n: int) -> UlyssesPlan:
    """Mirror of the trace-time branches in ulysses_dot_product_attention
    (parallel/ring.py) — the lowering itself calls this, so the pricing
    side can never drift from it again (ADVICE r5)."""
    # the all_to_all splits each shard's LOCAL heads (H / head_degree)
    # n ways — divisibility is checked at that granularity
    local_heads = H // h_deg if H % h_deg == 0 else H
    head_tp = h_deg > 1 and H % h_deg == 0
    if local_heads % n != 0:
        return UlyssesPlan(True, head_tp, False, Hkv)
    # GQA kv rides the exchange unrepeated only if ITS head count divides
    # the head-TP degree AND its local heads split n ways
    kv_tp_ok = Hkv % h_deg == 0 if head_tp else True
    local_kv = Hkv // h_deg if head_tp and Hkv % h_deg == 0 else Hkv
    repeat = Hkv != H and (local_kv % n != 0 or not kv_tp_ok)
    return UlyssesPlan(False, head_tp, repeat, H if repeat else Hkv)


def ring_repeats_kv(H: int, Hkv: int, h_deg: int) -> bool:
    """True when ring_dot_product_attention repeats GQA kv up front (the
    head-TP sharding needs the kv head dim divisible); the ppermute then
    moves H-head blocks instead of Hkv-head blocks."""
    return h_deg > 1 and Hkv % h_deg != 0 and Hkv != H


def flash_repeats_kv(H: int, Hkv: int, h_deg: int) -> bool:
    """True when _sharded_flash (the reference's ops/jax_ops.py) repeats GQA kv before
    head-TP shard_map (kv heads must shard evenly over the head axis)."""
    head_tp = h_deg > 1 and H % h_deg == 0
    return head_tp and Hkv % h_deg != 0 and Hkv != H


def attention_lowered_comm_spec(
    attrs,
    batch: int,
    seq: int,
    dtype_bytes: int,
    axis_sizes: Dict[str, int],
    *,
    is_ring_op: bool,
    view_seq_axes: Tuple[str, ...] = (),
    seq_axis: str = "seq",
    head_axis: str = "model",
) -> List[CommStep]:
    """The seq-exchange collectives the attention LOWERING emits for a
    node with `attrs` on a mesh with `axis_sizes` (forward pass, global
    bytes). Pure function of attrs + mesh — the lowering hardcodes the
    `seq`/`model` axis names, so the declaration does too; a strategy that
    shards the sequence over any other axis is priced over that axis by
    the cost model and the mismatch surfaces in fflint.

    Covers the explicitly-emitted exchanges (all_to_all / ppermute /
    GSPMD's q+kv gather for a seq-sharded plain MHA). The wo partial-sum
    all-reduce is view-driven on both sides and compared separately.
    """
    H = attrs.num_heads
    Hkv = attrs.num_kv
    hd = attrs.kdim
    h_deg = axis_sizes.get(head_axis, 1)
    q_bytes = batch * seq * H * hd * dtype_bytes

    if not is_ring_op:
        # plain MULTIHEAD under a seq-sharded VIEW: the lowering has no
        # seq-exchange of its own — the shard_map flash wrapper keeps S
        # local, so GSPMD all-gathers q/k/v over whatever axes the view
        # shards the sequence dim with (kv travels unrepeated; any repeat
        # happens after the gather)
        deg = 1
        for a in view_seq_axes:
            deg *= axis_sizes.get(a, 1)
        if deg <= 1:
            return []
        kv_bytes = 2 * batch * seq * Hkv * hd * dtype_bytes
        return [CommStep("all_gather", tuple(view_seq_axes),
                         q_bytes + kv_bytes)]

    # ring/ulysses lowerings read the MESH directly (seq/model axis names
    # are hardcoded at trace time), independent of the assigned view
    n = axis_sizes.get(seq_axis, 1)
    if n <= 1:
        return []
    ax = (seq_axis,)

    mode = getattr(attrs, "seq_mode", "ring")
    if mode == "ulysses":
        plan = ulysses_plan(H, Hkv, h_deg, n)
        if not plan.fallback_to_ring:
            kv_ex = 2 * batch * seq * plan.kv_heads_exchanged * hd * dtype_bytes
            return [
                CommStep("all_to_all", ax, q_bytes + kv_ex),
                CommStep("all_to_all", ax, q_bytes),
            ]
        # local heads don't split n ways: the lowering silently runs the
        # ring path instead — fall through so the declaration matches
    kv_heads = H if ring_repeats_kv(H, Hkv, h_deg) else Hkv
    kv_bytes = 2 * batch * seq * kv_heads * hd * dtype_bytes
    return [CommStep("ppermute", ax, kv_bytes)]
