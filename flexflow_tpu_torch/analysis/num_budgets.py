"""num_budgets — the declarative numerics budget catalog (the port's own
copy of flexflow_tpu/analysis/num_budgets.py, entry for entry; a test
holds the two equal, so neither band can drift from the other).

Every allowed error band gets a NAME here, with its value, what kind of
bound it is, and who consumes it. The `kv_quant_canary` watchdog reads
its alert threshold from it (paged/scheduler.py).

Kinds:
  abs          absolute bound on a max-abs delta (same units as data)
  rel          relative bound (rtol against a reference magnitude)
  scale_steps  bound expressed in multiples of a quantization grid
               step — the consumer multiplies by the relevant scale
  ratio        dimensionless floor/ceiling on a measured ratio

Pure data: no torch import.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

KINDS = ("abs", "rel", "scale_steps", "ratio")


@dataclasses.dataclass(frozen=True)
class Budget:
    """One named error band. `consumers` names the code/tests that
    enforce it, so a band with no consumer is visibly dead weight."""

    value: float
    kind: str
    consumers: Tuple[str, ...]
    description: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


BUDGETS: Dict[str, Budget] = {
    # -- int8 KV pages (paged/quant.py) --------------------------------
    "int8-kv-roundtrip": Budget(
        0.51, "scale_steps",
        ("tests/test_quantized_kv.py::test_quantized_append_grow_only"
         "_roundtrip",),
        "one quantize/dequantize round-trip through the symmetric int8 "
        "grid lands within half a grid step (0.5 rounding + float "
        "slack) of the fp source; a row that survives a grow pays one "
        "trip per grid it crossed"),
    "int8-kv-commit-regrow": Budget(
        1.02, "scale_steps",
        ("tests/test_quantized_kv.py::test_scale_aware_commit_copies"
         "_across_scales",),
        "the scale-aware spec-commit row copy re-snaps existing rows to "
        "the grown destination grid: up to two half-step round-trips "
        "(source grid then destination grid) per element"),
    "int8-kv-mixed-batch": Budget(
        0.05, "abs",
        ("tests/test_quantized_kv.py::test_mixed_ragged_batch_quantized"
         "_tolerance",),
        "max abs attention-output delta of an int8 pool vs the fp32 "
        "pool on the mixed decode/chunk/tree ragged batch, on BOTH "
        "attention paths (Pallas dequant-on-load and the gather "
        "fallback) — the end-to-end bound the per-row round-trip "
        "budgets compose into"),
    "kv-canary-shadow-delta": Budget(
        1e-2, "abs",
        ("paged/scheduler.py kv_quant_canary watchdog",
         "tests/test_quantized_kv.py::test_greedy_int8_server_within"
         "_tolerance"),
        "max abs output-probability delta between the live quantized "
        "pool and the fp32 shadow cache (kv_quant_error gauge); the "
        "canary counts a breach and logs when the gauge crosses it "
        "(measured ~1e-4 on the reference config)"),
    "int8-weight-grid": Budget(
        0.5, "scale_steps",
        ("tests/test_quantized_kv.py::test_init_params_int8_fake_quant"
         "_snaps_to_grid",),
        "int8 weight fake-quantization (quantize_leaf) snaps every "
        "element within half a grid step of the fp draw, before the "
        "bf16 storage round-off term the test adds on top"),
    # -- speculative decode over quantized pools -----------------------
    "spec-acceptance-floor": Budget(
        1.5, "ratio",
        ("tests/test_quantized_kv.py::test_spec_acceptance_floor_on"
         "_quantized_pool",),
        "accepted tokens per verify step on the token-cyclic fixture "
        "must stay at or above this floor on an int8 pool — quantized "
        "verify must not reject a drafter that predicts the stream"),
    # -- HF importer parity (tools/hf_import) --------------------------
    "hf-import-parity-atol": Budget(
        0.05, "abs",
        ("tests/test_hf_import.py",),
        "absolute logit tolerance for a checkpoint imported from the "
        "HF layout vs the reference forward (paired with "
        "hf-import-parity-rtol)"),
    "hf-import-parity-rtol": Budget(
        0.25, "rel",
        ("tests/test_hf_import.py",),
        "relative logit tolerance for the HF-importer parity check "
        "(wide by design: tiny random models amplify rounding in "
        "near-zero logits)"),
}

# Bands the serving stack dereferences at runtime — numcheck's budget
# arm errors if one goes missing, so a catalog edit cannot silently
# strand the canary or the KV tolerance tests.
REQUIRED_BUDGETS = (
    "int8-kv-mixed-batch",
    "kv-canary-shadow-delta",
    "int8-kv-roundtrip",
)


def budget(name: str) -> Budget:
    """The named budget; raises KeyError with the catalog listing so a
    typo'd or deleted band fails loudly at the consumer."""
    try:
        return BUDGETS[name]
    except KeyError:
        raise KeyError(
            f"no numerics budget named {name!r}; catalog: "
            f"{sorted(BUDGETS)}") from None


def tolerance(name: str) -> float:
    """Shorthand for budget(name).value — what test asserts and the
    canary threshold read."""
    return budget(name).value


def validate_catalog() -> Dict[str, str]:
    """{budget_name: problem} for malformed entries (non-positive or
    non-finite value, unknown kind, missing description/consumers) plus
    '<missing>' entries for absent REQUIRED_BUDGETS. Empty when the
    catalog is healthy — numcheck's budget arm turns each problem into
    a finding."""
    problems: Dict[str, str] = {}
    for name, b in BUDGETS.items():
        if not isinstance(b.value, (int, float)) or not \
                math.isfinite(float(b.value)) or float(b.value) <= 0.0:
            problems[name] = f"value {b.value!r} must be finite and > 0"
        elif b.kind not in KINDS:
            problems[name] = (f"kind {b.kind!r} not in {KINDS}")
        elif not b.consumers:
            problems[name] = "no consumers named (dead band)"
        elif not b.description.strip():
            problems[name] = "empty description"
    for name in REQUIRED_BUDGETS:
        if name not in BUDGETS:
            problems[name] = ("<missing> — required by the serving "
                              "stack (REQUIRED_BUDGETS)")
    return problems
