"""CANDLE-UNO builder (counterpart of flexflow_tpu/models/candle_uno.py):
per-feature-set dense towers concatenated with the dose input into a
dense regression head, the same calls in the same order as the
reference."""

from __future__ import annotations

from typing import Dict, Sequence

from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


def _tower(ff: FFModel, t: Tensor, dims: Sequence[int], name: str) -> Tensor:
    for i, d in enumerate(dims):
        t = ff.dense(t, d, ActiMode.RELU, name=f"{name}{i}")
    return t


def build_candle_uno(
    ff: FFModel,
    batch_size: int = None,
    feature_dims: Dict[str, int] = None,
    tower_dims: Sequence[int] = (1000, 1000, 1000),
    head_dims: Sequence[int] = (1000, 1000, 1000, 1000, 1000),
) -> Tensor:
    """Three encoder towers (gene expression + two drug descriptor sets by
    default, matching the reference's feature sets), concatenated with the
    raw dose input into the dense head; scalar growth prediction (MSE)."""
    b = batch_size or ff.config.batch_size
    feature_dims = feature_dims or {"gene": 942, "drug1": 3820, "drug2": 3820}
    parts = []
    dose = ff.create_tensor((b, 1), DataType.FLOAT, name="dose_input")
    parts.append(dose)
    for fname, fdim in feature_dims.items():
        x = ff.create_tensor((b, fdim), DataType.FLOAT, name=f"{fname}_input")
        parts.append(_tower(ff, x, tower_dims, f"{fname}_t"))
    t = ff.concat(parts, axis=1, name="feature_cat")
    for i, d in enumerate(head_dims):
        t = ff.dense(t, d, ActiMode.RELU, name=f"head{i}")
    return ff.dense(t, 1, name="growth")
