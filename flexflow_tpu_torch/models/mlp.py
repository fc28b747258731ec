"""MLP builder (counterpart of flexflow_tpu/models/mlp.py): dense ReLU
layers and a softmax head, the same calls in the same order as the
reference, so both packages build the same PCG."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


def build_mlp(ff: FFModel, input_dim: int, hidden: Sequence[int], classes: int,
              batch_size: int = None) -> Tensor:
    b = batch_size or ff.config.batch_size
    t = ff.create_tensor((b, input_dim), DataType.FLOAT, name="input")
    for i, h in enumerate(hidden):
        t = ff.dense(t, h, ActiMode.RELU, name=f"dense{i}")
    t = ff.dense(t, classes, name="head")
    return ff.softmax(t, name="softmax")
