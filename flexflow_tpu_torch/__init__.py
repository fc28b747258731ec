"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX one, with the same module names: the
FFModel builder and PCG, the op lowerings, and paged continuous-batching
serving, running eagerly on an NVIDIA GPU (or, when asked, the CPU). Its
one hand-written kernel so far is the ragged paged attention
(csrc/ragged_paged_attention.cu). It imports torch, never jax, and
nothing of flexflow_tpu.
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import (
    ActiMode,
    AggrMode,
    DataType,
    LossType,
    OpType,
)
from flexflow_tpu_torch.model import FFModel, Tensor

__all__ = ["ActiMode", "AggrMode", "DataType", "FFConfig", "FFModel",
           "LossType", "OpType", "Tensor"]
