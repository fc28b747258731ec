"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX one, with the same module names: the
FFModel builder and PCG, the op lowerings, single-device training (loss,
metrics, SGD and Adam) and paged continuous-batching serving, running
eagerly on an NVIDIA GPU (or, when asked, the CPU). Its hand-written
kernels are the ragged paged attention (csrc/ragged_paged_attention.cu)
and the flash-attention forward and backward
(csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu). It imports
torch, never jax, and nothing of flexflow_tpu.
"""

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import (
    ActiMode,
    AggrMode,
    DataType,
    LossType,
    MetricsType,
    OpType,
)
from flexflow_tpu_torch.model import FFModel, Tensor
from flexflow_tpu_torch.runtime.optimizer import AdamOptimizer, SGDOptimizer

__all__ = ["ActiMode", "AdamOptimizer", "AggrMode", "DataType", "FFConfig",
           "FFModel", "LossType", "MetricsType", "OpType", "SGDOptimizer",
           "Tensor"]
