"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX one, with the same module names: the
FFModel builder and PCG, the op lowerings, single-device training (loss,
metrics, SGD and Adam) and paged continuous-batching serving, running
eagerly on an NVIDIA GPU (or, when asked, the CPU). Its hand-written
kernels are the ragged paged attention (csrc/ragged_paged_attention.cu),
the flat-layout flash-attention forward and backward
(csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu) for head dims
that are multiples of 128, the head-major ones for every other head dim
(csrc/flash_attention_bh_fwd.cu, csrc/flash_attention_bh_bwd.cu), and
the ring-attention step, which folds a k/v block into carried softmax
statistics (csrc/flash_attention_bh_fwd.cu; ops/ring_flash.py,
parallel/ring.py). Models: one module per module of the reference's
zoo (models/): Llama (optionally with ring attention over the mesh's seq
axis), GPT-2, the Mixtral-style MoE decoder, BERT, the Transformer
encoder and encoder-decoder, the LSTM NMT, the MLP, AlexNet, ResNet-50,
ResNeXt-50, Inception-v3, CANDLE-UNO, DLRM and XDL; their convolution,
pooling, BatchNorm, LSTM and MoE math are PyTorch ops, as the
reference's are lax/jnp. Around them: checkpoints (runtime/checkpoint.py,
the JAX package's npz format), data loaders (runtime/dataloader.py, a
native gather worker built from csrc/ffloader.cc at first use),
recompilation in fit (runtime/recompile.py), the HuggingFace, torch.fx,
Keras and keras_exp frontends (frontends/), the CLI driver (`python -m
flexflow_tpu_torch SCRIPT flags`) and one example script per reference
example (examples/). It imports torch, never jax, and nothing of
flexflow_tpu.
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

# the FFConfig the CLI driver (python -m flexflow_tpu_torch) parsed
_driver_config = None


def get_driver_config() -> FFConfig:
    """The FFConfig `python -m flexflow_tpu_torch SCRIPT flags` parsed from
    its flags, or the default FFConfig outside the driver."""
    return _driver_config or FFConfig()


__all__ = ["ActiMode", "AdamOptimizer", "AggrMode", "DataType", "FFConfig",
           "FFModel", "LossType", "MetricsType", "OpType", "SGDOptimizer",
           "Tensor", "get_driver_config"]
