"""Model builders: Llama, GPT-2 and the Mixtral-style MoE decoder, with
the MoE classifiers."""

from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
from flexflow_tpu_torch.models.mixtral import (
    MixtralConfig,
    build_mixtral,
    build_moe_classifier,
    build_moe_spec_classifier,
    mixtral_ep_strategy,
)

__all__ = ["GPT2Config", "LlamaConfig", "MixtralConfig", "build_gpt2",
           "build_llama", "build_mixtral", "build_moe_classifier",
           "build_moe_spec_classifier", "mixtral_ep_strategy"]
