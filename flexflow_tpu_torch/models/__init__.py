"""Model builders, one module per module of flexflow_tpu/models/, each
building the reference's PCG node for node: the MLP, AlexNet, ResNet-50,
ResNeXt-50, Inception-v3, CANDLE-UNO, BERT, the Transformer encoder and
encoder-decoder, the LSTM NMT, DLRM, XDL, Llama, GPT-2 and the
Mixtral-style MoE decoder with the MoE classifiers. The sharding
strategies need mesh axes across cards and raise (ROADMAP.md, queue 1
item 12)."""

from flexflow_tpu_torch.models.alexnet import (
    build_alexnet,
    build_alexnet_cifar10,
)
from flexflow_tpu_torch.models.bert import (
    BertConfig,
    bert_attribute_parallel_strategy,
    build_bert,
)
from flexflow_tpu_torch.models.candle_uno import build_candle_uno
from flexflow_tpu_torch.models.dlrm import build_dlrm
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.models.inception import build_inception_v3
from flexflow_tpu_torch.models.llama import (
    LlamaConfig,
    build_llama,
    llama_pp_strategy,
)
from flexflow_tpu_torch.models.mixtral import (
    MixtralConfig,
    build_mixtral,
    build_moe_classifier,
    build_moe_spec_classifier,
    mixtral_ep_strategy,
)
from flexflow_tpu_torch.models.mlp import build_mlp
from flexflow_tpu_torch.models.nmt import NMTConfig, build_nmt, nmt_dp_strategy
from flexflow_tpu_torch.models.resnet import build_resnet50
from flexflow_tpu_torch.models.resnext import build_resnext50
from flexflow_tpu_torch.models.transformer import (
    TransformerConfig,
    build_transformer_encoder,
    build_transformer_encoder_decoder,
)
from flexflow_tpu_torch.models.xdl import build_xdl

__all__ = ["BertConfig", "GPT2Config", "LlamaConfig", "MixtralConfig",
           "NMTConfig", "TransformerConfig", "bert_attribute_parallel_strategy",
           "build_alexnet", "build_alexnet_cifar10", "build_bert",
           "build_candle_uno", "build_dlrm", "build_gpt2",
           "build_inception_v3", "build_llama", "build_mixtral", "build_mlp",
           "build_moe_classifier", "build_moe_spec_classifier", "build_nmt",
           "build_resnet50", "build_resnext50", "build_transformer_encoder",
           "build_transformer_encoder_decoder", "build_xdl",
           "llama_pp_strategy", "mixtral_ep_strategy", "nmt_dp_strategy"]
