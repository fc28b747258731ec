"""BERT-base encoder builder (counterpart of flexflow_tpu/models/bert.py):
token embedding plus a learned position table, post-LayerNorm layers of
biased non-causal attention (dropout on its probabilities in training)
and a GELU MLP, and a classification head on the first token, the same
calls in the same order as the reference. The head dim is 64, so
attention takes the head-major flash route (K4) outside training at
dropout 0, and the dense dropout route in a training step at a rate
above 0, as the reference routes it. The position table is stored fp32
(the reference's master), so a bf16 BERT runs fp32 from its position add
on, as the reference computes it.
"""

from __future__ import annotations

import dataclasses

from typing import Dict

from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor
from flexflow_tpu_torch.parallel.sharding import ShardingView


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_seq: int = 512
    num_classes: int = 2  # sequence-classification head
    dropout: float = 0.1


def build_bert(ff: FFModel, cfg: BertConfig, batch_size: int = None,
               seq_len: int = 128, dtype: DataType = DataType.FLOAT) -> Tensor:
    b = batch_size or ff.config.batch_size
    ids = ff.create_tensor((b, seq_len), DataType.INT32, name="input_ids")
    h = ff.embedding(ids, cfg.vocab_size, cfg.hidden, dtype=dtype,
                     name="tok_emb")
    pos = ff.create_weight((seq_len, cfg.hidden), dtype, name="pos_emb")
    h = ff.add_position_embedding(h, pos, name="add_pos")
    h = ff.layer_norm(h, name="emb_ln")
    for i in range(cfg.layers):
        a = ff.multihead_attention(
            h, h, h, cfg.hidden, cfg.heads, dropout=cfg.dropout, bias=True,
            name=f"l{i}_attn")
        h = ff.layer_norm(ff.add(h, a, name=f"l{i}_res1"), name=f"l{i}_ln1")
        m = ff.dense(h, cfg.intermediate, ActiMode.GELU, name=f"l{i}_ff1")
        m = ff.dense(m, cfg.hidden, name=f"l{i}_ff2")
        h = ff.layer_norm(ff.add(h, m, name=f"l{i}_res2"), name=f"l{i}_ln2")
    # the first ([CLS]) token's state feeds the classification head
    cls = ff.split(h, [1, seq_len - 1], axis=1, name="cls_split")[0]
    cls = ff.reshape(cls, (b, cfg.hidden), name="cls_flat")
    logits = ff.dense(cls, cfg.num_classes, name="cls_head")
    return ff.softmax(logits, name="softmax")


def bert_attribute_parallel_strategy(cfg: BertConfig
                                     ) -> Dict[str, ShardingView]:
    """Attention heads cut over the `model` axis (the reference's
    attribute parallelism, attention.cc head-parallel machine views) and
    the Megatron column/row split of the FFN."""
    views: Dict[str, ShardingView] = {}
    for i in range(cfg.layers):
        views[f"l{i}_attn"] = ShardingView(
            output_specs=(None,),
            weight_specs={
                "wq": ((), ("model",), ()),
                "wk": ((), ("model",), ()),
                "wv": ((), ("model",), ()),
                "wo": (("model",), (), ()),
                "bq": (("model",), ()),
                "bk": (("model",), ()),
                "bv": (("model",), ()),
                "bo": ((),),
            },
        )
        views[f"l{i}_ff1"] = ShardingView(
            output_specs=(None,),
            weight_specs={"kernel": ((), ("model",)), "bias": (("model",),)},
        )
        views[f"l{i}_ff2"] = ShardingView(
            output_specs=(None,),
            weight_specs={"kernel": (("model",), ()), "bias": ((),)},
        )
    return views
