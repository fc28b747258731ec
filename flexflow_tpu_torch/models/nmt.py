"""Seq2seq NMT builder (counterpart of flexflow_tpu/models/nmt.py): a
stacked-LSTM encoder over the source ids and a stacked-LSTM decoder over
the target ids whose layers start from the encoder's final (h, c), then a
vocabulary projection and softmax at every target step; one LSTM op per
layer over the whole sequence, the same calls in the same order as the
reference.
"""

from __future__ import annotations

import dataclasses

from typing import Dict

from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.model import FFModel, Tensor
from flexflow_tpu_torch.parallel.sharding import ShardingView


@dataclasses.dataclass(frozen=True)
class NMTConfig:
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    embed_dim: int = 1024
    hidden: int = 1024
    layers: int = 2

    @staticmethod
    def tiny() -> "NMTConfig":
        return NMTConfig(src_vocab=96, tgt_vocab=88, embed_dim=16, hidden=24,
                         layers=2)


def build_nmt(ff: FFModel, cfg: NMTConfig, batch_size: int = None,
              src_len: int = 32, tgt_len: int = 32) -> Tensor:
    """Per-step target-vocabulary probabilities (batch, tgt_len,
    tgt_vocab); train against next-token labels with sparse CCE."""
    b = batch_size or ff.config.batch_size
    src = ff.create_tensor((b, src_len), DataType.INT32, name="src_ids")
    tgt = ff.create_tensor((b, tgt_len), DataType.INT32, name="tgt_ids")

    h = ff.embedding(src, cfg.src_vocab, cfg.embed_dim, name="src_emb")
    finals = []
    for i in range(cfg.layers):
        h, hn, cn = ff.lstm(h, cfg.hidden, name=f"enc{i}")
        finals.append((hn, cn))

    d = ff.embedding(tgt, cfg.tgt_vocab, cfg.embed_dim, name="tgt_emb")
    for i in range(cfg.layers):
        d, _, _ = ff.lstm(d, cfg.hidden, initial_state=finals[i],
                          name=f"dec{i}")

    logits = ff.dense(d, cfg.tgt_vocab, name="proj")
    return ff.softmax(logits, name="softmax")


def nmt_dp_strategy(cfg: NMTConfig) -> Dict[str, ShardingView]:
    """Data-parallel views (the reference NMT's default ParallelConfig is
    batch partitioning too, nmt.cc:319-350) with the vocabulary
    projection cut on its columns over `model` when that axis exists,
    the softmaxDP analog."""
    seq3 = (("data",), (), ())
    state2 = (("data",), ())
    views: Dict[str, ShardingView] = {}
    for pre in ("enc", "dec"):
        for i in range(cfg.layers):
            views[f"{pre}{i}"] = ShardingView((seq3, state2, state2))
    views["src_emb"] = ShardingView((seq3,))
    views["tgt_emb"] = ShardingView((seq3,))
    views["proj"] = ShardingView(
        ((("data",), (), ("model",)),), {"kernel": ((), ("model",))},
        input_specs=(seq3,),
    )
    views["softmax"] = ShardingView(((("data",), (), ("model",)),))
    return views
