"""Transformer builders (counterpart of
flexflow_tpu/models/transformer.py): an encoder stack (attention + two
dense layers a layer) and the encoder-decoder whose decoder attends
causally to itself, then to the encoder states (cross-attention, S != T),
with a dense regression head (MSE), the same calls in the same order as
the reference. The builder fixes fp32; the head dim, dim / heads, is 64
at the default config, so attention takes the head-major flash route
(K4, its 3xTF32 fp32 bodies) on the card."""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    dim: int = 512
    heads: int = 8
    hidden: int = 2048
    layers: int = 6

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(dim=32, heads=4, hidden=64, layers=2)


def _ffn(ff: FFModel, t: Tensor, cfg: TransformerConfig, name: str) -> Tensor:
    h = ff.dense(t, cfg.hidden, ActiMode.RELU, use_bias=False,
                 name=f"{name}_ff1")
    return ff.dense(h, cfg.dim, use_bias=False, name=f"{name}_ff2")


def _encoder_stack(ff: FFModel, t: Tensor, cfg: TransformerConfig) -> Tensor:
    for i in range(cfg.layers):
        a = ff.multihead_attention(t, t, t, cfg.dim, cfg.heads,
                                   causal=False, name=f"enc{i}_attn")
        t = ff.add(t, a, name=f"enc{i}_res")
        t = _ffn(ff, t, cfg, f"enc{i}")
    return t


def build_transformer_encoder(ff: FFModel, cfg: TransformerConfig,
                              batch_size: int = None,
                              seq_len: int = 64) -> Tensor:
    """Encoder stack + regression head (the reference example's main path,
    transformer.cc:144-158)."""
    b = batch_size or ff.config.batch_size
    t = ff.create_tensor((b, seq_len, cfg.dim), DataType.FLOAT, name="input")
    return ff.dense(_encoder_stack(ff, t, cfg), 1, use_bias=False,
                    name="head")


def build_transformer_encoder_decoder(ff: FFModel, cfg: TransformerConfig,
                                      batch_size: int = None,
                                      src_len: int = 64,
                                      tgt_len: int = 48) -> Tensor:
    """Encoder-decoder with cross-attention (transformer.cc:47-72): the
    decoder attends causally to itself, then (unmasked) to the encoder
    states — the layout every seq2seq transformer uses."""
    b = batch_size or ff.config.batch_size
    src = ff.create_tensor((b, src_len, cfg.dim), DataType.FLOAT, name="src")
    tgt = ff.create_tensor((b, tgt_len, cfg.dim), DataType.FLOAT, name="tgt")
    t1 = _encoder_stack(ff, src, cfg)
    t2 = tgt
    for i in range(cfg.layers):
        a = ff.multihead_attention(t2, t2, t2, cfg.dim, cfg.heads,
                                   causal=True, name=f"dec{i}_self")
        t2 = ff.add(t2, a, name=f"dec{i}_res1")
        x = ff.multihead_attention(t2, t1, t1, cfg.dim, cfg.heads,
                                   causal=False, name=f"dec{i}_cross")
        t2 = ff.add(t2, x, name=f"dec{i}_res2")
        t2 = _ffn(ff, t2, cfg, f"dec{i}")
    return ff.dense(t2, 1, use_bias=False, name="head")
