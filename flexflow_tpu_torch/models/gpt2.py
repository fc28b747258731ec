"""The GPT-2 family (counterpart of flexflow_tpu/models/gpt2.py):
pre-LayerNorm decoder with learned absolute positions, biased causal
attention and a tanh-GELU MLP, through the FFModel layer API — the same
calls in the same order, so both packages build the same PCG. The head
dim is 64 at every published size, so its attention takes the
head-major flash route (kernel K4) on the card. The lm_head is untied,
as the reference builds it.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    dim: int = 768
    layers: int = 12
    heads: int = 12
    inner: int = 0  # 0 -> 4*dim
    ln_eps: float = 1e-5

    @property
    def intermediate(self) -> int:
        return self.inner or 4 * self.dim

    @staticmethod
    def tiny(vocab: int = 256) -> "GPT2Config":
        return GPT2Config(vocab_size=vocab, dim=64, layers=2, heads=4)


def build_gpt2(ff: FFModel, cfg: GPT2Config, batch_size: int = None,
               seq_len: int = 128,
               dtype: DataType = DataType.FLOAT) -> Tensor:
    b = batch_size or ff.config.batch_size
    ids = ff.create_tensor((b, seq_len), DataType.INT32, name="input_ids")
    h = ff.embedding(ids, cfg.vocab_size, cfg.dim, dtype=dtype, name="wte")
    pos = ff.create_weight((seq_len, cfg.dim), dtype, name="wpe")
    h = ff.add_position_embedding(h, pos, name="add_pos")
    for i in range(cfg.layers):
        a = ff.layer_norm(h, eps=cfg.ln_eps, name=f"h{i}_ln1")
        a = ff.multihead_attention(a, a, a, cfg.dim, cfg.heads, bias=True,
                                   causal=True, name=f"h{i}_attn")
        h = ff.add(h, a, name=f"h{i}_res1")
        m = ff.layer_norm(h, eps=cfg.ln_eps, name=f"h{i}_ln2")
        m = ff.dense(m, cfg.intermediate, ActiMode.GELU, name=f"h{i}_fc")
        m = ff.dense(m, cfg.dim, name=f"h{i}_proj")
        h = ff.add(h, m, name=f"h{i}_res2")
    h = ff.layer_norm(h, eps=cfg.ln_eps, name="ln_f")
    logits = ff.dense(h, cfg.vocab_size, use_bias=False, name="lm_head")
    return ff.softmax(logits, name="softmax")
