"""Llama-family decoder builder (counterpart of
flexflow_tpu/models/llama.py): RMSNorm, GQA attention with RoPE, SwiGLU
MLP, through the FFModel layer API — the same calls in the same order, so
both packages build the same PCG. Ring attention, the pipeline composite
and the sharding strategies are not ported yet.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.model import FFModel, Tensor


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    hidden: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab: int = 512) -> "LlamaConfig":
        """Test-sized config."""
        return LlamaConfig(vocab_size=vocab, dim=64, layers=2, heads=4,
                           kv_heads=2, hidden=128, rope_theta=10000.0)

    @staticmethod
    def bench_1b() -> "LlamaConfig":
        """~1.2B-parameter config."""
        return LlamaConfig(vocab_size=32000, dim=2048, layers=16, heads=16,
                           kv_heads=8, hidden=5632)


def build_llama(ff: FFModel, cfg: LlamaConfig, batch_size: int = None,
                seq_len: int = 2048, dtype: DataType = DataType.BFLOAT16,
                use_ring_attention: bool = False,
                use_pipeline: bool = False) -> Tensor:
    if use_ring_attention or use_pipeline:
        raise NotImplementedError(
            "ring attention and the pipeline composite are not ported yet "
            "(ROADMAP.md, queue 1)")
    b = batch_size or ff.config.batch_size
    ids = ff.create_tensor((b, seq_len), DataType.INT32, name="input_ids")
    h = ff.embedding(ids, cfg.vocab_size, cfg.dim, dtype=dtype,
                     name="tok_emb")
    for i in range(cfg.layers):
        a = ff.rms_norm(h, eps=cfg.norm_eps, name=f"l{i}_attn_norm")
        a = ff.multihead_attention(
            a, a, a, cfg.dim, cfg.heads, causal=True, kv_heads=cfg.kv_heads,
            rope=True, rope_theta=cfg.rope_theta, bias=False,
            name=f"l{i}_attn")
        h = ff.add(h, a, name=f"l{i}_res1")
        m = ff.rms_norm(h, eps=cfg.norm_eps, name=f"l{i}_mlp_norm")
        g = ff.dense(m, cfg.hidden, use_bias=False, name=f"l{i}_gate")
        u = ff.dense(m, cfg.hidden, use_bias=False, name=f"l{i}_up")
        x = ff.multiply(ff.silu(g, name=f"l{i}_silu"), u, name=f"l{i}_gxu")
        d = ff.dense(x, cfg.dim, use_bias=False, name=f"l{i}_down")
        h = ff.add(h, d, name=f"l{i}_res2")
    h = ff.rms_norm(h, eps=cfg.norm_eps, name="final_norm")
    logits = ff.dense(h, cfg.vocab_size, use_bias=False, name="lm_head")
    return ff.softmax(logits, name="softmax")
