"""Llama-family decoder builder (counterpart of
flexflow_tpu/models/llama.py): RMSNorm, GQA attention with RoPE, SwiGLU
MLP, through the FFModel layer API — the same calls in the same order, so
both packages build the same PCG. With `use_ring_attention` each layer's
attention is a RING_ATTENTION node (sequence-parallel over the mesh's
`seq` axis); with `use_pipeline` every decoder block is one PIPELINE
composite with stacked weights (ops/torch_ops.py _pipeline).
`llama_tp_strategy` is the reference's Megatron layout over the `data`
and `model` axes (one process per card); its sequence-parallel form and
the pipeline strategy need axes across cards the port does not run yet
(ROADMAP.md, queue 1 item 12).
"""

from __future__ import annotations

import dataclasses

from typing import Dict

from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.model import FFModel, Tensor
from flexflow_tpu_torch.parallel.sharding import ShardingView


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
                seq_mode: str = "ring",
                use_pipeline: bool = False,
                n_microbatches: int = 4) -> Tensor:
    b = batch_size or ff.config.batch_size
    ids = ff.create_tensor((b, seq_len), DataType.INT32, name="input_ids")
    h = ff.embedding(ids, cfg.vocab_size, cfg.dim, dtype=dtype,
                     name="tok_emb")
    if use_pipeline:
        # every decoder block as ONE stacked-weight composite
        h = ff.pipeline(h, cfg.layers, cfg.heads, cfg.kv_heads, cfg.hidden,
                        n_microbatches=n_microbatches,
                        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                        name="decoder_pipeline")
        h = ff.rms_norm(h, eps=cfg.norm_eps, name="final_norm")
        logits = ff.dense(h, cfg.vocab_size, use_bias=False, name="lm_head")
        return ff.softmax(logits, name="softmax")
    for i in range(cfg.layers):
        a = ff.rms_norm(h, eps=cfg.norm_eps, name=f"l{i}_attn_norm")
        if use_ring_attention:
            a = ff.ring_attention(
                a, a, a, cfg.dim, cfg.heads, causal=True,
                kv_heads=cfg.kv_heads, rope=True, rope_theta=cfg.rope_theta,
                seq_mode=seq_mode, name=f"l{i}_attn")
        else:
            a = ff.multihead_attention(
                a, a, a, cfg.dim, cfg.heads, causal=True,
                kv_heads=cfg.kv_heads, rope=True, rope_theta=cfg.rope_theta,
                bias=False, name=f"l{i}_attn")
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


def llama_tp_strategy(cfg: LlamaConfig, seq_parallel: bool = False
                      ) -> Dict[str, ShardingView]:
    """Hybrid TP(+SP)+DP views, the reference's Megatron layout:
    attention heads and the MLP column/row split over `model`, the gate
    -> silu -> x -> down chain keeping its hidden dim cut over `model`
    between the column and row products; activations cut over `data` on
    the batch (and over `seq` on the sequence with `seq_parallel`, for
    a model built with use_ring_attention); lm_head and softmax cut on
    the vocabulary."""
    sq = ("seq",) if seq_parallel else ()
    act3 = (("data",), sq, ())           # (batch, seq, features)
    hid3 = (("data",), sq, ("model",))   # feature dim cut over model
    views: Dict[str, ShardingView] = {}
    for i in range(cfg.layers):
        views[f"l{i}_attn"] = ShardingView(
            output_specs=(act3,),
            weight_specs={
                "wq": ((), ("model",), ()),
                "wk": ((), ("model",), ()),
                "wv": ((), ("model",), ()),
                "wo": (("model",), (), ()),
            },
            input_specs=(act3,) * 3,
        )
        views[f"l{i}_gate"] = ShardingView(
            (hid3,), {"kernel": ((), ("model",))}, input_specs=(act3,))
        views[f"l{i}_up"] = ShardingView(
            (hid3,), {"kernel": ((), ("model",))}, input_specs=(act3,))
        views[f"l{i}_silu"] = ShardingView((hid3,))
        views[f"l{i}_gxu"] = ShardingView((hid3,))
        views[f"l{i}_down"] = ShardingView(
            (act3,), {"kernel": (("model",), ())}, input_specs=(hid3,))
    views["lm_head"] = ShardingView(
        (hid3,), {"kernel": ((), ("model",))}, input_specs=(act3,))
    views["softmax"] = ShardingView((hid3,))
    views["tok_emb"] = ShardingView(
        output_specs=(act3,), weight_specs={"kernel": ((), ("model",))})
    return views


def llama_pp_strategy(cfg: LlamaConfig):
    """The reference's pipeline strategy shards the PIPELINE composite's
    stacked layer dim over a `pipe` mesh axis, which spans several
    cards."""
    raise NotImplementedError(
        "llama_pp_strategy needs the `pipe` axis (GPipe stages across "
        "cards), not ported yet (ROADMAP.md, queue 1 item 12)")
