"""Mixtral-style MoE decoder builder (counterpart of
flexflow_tpu/models/mixtral.py): Llama's attention block with each MLP
replaced by a router and the fused EXPERTS bank (top-2 of 8, capacity
factor 1.25, the Switch load-balance term), through the FFModel layer API
in the reference's order, so both packages build the same PCG. The
composite `FFModel.moe` (top_k -> group_by -> dense -> aggregate) and
AGGREGATE_SPEC's per-slot head are built by `build_moe_classifier` and
`build_moe_spec_classifier`. The expert-parallel strategy needs an
`expert` mesh axis across cards and is not ported yet.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


@dataclasses.dataclass
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    hidden: int = 14336
    n_experts: int = 8
    top_k: int = 2
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    capacity_factor: float = 1.25
    lambda_bal: float = 1e-2

    @staticmethod
    def mixtral_8x7b() -> "MixtralConfig":
        return MixtralConfig()

    @staticmethod
    def tiny(vocab: int = 512) -> "MixtralConfig":
        return MixtralConfig(vocab_size=vocab, dim=64, layers=2, heads=4,
                             kv_heads=2, hidden=128, n_experts=4, top_k=2,
                             rope_theta=10000.0)


def build_mixtral(ff: FFModel, cfg: MixtralConfig, batch_size: int = None,
                  seq_len: int = 2048,
                  dtype: DataType = DataType.BFLOAT16) -> Tensor:
    b = batch_size or ff.config.batch_size
    ids = ff.create_tensor((b, seq_len), DataType.INT32, name="input_ids")
    h = ff.embedding(ids, cfg.vocab_size, cfg.dim, dtype=dtype,
                     name="tok_emb")
    for i in range(cfg.layers):
        a = ff.rms_norm(h, eps=cfg.norm_eps, name=f"l{i}_attn_norm")
        a = ff.multihead_attention(
            a, a, a, cfg.dim, cfg.heads, bias=False, causal=True,
            kv_heads=cfg.kv_heads, rope=True, rope_theta=cfg.rope_theta,
            name=f"l{i}_attn")
        h = ff.add(h, a, name=f"l{i}_res1")
        m = ff.rms_norm(h, eps=cfg.norm_eps, name=f"l{i}_moe_norm")
        gate = ff.dense(m, cfg.n_experts, use_bias=False,
                        name=f"l{i}_router")
        e = ff.experts(
            m, gate, cfg.n_experts, cfg.top_k, cfg.hidden, cfg.dim,
            alpha=cfg.capacity_factor, activation=ActiMode.SILU,
            lambda_bal=cfg.lambda_bal, name=f"l{i}_experts")
        h = ff.add(h, e, name=f"l{i}_res2")
    h = ff.rms_norm(h, eps=cfg.norm_eps, name="final_norm")
    logits = ff.dense(h, cfg.vocab_size, use_bias=False, name="lm_head")
    return ff.softmax(logits, name="softmax")


def mixtral_ep_strategy(cfg: MixtralConfig):
    """The reference's expert-parallel strategy shards the stacked expert
    weights over an `expert` mesh axis, which spans several cards."""
    raise NotImplementedError(
        "mixtral_ep_strategy needs an `expert` mesh axis across cards, not "
        "ported yet (ROADMAP.md, queue 1 item 12)")


def build_moe_classifier(ff: FFModel, input_dim: int, num_classes: int,
                         num_exp: int = 4, num_select: int = 2,
                         hidden: int = 64, batch_size: int = None) -> Tensor:
    """The composite MoE classifier: gate -> top_k -> group_by -> experts
    -> aggregate -> head."""
    b = batch_size or ff.config.batch_size
    x = ff.create_tensor((b, input_dim), DataType.FLOAT, name="input")
    t = ff.moe(x, num_exp, num_select, hidden, alpha=2.0, lambda_bal=0.04,
               name="moe")
    t = ff.dense(t, num_classes, name="head")
    return ff.softmax(t, name="softmax")


def build_moe_spec_classifier(ff: FFModel, input_dim: int, num_classes: int,
                              num_exp: int = 4, num_select: int = 2,
                              hidden: int = 64,
                              batch_size: int = None) -> Tensor:
    """The speculative MoE head: every selected expert's output is its own
    row, (b * k, classes) logits, and the loss sees each label k times
    (Executor.label_repeats)."""
    b = batch_size or ff.config.batch_size
    x = ff.create_tensor((b, input_dim), DataType.FLOAT, name="input")
    gate_preds = ff.dense(x, num_exp, name="spec_gate")
    gate_sm = ff.softmax(gate_preds, name="spec_gate_sm")
    topk_values, topk_assign = ff.top_k(gate_sm, num_select)
    grouped = ff.group_by(x, topk_assign, num_exp, 2.0)
    expert_outs = [ff.dense(g, hidden, ActiMode.RELU, name=f"spec_expert{i}")
                   for i, g in enumerate(grouped)]
    t = ff.aggregate_spec(
        [topk_values, topk_assign, topk_assign, gate_sm] + expert_outs,
        num_exp, name="agg_spec")
    t = ff.dense(t, num_classes, name="spec_head")
    return ff.softmax(t, name="softmax")
