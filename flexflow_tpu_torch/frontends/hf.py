"""HuggingFace causal-LM importer (counterpart of
flexflow_tpu/frontends/hf.py).

The architecture is rebuilt from the HF config through the port's own
builders (models/llama.py, models/gpt2.py), so an imported model runs the
port's lowerings and kernels, and every checkpoint tensor is mapped onto
the matching weight. An HF model is duck-typed: its `.config` (model_type,
widths, flags) and its module attributes (`model.embed_tokens`,
`model.layers[i].self_attn.q_proj`, ...; `transformer.wte`,
`transformer.h[i].attn.c_attn`, ...). This module never imports
`transformers`: any object with those attributes imports, a model built
by `transformers` or a stand-in with its attribute names.

Supported: Llama-family causal LMs (q/k/v/o_proj, gate/up/down_proj,
RMSNorm) and GPT-2 (pre-LN, learned positions, fused c_attn, tanh-GELU).
Config flags the import would silently get wrong raise.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from flexflow_tpu_torch.ffconst import DataType


def hf_to_llama_config(hf_cfg):
    """A transformers LlamaConfig(-like) as the port's LlamaConfig.
    Raises on flags the import would get wrong (biases, a non-silu
    activation, a decoupled head_dim, scaled RoPE)."""
    from flexflow_tpu_torch.models.llama import LlamaConfig

    for flag in ("attention_bias", "mlp_bias"):
        if getattr(hf_cfg, flag, False):
            raise ValueError(
                f"unsupported HF config: {flag}=True (bias tensors would "
                "be silently dropped)")
    act = getattr(hf_cfg, "hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise ValueError(f"unsupported HF config: hidden_act={act!r} "
                         "(the Llama MLP is gated silu)")
    hd = getattr(hf_cfg, "head_dim", None)
    if hd not in (None, hf_cfg.hidden_size // hf_cfg.num_attention_heads):
        raise ValueError(
            f"unsupported HF config: head_dim={hd} decoupled from "
            f"hidden_size//num_attention_heads")
    scaling = getattr(hf_cfg, "rope_scaling", None)
    if scaling not in (None, {}) and (
            not isinstance(scaling, dict)
            or scaling.get("rope_type", scaling.get("type")) != "default"):
        raise ValueError(
            f"unsupported HF config: rope_scaling={scaling!r} (positions "
            "would be rotated with unscaled theta; Llama-3.1-style scaled "
            "RoPE is not implemented)")
    prf = getattr(hf_cfg, "partial_rotary_factor", 1.0)
    if prf not in (None, 1.0):
        raise ValueError(
            f"unsupported HF config: partial_rotary_factor={prf}")
    return LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        dim=hf_cfg.hidden_size,
        layers=hf_cfg.num_hidden_layers,
        heads=hf_cfg.num_attention_heads,
        kv_heads=getattr(hf_cfg, "num_key_value_heads",
                         hf_cfg.num_attention_heads),
        hidden=hf_cfg.intermediate_size,
        norm_eps=getattr(hf_cfg, "rms_norm_eps", 1e-5),
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
    )


def hf_to_gpt2_config(hf_cfg):
    from flexflow_tpu_torch.models.gpt2 import GPT2Config

    act = getattr(hf_cfg, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        # exact-erf 'gelu' would drift: the lowering is the tanh form
        raise ValueError(f"unsupported GPT-2 activation {act!r} "
                         "(only tanh-approximate GELU is faithful)")
    if getattr(hf_cfg, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("unsupported GPT-2 config: "
                         "scale_attn_by_inverse_layer_idx=True")
    if getattr(hf_cfg, "reorder_and_upcast_attn", False):
        raise ValueError("unsupported GPT-2 config: "
                         "reorder_and_upcast_attn=True")
    if not getattr(hf_cfg, "scale_attn_weights", True):
        raise ValueError("unsupported GPT-2 config: "
                         "scale_attn_weights=False (attention is built "
                         "with the standard 1/sqrt(head_dim) scale)")
    return GPT2Config(
        vocab_size=hf_cfg.vocab_size,
        dim=hf_cfg.n_embd,
        layers=hf_cfg.n_layer,
        heads=hf_cfg.n_head,
        inner=getattr(hf_cfg, "n_inner", None) or 0,
        ln_eps=getattr(hf_cfg, "layer_norm_epsilon", 1e-5),
    )


def import_hf_causal_lm(hf_model, ff, batch_size: Optional[int] = None,
                        seq_len: int = 128,
                        dtype: Optional[DataType] = None):
    """Build the port's graph for `hf_model` (a Llama-family or GPT-2
    *LMHeadModel / *ForCausalLM) into `ff`; returns the port config.
    Then ff.compile(...) and copy_hf_weights(). `dtype` is the builders'
    compute dtype; None keeps the reference's (bf16 Llama, fp32
    GPT-2)."""
    mt = getattr(hf_model.config, "model_type", "llama")
    kw = {} if dtype is None else {"dtype": dtype}
    if mt == "gpt2":
        from flexflow_tpu_torch.models.gpt2 import build_gpt2

        n_pos = getattr(hf_model.config, "n_positions", None)
        if n_pos is not None and seq_len > n_pos:
            raise ValueError(
                f"seq_len={seq_len} exceeds the checkpoint's learned "
                f"position table (n_positions={n_pos})")
        cfg = hf_to_gpt2_config(hf_model.config)
        build_gpt2(ff, cfg, batch_size=batch_size, seq_len=seq_len, **kw)
        return cfg
    from flexflow_tpu_torch.models.llama import build_llama

    cfg = hf_to_llama_config(hf_model.config)
    build_llama(ff, cfg, batch_size=batch_size, seq_len=seq_len, **kw)
    return cfg


def _t(p) -> torch.Tensor:
    return p.detach()


def copy_hf_weights(hf_model, ff) -> int:
    """Push every HF checkpoint tensor into the compiled model (on its
    device, in its leaves' dtypes, with no trip through numpy); returns
    the number of weights copied. nn.Linear stores [out, in]: the dense
    kernel is [in, out], and attention weights are the 3-D [E, H, D] /
    [H, D, E] layouts of the attention lowering. GPT-2's Conv1D already
    stores [in, out]."""
    if getattr(hf_model.config, "model_type", "llama") == "gpt2":
        return _copy_gpt2_weights(hf_model, ff)
    cfg = hf_model.config
    H = cfg.num_attention_heads
    Hkv = getattr(cfg, "num_key_value_heads", H)
    E = cfg.hidden_size
    hd = E // H
    base = hf_model.model  # the LlamaModel inside the *ForCausalLM
    copied = 0

    def put(name, arr, weight_name):
        nonlocal copied
        ff.set_weight(name, arr.contiguous(), weight_name)
        copied += 1

    put("tok_emb", _t(base.embed_tokens.weight), "kernel")
    for i, layer in enumerate(base.layers):
        at = layer.self_attn
        put(f"l{i}_attn", _t(at.q_proj.weight).T.reshape(E, H, hd), "wq")
        put(f"l{i}_attn", _t(at.k_proj.weight).T.reshape(E, Hkv, hd), "wk")
        put(f"l{i}_attn", _t(at.v_proj.weight).T.reshape(E, Hkv, hd), "wv")
        put(f"l{i}_attn", _t(at.o_proj.weight).T.reshape(H, hd, E), "wo")
        put(f"l{i}_attn_norm", _t(layer.input_layernorm.weight), "scale")
        put(f"l{i}_mlp_norm", _t(layer.post_attention_layernorm.weight),
            "scale")
        put(f"l{i}_gate", _t(layer.mlp.gate_proj.weight).T, "kernel")
        put(f"l{i}_up", _t(layer.mlp.up_proj.weight).T, "kernel")
        put(f"l{i}_down", _t(layer.mlp.down_proj.weight).T, "kernel")
    put("final_norm", _t(base.norm.weight), "scale")
    if getattr(cfg, "tie_word_embeddings", False):
        _warn_untied()
        head = base.embed_tokens.weight
    else:
        head = hf_model.lm_head.weight
    put("lm_head", _t(head).T, "kernel")
    return copied


def _warn_untied():
    warnings.warn(
        "tie_word_embeddings checkpoint: the embedding is COPIED into "
        "a separate lm_head parameter; fine-tuning trains them "
        "independently (the tie is not preserved)")


def _copy_gpt2_weights(hf_model, ff) -> int:
    cfg = hf_model.config
    H, E = cfg.n_head, cfg.n_embd
    hd = E // H
    base = hf_model.transformer
    wpe_node = next((n for n in ff.graph.nodes if n.name == "wpe"), None)
    if wpe_node is None:
        raise ValueError(
            "graph has no 'wpe' node; was the model built by "
            "import_hf_causal_lm/build_gpt2 before compile?")
    seq_len = wpe_node.outputs[0].dims[0].size
    copied = 0

    def put(name, arr, weight_name):
        nonlocal copied
        ff.set_weight(name, arr.contiguous(), weight_name)
        copied += 1

    put("wte", _t(base.wte.weight), "kernel")
    put("wpe", _t(base.wpe.weight)[:seq_len], "weight")
    for i, blk in enumerate(base.h):
        put(f"h{i}_ln1", _t(blk.ln_1.weight), "scale")
        put(f"h{i}_ln1", _t(blk.ln_1.bias), "bias")
        # fused c_attn (Conv1D [E, 3E]): columns are q|k|v
        w = _t(blk.attn.c_attn.weight)
        bqkv = _t(blk.attn.c_attn.bias)
        for j, nm in enumerate("qkv"):
            put(f"h{i}_attn", w[:, j * E:(j + 1) * E].reshape(E, H, hd),
                f"w{nm}")
            put(f"h{i}_attn", bqkv[j * E:(j + 1) * E].reshape(H, hd),
                f"b{nm}")
        put(f"h{i}_attn", _t(blk.attn.c_proj.weight).reshape(H, hd, E),
            "wo")
        put(f"h{i}_attn", _t(blk.attn.c_proj.bias), "bo")
        put(f"h{i}_ln2", _t(blk.ln_2.weight), "scale")
        put(f"h{i}_ln2", _t(blk.ln_2.bias), "bias")
        put(f"h{i}_fc", _t(blk.mlp.c_fc.weight), "kernel")
        put(f"h{i}_fc", _t(blk.mlp.c_fc.bias), "bias")
        put(f"h{i}_proj", _t(blk.mlp.c_proj.weight), "kernel")
        put(f"h{i}_proj", _t(blk.mlp.c_proj.bias), "bias")
    put("ln_f", _t(base.ln_f.weight), "scale")
    put("ln_f", _t(base.ln_f.bias), "bias")
    if getattr(cfg, "tie_word_embeddings", True):
        _warn_untied()  # stock GPT-2 ties lm_head to wte
        head = base.wte.weight
    else:
        head = hf_model.lm_head.weight
    put("lm_head", _t(head).T, "kernel")
    return copied
