"""Stand-ins for HuggingFace causal LMs, for machines without
`transformers`.

`llama_standin` and `gpt2_standin` build nn.Module trees with the
attribute names of transformers' LlamaForCausalLM and GPT2LMHeadModel
(`model.embed_tokens`, `model.layers[i].self_attn.q_proj`, ...;
`transformer.wte`, `transformer.h[i].attn.c_attn`, ...) and the weight
layouts they store (nn.Linear [out, in], GPT-2's Conv1D [in, out]), with a
`config` namespace of the HF field names. Their weights are drawn from a
seed on the given device. They have no forward: frontends/hf.py reads only
the config and the weights, so a stand-in imports as the model it stands
for would, at any width.
"""

from __future__ import annotations

import types
from typing import Optional

import torch
from torch import nn


def _draw(module: nn.Module, seed: int):
    """Every parameter from its own generator (seed, index): matrices and
    biases N(0, 0.02), norm scales 1 + N(0, 0.02)."""
    with torch.no_grad():
        for i, (name, p) in enumerate(module.named_parameters()):
            gen = torch.Generator(device=p.device)
            gen.manual_seed(seed * 1_000_003 + i)
            x = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            x.normal_(0.0, 0.02, generator=gen)
            if ("norm" in name or ".ln_" in name) \
                    and name.endswith("weight"):
                x += 1.0
            p.copy_(x)


def _linear(i: int, o: int, bias: bool, **kw) -> nn.Linear:
    return nn.Linear(i, o, bias=bias, **kw)


class _Conv1D(nn.Module):
    """GPT-2's Conv1D: weight [in, out], bias [out]."""

    def __init__(self, i: int, o: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(i, o, **kw))
        self.bias = nn.Parameter(torch.empty(o, **kw))


class _Norm(nn.Module):
    def __init__(self, n: int, bias: bool, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, **kw))
        if bias:
            self.bias = nn.Parameter(torch.empty(n, **kw))


def llama_standin(*, vocab_size: int, hidden_size: int,
                  intermediate_size: int, num_hidden_layers: int,
                  num_attention_heads: int,
                  num_key_value_heads: Optional[int] = None,
                  rope_theta: float = 10000.0, rms_norm_eps: float = 1e-5,
                  tie_word_embeddings: bool = False, seed: int = 0,
                  device="cpu", dtype=torch.float32) -> nn.Module:
    """A LlamaForCausalLM-shaped module with seeded weights."""
    kv = num_key_value_heads or num_attention_heads
    hd = hidden_size // num_attention_heads
    kw = {"device": device, "dtype": dtype}
    root = nn.Module()
    root.config = types.SimpleNamespace(
        model_type="llama", vocab_size=vocab_size, hidden_size=hidden_size,
        intermediate_size=intermediate_size,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads, num_key_value_heads=kv,
        rope_theta=rope_theta, rms_norm_eps=rms_norm_eps,
        hidden_act="silu", tie_word_embeddings=tie_word_embeddings)
    model = nn.Module()
    model.embed_tokens = nn.Embedding(vocab_size, hidden_size, **kw)
    layers = nn.ModuleList()
    for _ in range(num_hidden_layers):
        layer = nn.Module()
        at = nn.Module()
        at.q_proj = _linear(hidden_size, num_attention_heads * hd, False,
                            **kw)
        at.k_proj = _linear(hidden_size, kv * hd, False, **kw)
        at.v_proj = _linear(hidden_size, kv * hd, False, **kw)
        at.o_proj = _linear(num_attention_heads * hd, hidden_size, False,
                            **kw)
        layer.self_attn = at
        mlp = nn.Module()
        mlp.gate_proj = _linear(hidden_size, intermediate_size, False, **kw)
        mlp.up_proj = _linear(hidden_size, intermediate_size, False, **kw)
        mlp.down_proj = _linear(intermediate_size, hidden_size, False, **kw)
        layer.mlp = mlp
        layer.input_layernorm = _Norm(hidden_size, False, **kw)
        layer.post_attention_layernorm = _Norm(hidden_size, False, **kw)
        layers.append(layer)
    model.layers = layers
    model.norm = _Norm(hidden_size, False, **kw)
    root.model = model
    if not tie_word_embeddings:
        root.lm_head = _linear(hidden_size, vocab_size, False, **kw)
    _draw(root, seed)
    return root


def gpt2_standin(*, vocab_size: int = 50257, n_positions: int = 1024,
                 n_embd: int = 768, n_layer: int = 12, n_head: int = 12,
                 layer_norm_epsilon: float = 1e-5,
                 activation_function: str = "gelu_new", seed: int = 0,
                 device="cpu", dtype=torch.float32) -> nn.Module:
    """A GPT2LMHeadModel-shaped module (tied head) with seeded
    weights."""
    kw = {"device": device, "dtype": dtype}
    root = nn.Module()
    root.config = types.SimpleNamespace(
        model_type="gpt2", vocab_size=vocab_size, n_positions=n_positions,
        n_embd=n_embd, n_layer=n_layer, n_head=n_head, n_inner=None,
        layer_norm_epsilon=layer_norm_epsilon,
        activation_function=activation_function, tie_word_embeddings=True,
        scale_attn_weights=True, scale_attn_by_inverse_layer_idx=False,
        reorder_and_upcast_attn=False)
    tr = nn.Module()
    tr.wte = nn.Embedding(vocab_size, n_embd, **kw)
    tr.wpe = nn.Embedding(n_positions, n_embd, **kw)
    h = nn.ModuleList()
    for _ in range(n_layer):
        blk = nn.Module()
        blk.ln_1 = _Norm(n_embd, True, **kw)
        attn = nn.Module()
        attn.c_attn = _Conv1D(n_embd, 3 * n_embd, **kw)
        attn.c_proj = _Conv1D(n_embd, n_embd, **kw)
        blk.attn = attn
        blk.ln_2 = _Norm(n_embd, True, **kw)
        mlp = nn.Module()
        mlp.c_fc = _Conv1D(n_embd, 4 * n_embd, **kw)
        mlp.c_proj = _Conv1D(4 * n_embd, n_embd, **kw)
        blk.mlp = mlp
        h.append(blk)
    tr.h = h
    tr.ln_f = _Norm(n_embd, True, **kw)
    root.transformer = tr
    _draw(root, seed)
    return root
