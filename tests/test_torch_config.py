"""The rest of the port's single-device training surface held to the JAX
reference on the CPU: every FFConfig field and every from_args flag
(ported, or refused with the ROADMAP item that ports it), the
remat="hidden" groups node for node with their gradients, and
get_weight / set_weight."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import ActiMode as JActiMode  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from flexflow_tpu.models.gpt2 import build_gpt2 as jbuild_gpt2  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    ActiMode,
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
)
from flexflow_tpu_torch.config import REFUSED  # noqa: E402
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402

# fp32 on the CPU, same weights: summation order only
TOL = 1e-5


def _value(v):
    """A field's value comparable across packages (enums by value)."""
    return getattr(v, "value", v)


def _other_value(name, default):
    """A value of the field `name` other than its default."""
    special = {"mesh_shape": {"seq": 2}, "compute_dtype": "bfloat16",
               "param_sync": "sharded", "comp_mode": "inference",
               "transfer_guard": "log", "remat": "hidden",
               "num_devices": 1, "seq_length": 8}
    if name in special:
        return special[name]
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 2
    return "x"


_FIELDS = [f for f in dataclasses.fields(JFFConfig) if f.name != "_devices"]


def test_every_reference_field_has_its_default_in_the_port():
    port = {f.name: f for f in dataclasses.fields(FFConfig)}
    for f in _FIELDS:
        assert f.name in port, f.name
        assert _value(port[f.name].default) == _value(f.default), f.name


@pytest.mark.parametrize("name", [f.name for f in _FIELDS] + ["num_devices=2"])
def test_every_reference_field_is_ported_or_refused_by_item(name):
    """Set away from its default, each field of the reference's FFConfig
    either takes the value (and keeps it, as the reference does) or
    raises NotImplementedError naming the queue 1 item that ports it;
    never a TypeError. num_devices is the world size of the process
    group (one process per card): 2 in this one process raises
    ValueError naming both."""
    if name == "num_devices=2":
        with pytest.raises(ValueError, match="world size is 1"):
            FFConfig(device="cpu", num_devices=2)
        return
    else:
        default = next(f.default for f in _FIELDS if f.name == name)
        value = _other_value(name, default)
        item = REFUSED.get(name)
    if item is None:
        cfg = FFConfig(device="cpu", **{name: value})
        assert _value(getattr(cfg, name)) == value
        jcfg = JFFConfig(**{name: value})
        assert _value(getattr(jcfg, name)) == value
    else:
        with pytest.raises(NotImplementedError,
                           match=rf"ROADMAP.md, queue 1 item {item}\)"):
            FFConfig(device="cpu", **{name: value})


# every flag the reference's FFConfig.from_args parses, with a value
# where it takes one
_FLAGS = [
    ["-b", "16"], ["--batch-size", "16"], ["-e", "3"], ["--epochs", "3"],
    ["--seed", "9"], ["--checkpoint-dir", "ck"], ["--checkpoint-every", "5"],
    ["--devices", "1"], ["-ll:gpu", "1"], ["-ll:tpu", "2"],
    ["--mesh", "data=1,seq=2"], ["--budget", "4"], ["--search-budget", "4"],
    ["--validate-top-k", "2"], ["--alpha", "1.2"], ["--search-alpha", "1.2"],
    ["--only-data-parallel"], ["--search"], ["--enable-parameter-parallel"],
    ["--enable-attribute-parallel"], ["--enable-submesh"], ["--simulator"],
    ["--no-simulator"], ["--profiler-trace", "tr"],
    ["--transfer-guard", "disallow"], ["--memory-search"],
    ["--search-num-devices", "8"], ["--machine-model-file", "m.json"],
    ["--import-strategy", "s.json"], ["--import", "s.json"],
    ["--export-strategy", "s.json"], ["--export", "s.json"],
    ["--compgraph", "g.dot"], ["--include-costs-dot-graph"],
    ["--profiling"], ["--fusion"], ["--inference"],
]


@pytest.mark.parametrize("argv", _FLAGS, ids=lambda a: a[0])
def test_from_args_maps_every_flag_to_the_reference_field(argv):
    """Each flag sets the field the reference's parser sets, to the same
    value, or is refused as that field is (unknown flags, here the port's
    own --device, are ignored by the reference)."""
    argv = argv + ["--device", "cpu", "--not-a-flag"]
    ref = JFFConfig.from_args(argv)
    changed = {f.name: _value(getattr(ref, f.name)) for f in _FIELDS
               if _value(getattr(ref, f.name)) != _value(f.default)}
    items = {REFUSED[n] for n in changed if n in REFUSED}
    if changed.get("num_devices", 1) > 1:
        # num_devices is the world size: more than this one process
        with pytest.raises(ValueError, match="world size is 1"):
            FFConfig.from_args(argv)
        return
    if items:
        with pytest.raises(NotImplementedError) as e:
            FFConfig.from_args(argv)
        assert any(f"queue 1 item {i})" in str(e.value) for i in items)
        return
    cfg = FFConfig.from_args(argv)
    assert cfg.device == "cpu"
    for f in _FIELDS:
        assert _value(getattr(cfg, f.name)) == _value(
            getattr(ref, f.name)), f.name


# ---------------------------------------------------------------------------
# remat="hidden"


def _mlp_chain(ff, act_relu, act_none):
    """input (4, 16) -> pattern B (expanding dense with ReLU -> dense) ->
    pattern C (expanding dense -> silu -> dense) -> a dense head ->
    softmax."""
    x = ff.create_tensor((4, 16), name="input")
    h = ff.dense(x, 64, act_relu, name="b_up")
    h = ff.dense(h, 16, name="b_down")
    h = ff.dense(h, 48, act_none, name="c_up")
    h = ff.silu(h, name="c_act")
    h = ff.dense(h, 16, name="c_down")
    h = ff.dense(h, 5, name="head")
    return ff.softmax(h, name="softmax")


_LLAMA = dict(vocab_size=64, dim=32, layers=2, heads=4, kv_heads=2,
              hidden=64, rope_theta=10000.0)


def _models(kind, remat):
    """(JAX model, port model with the JAX weights), fp32, compiled with
    Adam under `remat`."""
    jff = JFFModel(JFFConfig(batch_size=2, seed=4, num_devices=1,
                             remat=remat))
    tff = FFModel(FFConfig(batch_size=2, seed=4, device="cpu", remat=remat))
    if kind == "llama":
        jbuild_llama(jff, JLlamaConfig(**_LLAMA), seq_len=8,
                     dtype=JDataType.FLOAT)
        build_llama(tff, LlamaConfig(**_LLAMA), seq_len=8,
                    dtype=DataType.FLOAT)
    elif kind == "gpt2":
        jbuild_gpt2(jff, JGPT2Config.tiny(), seq_len=8,
                    dtype=JDataType.FLOAT)
        build_gpt2(tff, GPT2Config.tiny(), seq_len=8, dtype=DataType.FLOAT)
    else:
        _mlp_chain(jff, JActiMode.RELU, JActiMode.NONE)
        _mlp_chain(tff, ActiMode.RELU, ActiMode.NONE)
    jff.compile(optimizer=jopt.AdamOptimizer(lr=1e-3))
    tff.compile(optimizer=AdamOptimizer(lr=1e-3), params=params_from_numpy(
        *({k: {n: np.array(a) for n, a in w.items()} for k, w in t.items()}
          for t in jff._params), device="cpu"))
    return jff, tff


def _inputs(kind, seed):
    rs = np.random.RandomState(seed)
    if kind == "mlp":
        return (rs.randn(4, 16).astype(np.float32),
                rs.randint(0, 5, 4).astype(np.int32))
    vocab = 256 if kind == "gpt2" else 64
    x = rs.randint(0, vocab, (2, 8)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _names(graph, keys):
    by_guid = {n.guid: n.name for n in graph.nodes}
    return tuple((by_guid[g], i) for g, i in keys)


@pytest.mark.parametrize("kind", ["llama", "gpt2", "mlp"])
def test_hidden_remat_groups_match_jax_and_train_alike(kind):
    """The groups remat="hidden" recomputes are the reference's, node for
    node (members, output and external inputs by name): Llama's SwiGLU
    diamonds (pattern A), GPT-2's GELU MLPs (B) and an MLP chain of
    patterns B and C, each with its contracting Linear. Under "hidden"
    the loss and every gradient equal those under "none" in fp32."""
    jff, tff = _models(kind, "hidden")
    jgroups = {tuple(m.name for m in mem): (_names(jff.graph, [out]),
                                             _names(jff.graph, ext))
               for mem, _, out, ext in jff.executor._remat_groups.values()}
    tgroups = {tuple(m.name for m in mem): (_names(tff.graph, [out]),
                                             _names(tff.graph, ext))
               for mem, out, ext in tff.executor.remat_groups.values()}
    assert tgroups == jgroups
    assert len(tgroups) == {"llama": 2, "gpt2": 2, "mlp": 2}[kind]
    x, y = _inputs(kind, 1)
    tr, ntr = tff._params
    loss_h, _, g_h = tff.executor.loss_and_grads(
        tr, ntr, torch.from_numpy(y), torch.from_numpy(x))
    _, plain = _models(kind, "none")
    loss_n, _, g_n = plain.executor.loss_and_grads(
        *plain._params, torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_allclose(float(loss_h), float(loss_n), atol=TOL,
                               rtol=TOL)
    for k, w in g_n.items():
        for n, g in w.items():
            np.testing.assert_allclose(g_h[k][n].numpy(), g.numpy(),
                                       atol=TOL, rtol=TOL, err_msg=(k, n))
    # a fit under "hidden" trains
    pm = tff.fit(*_inputs(kind, 2), verbose=False)
    assert pm.train_all == x.shape[0]


# ---------------------------------------------------------------------------
# get_weight / set_weight


def test_get_set_weight_round_trip_and_predict_like_jax():
    """get_weight gives each weight as numpy (by node name or Tensor);
    set_weight casts the value to the stored leaf's dtype and device;
    predict after the same set_weight in both packages agrees."""
    jff, tff = _models("llama", "none")
    x, _ = _inputs("llama", 3)
    for name, wn in (("lm_head", "kernel"), ("l0_attn", "wq"),
                     ("final_norm", "scale")):
        got = tff.get_weight(name, wn)
        np.testing.assert_array_equal(got, np.asarray(jff.get_weight(name,
                                                                     wn)))
        new = np.random.RandomState(5).randn(*got.shape).astype(np.float64)
        tff.set_weight(name, new, wn)
        jff.set_weight(name, new, wn)
        leaf = tff.get_weight(name, wn)
        assert leaf.dtype == np.float32
        np.testing.assert_array_equal(leaf, new.astype(np.float32))
    np.testing.assert_allclose(tff.predict(x), jff.predict(x), atol=TOL,
                               rtol=TOL)
    with pytest.raises(KeyError):
        tff.get_weight("no_such_node")
    with pytest.raises(ValueError):
        tff.set_weight("lm_head", np.zeros((2, 2)))


def test_set_weight_keeps_a_bf16_leaf_bf16():
    ff = FFModel(FFConfig(batch_size=1, seed=1, device="cpu"))
    build_llama(ff, LlamaConfig(**_LLAMA), seq_len=4)
    ff.compile()
    kernel = ff.get_weight("lm_head")
    assert kernel.dtype == np.float32
    ff.set_weight("lm_head", kernel + 1.0)
    tree = ff._params[0]
    (key,) = [k for k in tree if k.startswith("lm_head_")]
    assert tree[key]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("donate", [True, False])
def test_donate_buffers_false_leaves_the_trees_given_intact(donate):
    """FFConfig.donate_buffers=False: a train step updates copies and the
    trees passed in keep their values (the reference's undonated jit);
    True updates them in place. Both steps give the same weights."""
    ff = FFModel(FFConfig(batch_size=2, seed=4, device="cpu",
                          donate_buffers=donate))
    build_llama(ff, LlamaConfig(**_LLAMA), seq_len=8, dtype=DataType.FLOAT)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    tr, ntr = ff._params
    before = {k: {n: t.clone() for n, t in w.items()} for k, w in tr.items()}
    x, y = _inputs("llama", 6)
    new_tr, _, _, _ = ff.executor.train_step(
        tr, ntr, ff._opt_state, torch.from_numpy(y), torch.from_numpy(x))
    key = next(iter(before))
    name = next(iter(before[key]))
    moved = not torch.equal(new_tr[key][name], before[key][name])
    assert moved
    assert torch.equal(tr[key][name], before[key][name]) is (not donate)
