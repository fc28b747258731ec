"""The port's substitution layer held to the JAX package's on the CPU: the
rule corpus byte for byte, every rewrite case of tests/test_xfer_engine.py
and tests/test_search_discovery.py applied to the same graph built by
each package (the same candidates: structure hash and serialized graph,
views included), and the rule sets each mesh enables."""

import json

import pytest

jax = pytest.importorskip("jax")

import flexflow_tpu as J  # noqa: E402
from flexflow_tpu.model import Tensor as JTensor  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu.pcg import serialize as jser  # noqa: E402
from flexflow_tpu.search import substitution as jsub  # noqa: E402
from flexflow_tpu.search import xfer_engine as jxe  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu_torch.model import Tensor  # noqa: E402
from flexflow_tpu_torch.models import llama  # noqa: E402
from flexflow_tpu_torch.pcg import serialize as ser  # noqa: E402
from flexflow_tpu_torch.search import substitution as sub  # noqa: E402
from flexflow_tpu_torch.search import xfer_engine as xe  # noqa: E402


def test_corpus_is_the_reference_corpus_byte_for_byte():
    for name in ("default_rules.json", "active_rules.json"):
        port = open(xe.DEFAULT_RULES_PATH.replace("default_rules.json",
                                                  name), "rb").read()
        ref = open(jxe.DEFAULT_RULES_PATH.replace("default_rules.json",
                                                  name), "rb").read()
        assert port == ref, name


def _rule(mod, name):
    with open(mod.DEFAULT_RULES_PATH) as f:
        return mod.DeclXfer(next(r for r in json.load(f)
                                 if r["name"] == name))


def _model(pkg, batch):
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.FFModel(pkg.FFConfig(batch_size=batch, **kw))


# tests/test_xfer_engine.py's graphs, each a function of the package
def g_linear_gelu(p, ff):
    x = ff.create_tensor((8, 32), p.DataType.FLOAT, name="input")
    t = ff.gelu(ff.dense(x, 64, name="d0"), name="g0")
    ff.softmax(ff.dense(t, 4, name="d1"), name="softmax")


def g_transposes(p, ff, perm2=(0, 2, 1)):
    x = ff.create_tensor((4, 6, 8), p.DataType.FLOAT, name="input")
    t = ff.transpose(ff.transpose(x, (0, 2, 1), name="t1"), perm2, name="t2")
    ff.mean(t, axes=[1, 2], name="mean")


def g_two_linears(p, ff, shared=True):
    x = ff.create_tensor((8, 32), p.DataType.FLOAT, name="input")
    y = x if shared else ff.relu(x, name="r")
    a = ff.dense(x, 16, use_bias=False, name="qa")
    b = ff.dense(y, 48, use_bias=False, name="qb")
    ff.softmax(ff.concat([a, b], axis=1, name="cat"), name="softmax")


def g_convs(p, ff):
    x = ff.create_tensor((2, 16, 16, 16), p.DataType.FLOAT, name="input")
    t = ff.conv2d(x, 256, 3, 3, 1, 1, 1, 1, name="c0")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, name="c1")
    ff.mean(t, axes=[1, 2], name="mean")


def g_llama_ffn(p, ff, mod):
    mod.build_llama(ff, mod.LlamaConfig(vocab_size=512, dim=128, layers=1,
                                        heads=4, kv_heads=4, hidden=512),
                    batch_size=8, seq_len=16)


def g_mlp_chain(p, ff):
    x = ff.create_tensor((8, 256), p.DataType.FLOAT, name="input")
    t = ff.gelu(ff.dense(x, 1024, use_bias=False, name="up"), name="act")
    ff.softmax(ff.dense(t, 256, use_bias=False, name="down"), name="sm")


def g_split_concat(p, ff, swapped=False):
    x = ff.create_tensor((4, 32), p.DataType.FLOAT, name="input")
    a, b = ff.split(x, [16, 16], axis=1, name="sp")
    parts = [b, a] if swapped else [a, b]
    ff.softmax(ff.concat(parts, axis=1, name="cat"), name="sm")


def g_concat_split(p, ff, sizes=(8, 24)):
    x = ff.create_tensor((4, 8), p.DataType.FLOAT, name="ia")
    y = ff.create_tensor((4, 24), p.DataType.FLOAT, name="ib")
    a, b = ff.split(ff.concat([x, y], axis=1, name="cat"), list(sizes),
                    axis=1, name="sp")
    ff.softmax(a, name="sa")
    ff.softmax(b, name="sb")


def g_unary_pair(p, ff, second="gelu"):
    x = ff.create_tensor((4, 16), p.DataType.FLOAT, name="input")
    b = getattr(ff, second)(x, name="g2")
    ff.concat([ff.gelu(x, name="g1"), b], axis=1, name="cat")


def g_transpose_relu(p, ff):
    x = ff.create_tensor((4, 6, 8), p.DataType.FLOAT, name="input")
    t = ff.relu(ff.transpose(x, (0, 2, 1), name="t"), name="r")
    ff.mean(t, axes=[1, 2], name="m")


def g_qkv(p, ff):
    x = ff.create_tensor((8, 64), p.DataType.FLOAT, name="input")
    ff.concat([ff.dense(x, n, use_bias=False, name=nm)
               for n, nm in ((64, "q"), (32, "k"), (32, "v"))],
              axis=1, name="cat")


def g_casts(p, ff, middle="DOUBLE", last="BFLOAT16"):
    x = ff.create_tensor((4, 8), p.DataType.FLOAT, name="input")
    t = ff.cast(x, getattr(p.DataType, middle), name="c1")
    ff.mean(ff.cast(t, getattr(p.DataType, last), name="c2"), axes=[1],
            name="m")


def g_conv_branches(p, ff, stride=1, groups=1):
    x = ff.create_tensor((2, 8, 16, 16), p.DataType.FLOAT, name="input")
    a = ff.conv2d(x, 24, 3, 3, 1, 1, 1, 1, groups=groups, use_bias=False,
                  name="a")
    b = ff.conv2d(x, 40, 3, 3, stride, stride, 1, 1, groups=groups,
                  use_bias=False, name="b")
    if stride == 1:
        ff.concat([a, b], axis=1, name="cat")
    else:
        ff.mean(a, axes=[1, 2, 3], name="ma")
        ff.mean(b, axes=[1, 2, 3], name="mb")


def g_hoist(p, ff):
    x = ff.create_tensor((4, 8), p.DataType.FLOAT, name="ia")
    y = ff.create_tensor((4, 8), p.DataType.FLOAT, name="ib")
    ff.concat([ff.relu(x, name="ra"), ff.relu(y, name="rb")], axis=1,
              name="cat")


def g_concat_concat(p, ff):
    xs = [ff.create_tensor((4, 8), p.DataType.FLOAT, name=f"i{k}")
          for k in range(3)]
    inner = ff.concat(xs[:2], axis=1, name="inner")
    ff.concat([inner, xs[2]], axis=1, name="outer")


def g_bmm(p, ff):
    a = ff.create_tensor((8, 16, 32), p.DataType.FLOAT, name="a")
    b = ff.create_tensor((8, 32, 16), p.DataType.FLOAT, name="b")
    ff.mean(ff.batch_matmul(a, b, name="bmm"), axes=[1, 2], name="mean")


def g_gate_up(p, ff):
    x = ff.create_tensor((4, 16, 64), p.DataType.FLOAT, name="input")
    g = ff.dense(x, 128, use_bias=False, name="gate")
    u = ff.dense(x, 128, use_bias=False, name="up")
    ff.multiply(ff.silu(g, name="silu"), u, name="gxu")


# (case, graph, batch, rule chain): each rule is applied to the first
# candidate of the one before, as the reference tests compose them
CASES = [
    ("fuse_linear_act", g_linear_gelu, 8, ["fuse_linear_gelu"]),
    ("cancel_transposes", g_transposes, 4, ["cancel_transpose_transpose"]),
    ("transposes_not_inverse",
     lambda p, ff: g_transposes(p, ff, (1, 0, 2)), 4,
     ["cancel_transpose_transpose"]),
    ("merge_linears", g_two_linears, 8, ["merge_parallel_linears"]),
    ("merge_different_producers",
     lambda p, ff: g_two_linears(p, ff, shared=False), 8,
     ["merge_parallel_linears"]),
    ("conv_partition", g_convs, 2,
     ["partition_conv2d_combine_model", "partition_conv2d_combine_model"]),
    ("gated_mlp", lambda p, ff: g_llama_ffn(
        p, ff, llama if p is T else jllama), 8, ["gated_mlp_model_3d"]),
    ("megatron_mlp", g_mlp_chain, 8, ["megatron_mlp_model"]),
    ("megatron_mlp_fused", g_mlp_chain, 8,
     ["fuse_linear_gelu", "megatron_mlp_fused_model"]),
    ("cancel_split_concat", g_split_concat, 4, ["cancel_split_concat"]),
    ("split_concat_swapped", lambda p, ff: g_split_concat(p, ff, True), 4,
     ["cancel_split_concat"]),
    ("cancel_concat_split", g_concat_split, 4, ["cancel_concat_split"]),
    ("concat_split_mismatched",
     lambda p, ff: g_concat_split(p, ff, (16, 16)), 4,
     ["cancel_concat_split"]),
    ("cse_unary", g_unary_pair, 4, ["cse_element_unary"]),
    ("cse_unary_different", lambda p, ff: g_unary_pair(p, ff, "relu"), 4,
     ["cse_element_unary"]),
    ("commute_unary_transpose", g_transpose_relu, 4,
     ["commute_unary_before_transpose", "commute_transpose_before_unary"]),
    ("merge_linears_3way", g_qkv, 8, ["merge_parallel_linears_3"]),
    ("collapse_casts", g_casts, 4, ["collapse_cast_cast"]),
    ("narrowing_casts", lambda p, ff: g_casts(p, ff, "BFLOAT16", "FLOAT"),
     4, ["collapse_cast_cast"]),
    ("merge_convs", g_conv_branches, 2, ["merge_parallel_convs"]),
    ("convs_strided", lambda p, ff: g_conv_branches(p, ff, stride=2), 2,
     ["merge_parallel_convs"]),
    ("convs_grouped", lambda p, ff: g_conv_branches(p, ff, groups=2), 2,
     ["merge_parallel_convs"]),
    ("hoist_unary", g_hoist, 4, ["hoist_unary_over_concat"]),
    ("flatten_concats", g_concat_concat, 4, ["flatten_concat_concat"]),
    ("partition_bmm", g_bmm, 4,
     ["partition_bmm_combine_model", "partition_bmm_combine_model"]),
    ("merge_gate_up", g_gate_up, 4, ["merge_parallel_linears_3d"]),
]


def _same_candidates(jcands, tcands):
    assert len(tcands) == len(jcands)
    for jg, tg in zip(jcands, tcands):
        assert tg.structure_hash() == jg.structure_hash()
        assert json.loads(ser.graph_to_json(tg)) == json.loads(
            jser.graph_to_json(jg))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rewrite_matches_the_reference(case):
    """The rule chain of one reference case gives the same candidates in
    both packages at every step (none where the reference finds none)."""
    _, build, batch, chain = case
    jff, tff = _model(J, batch), _model(T, batch)
    build(J, jff)
    build(T, tff)
    jg, tg = jff.graph, tff.graph
    jg.infer_shapes()
    tg.infer_shapes()
    for name in chain:
        jc = _rule(jxe, name).apply_all(jg)
        tc = _rule(xe, name).apply_all(tg)
        _same_candidates(jc, tc)
        if not jc:
            break
        jg, tg = jc[0], tc[0]


def test_load_rules_axis_filter_matches_the_reference():
    for axes in ({"data": 8}, {"data": 2, "model": 4}, {"seq": 4},
                 {"data": 1}):
        assert [r.name for r in xe.load_rules(xe.DEFAULT_RULES_PATH, axes)] \
            == [r.name for r in jxe.load_rules(jxe.DEFAULT_RULES_PATH, axes)]
        assert [x.name for x in sub.default_xfers(axes)] == [
            x.name for x in jsub.default_xfers(axes)]


# tests/test_search_discovery.py's rewrites


def _plain_llama(pkg, mod, layers=2, batch=8, seq=64):
    ff = _model(pkg, batch)
    mod.build_llama(ff, mod.LlamaConfig(vocab_size=128, dim=64,
                                        layers=layers, heads=4, kv_heads=2,
                                        hidden=128, rope_theta=10000.0),
                    seq_len=seq)
    ff.graph.infer_shapes()
    return ff


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_mha_to_ring_rewrite_matches_the_reference(mode):
    axes = {"data": 2, "seq": 4}
    jg = _plain_llama(J, jllama).graph
    tg = _plain_llama(T, llama).graph
    jc = jsub.make_mha_to_ring_attention(axes, mode).apply_all(jg)
    tc = sub.make_mha_to_ring_attention(axes, mode).apply_all(tg)
    assert len(tc) == 2  # one per attention node
    _same_candidates(jc, tc)


def test_blocks_to_pipeline_rewrite_matches_the_reference():
    axes = {"data": 2, "pipe": 2}
    jg = _plain_llama(J, jllama, layers=4).graph
    tg = _plain_llama(T, llama, layers=4).graph
    jc = jsub.make_blocks_to_pipeline(axes).apply_all(jg)
    tc = sub.make_blocks_to_pipeline(axes).apply_all(tg)
    assert len(tc) == 1
    _same_candidates(jc, tc)


def test_decoder_runs_match_the_reference():
    """A residual tapped by an aux head ends a run (the reference's
    test_decoder_run_stops_at_external_tap)."""
    out = []
    for pkg, mod, tensor in ((J, jllama, JTensor), (T, llama, Tensor)):
        ff = _model(pkg, 4)
        mod.build_llama(ff, mod.LlamaConfig(vocab_size=128, dim=64,
                                            layers=4, heads=4, kv_heads=2,
                                            hidden=128, rope_theta=10000.0),
                        seq_len=32)
        tap = next(n for n in ff.graph.nodes if n.name == "l1_res2")
        ff.dense(tensor(tap), 8, name="aux_head")
        ff.graph.infer_shapes()
        s = jsub if pkg is J else sub
        out.append([[n.name for n in r]
                    for r in s._find_decoder_runs(ff.graph)])
    assert out[1] == out[0]
    assert sorted(len(r) // 10 for r in out[1]) == [2, 2]
