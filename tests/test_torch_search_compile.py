"""The port's search as compile() runs it, held to the JAX package on the
CPU: one-card Ulysses attention against the reference's on its 8-CPU-
device {"seq": 4} mesh, compile(search_budget=8) (the same graph and
strategy, the same first SGD losses from the same weights), strategy
files crossing between the packages, the measured cost model's cache keys
and its failures, the weights a rewrite carries, the timed playoff over a
ring candidate, and the CLI's search flags. Inputs are numpy arrays from a
seed; weights cross with runtime.weights.params_from_numpy."""

import json
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.ffconst import MetricsType as JMetricsType  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu.parallel import sharding as jsharding  # noqa: E402
from flexflow_tpu.parallel.ring import (  # noqa: E402
    ulysses_dot_product_attention as julysses,
)
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu.search import measured as jmeasured  # noqa: E402
from flexflow_tpu.search import space as jspace  # noqa: E402
from flexflow_tpu.search.machine_model import (  # noqa: E402
    TPUMachineModel as JTPUMachineModel,
)
import flexflow_tpu_torch  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    DataType,
    FFConfig,
    FFModel,
    LossType,
    MetricsType,
    OpType,
    SGDOptimizer,
)
from flexflow_tpu_torch import __main__ as driver  # noqa: E402
from flexflow_tpu_torch.model import carry_params  # noqa: E402
from flexflow_tpu_torch.models import llama  # noqa: E402
from flexflow_tpu_torch.ops import registry  # noqa: E402
from flexflow_tpu_torch.parallel import ring, sharding  # noqa: E402
from flexflow_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.search import measured, space  # noqa: E402
from flexflow_tpu_torch.search import xfer_engine as xe  # noqa: E402
from flexflow_tpu_torch.search.machine_model import (  # noqa: E402
    TPUMachineModel,
)

# fp32 on the CPU, same inputs: the order of the softmax's sums
ATTN_TOL = 1e-4
# three SGD steps of a tiny fp32 model (tests/test_torch_training.py)
LOSS_TOL = 1e-5
TINY = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2,
            hidden=128, rope_theta=10000.0)


# ---------------------------------------------------------------------------
# Ulysses on one card


def _jax_ulysses(q, k, v, w, causal):
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "seq"))

    def loss(q, k, v):
        with mesh:
            out = julysses(q, k, v, mesh=mesh, causal=causal, scale=0.3)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, out), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(a) for a in g]


@pytest.mark.parametrize("H,Hkv,causal", [(4, 4, True), (8, 2, True),
                                          (4, 2, False), (2, 2, True)])
def test_one_card_ulysses_matches_the_reference(H, Hkv, causal):
    """Forward and q/k/v gradients of Ulysses over {"seq": 4}: the port's
    one process (the exchanges cancel: full attention; GQA kv repeated
    where the plan says; H 2 does not split 4 ways and takes the ring, as
    the reference falls back) against the reference on four CPU devices."""
    rs = np.random.RandomState(H * 10 + Hkv)
    B, S, D = 2, 128, 8
    q = rs.standard_normal((B, S, H, D)).astype(np.float32)
    k = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    w = rs.standard_normal((B, S, H, D)).astype(np.float32)
    jout, jg = _jax_ulysses(q, k, v, w, causal)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ring.ulysses_dot_product_attention(
        *ts, mesh=make_mesh({"data": 1, "seq": 4}), causal=causal,
        scale=0.3)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    for name, t, want in zip("qkv", ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=ATTN_TOL,
                                   rtol=ATTN_TOL, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# compile(search_budget=8)


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


@pytest.fixture(scope="module")
def searched_pair(tmp_path_factory):
    """A tiny fp32 Llama compiled with search_budget=8 by each package on
    one device (the reference's mesh of one CPU device), both pricing
    v5e, each exporting its strategy; the port takes the reference's
    initial weights."""
    d = tmp_path_factory.mktemp("search")
    machine = d / "v5e.json"
    machine.write_text('{"chip": "v5e", "num_chips": 1}')
    kw = dict(batch_size=2, seed=3, search_budget=8,
              machine_model_file=str(machine))
    jff = JFFModel(JFFConfig(num_devices=1,
                             export_strategy_file=str(d / "j.json"), **kw))
    jllama.build_llama(jff, jllama.LlamaConfig(**TINY), batch_size=2,
                       seq_len=16, dtype=JDataType.FLOAT)
    jff.compile(optimizer=jopt.SGDOptimizer(lr=0.5),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[JMetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    tff = FFModel(FFConfig(device="cpu", export_strategy_file=str(
        d / "t.json"), export_strategy_computation_graph_file=str(
        d / "t.dot"), include_costs_dot_graph=True, **kw))
    llama.build_llama(tff, llama.LlamaConfig(**TINY), batch_size=2,
                      seq_len=16, dtype=DataType.FLOAT)
    tff.compile(optimizer=SGDOptimizer(lr=0.5),
                metrics=[MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
                params=params_from_numpy(*map(_np_tree, jff._params),
                                         device="cpu"))
    return jff, tff, d


def test_compile_search_matches_the_reference(searched_pair):
    """The same searched graph (the search rewrites it: fewer nodes) and
    strategy, node for node, and the same first three SGD losses from the
    same weights."""
    jff, tff, _ = searched_pair
    assert tff.graph.structure_hash() == jff.graph.structure_hash()
    assert len(tff.graph) < 25  # the unrewritten tiny Llama has 25
    assert tff.search_stats["winner_rules"] == \
        jff.search_stats["winner_rules"]
    for jn, tn in zip(jff.graph.topo_order(), tff.graph.topo_order()):
        assert tn.stable_key() == jn.stable_key()
        assert sharding.view_to_json(tn.sharding) == \
            jsharding.view_to_json(jn.sharding)
    rs = np.random.RandomState(0)
    for step in range(3):
        x = rs.randint(0, 128, (2, 16)).astype(np.int32)
        y = rs.randint(0, 128, (2, 16)).astype(np.int32)
        jl = jff.fit(x, y, verbose=False).sparse_cce_loss
        tl = tff.fit(x, y, verbose=False).sparse_cce_loss
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=f"step {step}")


def test_strategy_files_cross_between_the_packages(searched_pair):
    """Each package's exported strategy imports into the other (checked
    against the graph by the consistency pass) and gives its node
    shardings; the port's dot export carries the modeled ms."""
    jff, tff, d = searched_pair
    assert json.loads((d / "t.json").read_text()) == json.loads(
        (d / "j.json").read_text())
    assert "ms}" in (d / "t.dot").read_text()
    ff = FFModel(FFConfig(batch_size=2, device="cpu",
                          import_strategy_file=str(d / "j.json")))
    llama.build_llama(ff, llama.LlamaConfig(**TINY), batch_size=2,
                      seq_len=16, dtype=DataType.FLOAT)
    # the searched strategy names the rewritten graph's nodes: import it
    # into that graph
    ff.graph = tff.graph.copy()
    for n in ff.graph.nodes:
        n.sharding = None
    ff.compile()
    assert {n.name: sharding.view_to_json(n.sharding)
            for n in ff.graph.nodes if n.sharding} == json.loads(
        (d / "j.json").read_text())
    jf = JFFModel(JFFConfig(batch_size=2, num_devices=1,
                            import_strategy_file=str(d / "t.json")))
    jf.graph = jff.graph.copy()
    for n in jf.graph.nodes:
        n.sharding = None
    jf.compile()
    assert {n.name: jsharding.view_to_json(n.sharding)
            for n in jf.graph.nodes if n.sharding} == json.loads(
        (d / "t.json").read_text())
    bad = d / "bad.json"
    bad.write_text(json.dumps({"no_such_node": {"outputs": [[["data"]]],
                                                "weights": {}}}))
    ff2 = FFModel(FFConfig(batch_size=2, device="cpu",
                           import_strategy_file=str(bad)))
    llama.build_llama(ff2, llama.LlamaConfig(**TINY), batch_size=2,
                      seq_len=16)
    with pytest.raises(ValueError, match="stale-strategy"):
        ff2.compile()


# ---------------------------------------------------------------------------
# the measured cost model


def _llama_graphs():
    jff = JFFModel(JFFConfig(batch_size=8, num_devices=1))
    jllama.build_llama(jff, jllama.LlamaConfig(**TINY), batch_size=8,
                       seq_len=32)
    jff.graph.infer_shapes()
    tff = FFModel(FFConfig(batch_size=8, device="cpu"))
    llama.build_llama(tff, llama.LlamaConfig(**TINY), batch_size=8,
                      seq_len=32)
    tff.graph.infer_shapes()
    return jff.graph, tff.graph


def test_measured_cache_keys_equal_the_reference():
    """The strict cache key of every op shard, under DP on {"data": 2,
    "model": 4}, is the reference's, so a measure_cache_file written by
    either package is read by the other."""
    jg, tg = _llama_graphs()
    axes = {"data": 2, "model": 4}
    jc = jmeasured.MeasuredCostModel(JTPUMachineModel.make("v5e", 8), axes)
    tc = measured.MeasuredCostModel(TPUMachineModel.make("v5e", 8), axes,
                                    device="cpu")
    js = jspace.default_dp_strategy(jg, axes)
    ts = space.default_dp_strategy(tg, axes)
    for jn, tn in zip(jg.topo_order(), tg.topo_order()):
        jk = jc._key(jn, js.get(jn.name), *jc._shard_inputs(
            jg, jn, js.get(jn.name)))
        tk = tc._key(tn, ts.get(tn.name), *tc._shard_inputs(
            tg, tn, ts.get(tn.name)))
        assert tk == jk


def test_measured_failures_raise_and_refusals_do_not(monkeypatch):
    """Op shards are timed through the port's lowerings on the device
    asked for; calibrate fits mxu_efficiency into (0, 1]. A lowering that
    raises RuntimeError (a kernel's build or launch) propagates out of
    measure_graph, where the reference's broad except returned None; a
    ValueError (the lowering refuses the shapes) leaves the op
    unmeasured."""
    _, g = _llama_graphs()
    cost = measured.MeasuredCostModel(TPUMachineModel.make("v5e", 1),
                                      {"data": 1}, device="cpu", warmup=1,
                                      repeats=1)
    assert cost.measure_graph(g, {}) == len(g)
    knobs = cost.calibrate(g, {})
    assert 0 < knobs["mxu_efficiency"] <= 1 and knobs["samples"] > 0
    linear = next(n for n in g.nodes if n.op_type == OpType.LINEAR)

    def fail(*a, **k):
        raise RuntimeError("kernel failed to launch")

    def refuse(*a, **k):
        raise ValueError("shape refused")

    monkeypatch.setitem(registry._LOWERINGS, OpType.LINEAR, fail)
    cost._measured.clear()
    with pytest.raises(RuntimeError, match="failed to launch"):
        cost.measure_graph(g, {})
    monkeypatch.setitem(registry._LOWERINGS, OpType.LINEAR, refuse)
    assert cost.measure_node(g, linear, None) is None


def test_measured_search_times_the_rewrites_it_prices():
    """With measure_costs the search times each op shard it prices that
    the up-front sweep did not (a rewrite's fused or merged linear), so
    a rewrite is priced by the card, not by the roofline against
    measured originals; the shards the sweep timed are kept."""
    from flexflow_tpu_torch.search import api

    _, g = _llama_graphs()
    cfg = FFConfig(device="cpu", search_budget=8, measure_costs=True)
    cost = api._cost_model({"data": 1}, cfg)
    cost.warmup, cost.repeats = 1, 1
    api._maybe_measure(cost, g, cfg)
    swept = dict(cost._measured)
    from flexflow_tpu_torch.search.substitution import unity_search

    unity_search(g, cost, budget=2)
    assert set(swept) < set(cost._measured)
    assert all(cost._measured[k] == t for k, t in swept.items())
    assert any('"ActiMode.SILU' in k or "silu" in k.lower()
               for k in set(cost._measured) - set(swept))


def test_sequence_search_offers_a_runner_up():
    """On a deep graph (the sequence path) the search also gives the
    next-best whole graph: the winner with one module's other candidate
    swapped in, a complete graph of one sink that prices no lower. The
    winner itself is the reference's."""
    from flexflow_tpu.search import substitution as jsub
    from flexflow_tpu.search.cost_model import CostModel as JCostModel
    from flexflow_tpu_torch.search import substitution as sub
    from flexflow_tpu_torch.search.cost_model import CostModel, graph_cost

    cfg = dict(TINY, layers=4)
    jff = JFFModel(JFFConfig(batch_size=4, num_devices=1))
    jllama.build_llama(jff, jllama.LlamaConfig(**cfg), seq_len=32)
    jff.graph.infer_shapes()
    ff = FFModel(FFConfig(batch_size=4, device="cpu"))
    llama.build_llama(ff, llama.LlamaConfig(**cfg), seq_len=32)
    ff.graph.infer_shapes()
    assert len(ff.graph) > sub.SEQUENCE_SEARCH_MIN_NODES
    cost = CostModel(TPUMachineModel.make("v5e", 1), {"data": 1})
    runner = []
    g, views, t = sub.sequence_unity_search(ff.graph, cost, budget=2,
                                            runner_up_out=runner)
    jg, _, jt = jsub.sequence_unity_search(
        jff.graph, JCostModel(JTPUMachineModel.make("v5e", 1), {"data": 1}),
        budget=2)
    assert g.structure_hash() == jg.structure_hash() and t == jt
    (rc, rg, rv), = runner
    assert rg.structure_hash() != g.structure_hash()
    assert len(rg.sinks()) == 1 and rc >= t
    rg.infer_shapes()
    assert graph_cost(rg, rv, cost).time == rc


# ---------------------------------------------------------------------------
# weights across rewrites, the playoff, the CLI


def test_merged_linears_carry_their_weights():
    """merge_parallel_linears_3d makes one wide linear of gate and up:
    carry_params gives it their kernels concatenated, and the rewritten
    graph computes what the built one did."""
    ff = FFModel(FFConfig(batch_size=2, device="cpu"))
    x = ff.create_tensor((2, 4, 16), DataType.FLOAT, name="input")
    g = ff.dense(x, 32, use_bias=False, name="gate")
    u = ff.dense(x, 32, use_bias=False, name="up")
    ff.multiply(ff.silu(g, name="silu"), u, name="gxu")
    ff.compile()
    with open(xe.DEFAULT_RULES_PATH) as f:
        rule = next(r for r in json.load(f)
                    if r["name"] == "merge_parallel_linears_3d")
    (merged,) = xe.DeclXfer(rule).apply_all(ff.graph)
    assert any(n.name.endswith("_merged") for n in merged.nodes)
    params = carry_params(ff._params, ff.graph, merged)
    xs = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (2, 4, 16)).astype(np.float32))
    want = ff.executor.forward(*ff._params, xs)
    ff2 = FFModel(FFConfig(batch_size=2, device="cpu"))
    ff2.graph = merged
    ff2.compile(params=params)
    torch.testing.assert_close(ff2.executor.forward(*ff2._params, xs), want)


def test_playoff_times_a_ring_candidate_and_trains():
    """compile() on {"seq": 4} with validate_top_k=2: the pool keeps a
    ring-attention candidate, the playoff times each picked candidate's
    real train step, and the adopted winner trains from the weights of
    the model as built."""
    cfg = FFConfig(batch_size=2, device="cpu", mesh_shape={"seq": 4},
                   search_budget=6, validate_top_k=2)
    built = FFModel(FFConfig(batch_size=2, device="cpu"))
    llama.build_llama(built, llama.LlamaConfig(**TINY), seq_len=64)
    built.compile()
    ff = FFModel(cfg)
    llama.build_llama(ff, llama.LlamaConfig(**TINY), seq_len=64)
    ff.compile(optimizer=SGDOptimizer(lr=0.1), params=built._params,
               metrics=[MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    assert any(n.op_type == OpType.RING_ATTENTION
               for _, g, _ in ff.searched_candidates for n in g.nodes)
    v = ff.strategy_validation
    assert len(v["timed_ms"]) >= 2 and v["timed_ms"] == sorted(
        v["timed_ms"])
    rs = np.random.RandomState(0)
    x = rs.randint(0, 128, (2, 64)).astype(np.int32)
    losses = [ff.fit(x, x, verbose=False).sparse_cce_loss for _ in range(3)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


EXAMPLES = pathlib.Path(flexflow_tpu_torch.__file__).parent / "examples"


def test_cli_budget_runs_the_search(monkeypatch, capsys):
    """`python -m flexflow_tpu_torch --device cpu SCRIPT --budget 4`: the
    search flags reach the script's compile()."""
    import sys

    monkeypatch.setattr(sys, "argv", sys.argv[:])
    monkeypatch.setattr(flexflow_tpu_torch, "_driver_config", None)
    rc = driver.main(["--device", "cpu", str(EXAMPLES / "mnist_mlp.py"),
                      "-b", "256", "-e", "1", "--budget", "4",
                      "--validate-top-k", "2"])
    assert rc == 0
    assert flexflow_tpu_torch.get_driver_config().search_budget == 4
    assert "epoch 0: samples=" in capsys.readouterr().out
