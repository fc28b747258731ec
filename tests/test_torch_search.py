"""The port's strategy search held to the JAX package's on the CPU: the
machine models' prices, graph_cost, the winners of every search entry
(MCMC, the view DP, the Unity search flat and by sequence, the memory-λ
search), the native engine built from the port's copy of its source, and
the H100 machine the port prices by default (properties, not parity).
Graphs come from each package's own builders with the same calls; views
cross the packages by their JSON form; every pair is priced on the same
modeled machine."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import native as jnative  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu.parallel import sharding as jsharding  # noqa: E402
from flexflow_tpu.search import cost_model as jcm  # noqa: E402
from flexflow_tpu.search import dp as jdp  # noqa: E402
from flexflow_tpu.search import machine_model as jmm  # noqa: E402
from flexflow_tpu.search import mcmc as jmcmc  # noqa: E402
from flexflow_tpu.search import space as jspace  # noqa: E402
from flexflow_tpu.search import substitution as jsub  # noqa: E402
from flexflow_tpu.search import table as jtable  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch import native  # noqa: E402
from flexflow_tpu_torch.models import llama  # noqa: E402
from flexflow_tpu_torch.parallel import sharding  # noqa: E402
from flexflow_tpu_torch.search import cost_model as cm  # noqa: E402
from flexflow_tpu_torch.search import dp  # noqa: E402
from flexflow_tpu_torch.search import machine_model as mm  # noqa: E402
from flexflow_tpu_torch.search import mcmc  # noqa: E402
from flexflow_tpu_torch.search import space  # noqa: E402
from flexflow_tpu_torch.search import substitution as sub  # noqa: E402
from flexflow_tpu_torch.search import table  # noqa: E402
from flexflow_tpu_torch.search.api import _cost_model  # noqa: E402

# the same formulas on the same numbers: float ops in the same order
PRICE_RTOL = 1e-12
COST_RTOL = 1e-9
TINY = dict(vocab_size=256, dim=64, layers=2, heads=4, kv_heads=2,
            hidden=128, rope_theta=10000.0)


def llama_pair(batch=8, seq=128, **cfg):
    """The same Llama graph built by each package."""
    kw = dict(TINY, **cfg)
    jff = JFFModel(JFFConfig(batch_size=batch, num_devices=1))
    jllama.build_llama(jff, jllama.LlamaConfig(**kw), batch_size=batch,
                       seq_len=seq)
    jff.graph.infer_shapes()
    ff = FFModel(FFConfig(batch_size=batch, device="cpu"))
    llama.build_llama(ff, llama.LlamaConfig(**kw), batch_size=batch,
                      seq_len=seq)
    ff.graph.infer_shapes()
    return jff.graph, ff.graph


def mlp_pair(batch=8, dim=2048, layers=3):
    """tests/test_search.py's big_mlp_model in both packages."""
    out = []
    for FF, Cfg, DT, kw in ((JFFModel, JFFConfig, JDataType, {}),
                            (FFModel, FFConfig, DataType,
                             {"device": "cpu"})):
        ff = FF(Cfg(batch_size=batch, **kw))
        t = ff.create_tensor((batch, dim), DT.FLOAT, name="input")
        for i in range(layers):
            t = ff.dense(t, dim, name=f"dense{i}")
        ff.softmax(t, name="softmax")
        ff.graph.infer_shapes()
        out.append(ff.graph)
    return out


def views_json(strategy, to_json):
    return {k: to_json(v) for k, v in sorted(strategy.items())}


def to_port(strategy):
    return {k: sharding.view_from_json(jsharding.view_to_json(v))
            for k, v in strategy.items()}


def cost_pair(axis_sizes, chip="v5p", n=8):
    return (jcm.CostModel(jmm.TPUMachineModel.make(chip, n), axis_sizes),
            cm.CostModel(mm.TPUMachineModel.make(chip, n), axis_sizes))


def assert_same_strategy(jstrat, tstrat):
    assert views_json(tstrat, sharding.view_to_json) == views_json(
        jstrat, jsharding.view_to_json)


# ---------------------------------------------------------------------------
# the machine models


def _machines():
    for chip in jmm.CHIPS:
        for kw in ({}, {"chips_per_slice": 4}):
            yield (jmm.TPUMachineModel.make(chip, 16, **kw),
                   mm.TPUMachineModel.make(chip, 16, **kw))
    for chip in ("v5p", "v5e"):
        kw = dict(num_chips=16, axis_map={"data": (0, 1), "model": (2,)}
                  if chip == "v5p" else {"data": (0,), "model": (1,)})
        yield (jmm.TorusMachineModel(jmm.CHIPS[chip], **kw),
               mm.TorusMachineModel(mm.CHIPS[chip], **kw))


def test_machine_model_prices_match_the_reference():
    """Every CHIPS entry (flat, and split in slices of 4) and the torus:
    compute, every collective at several sizes, groups and axes, p2p and
    memory price alike to 1e-12."""
    n_checked = 0
    for jm, tm in _machines():
        for m in (jm, tm):
            m.axis_order = {"data": 4, "model": 4}
        assert tm.memory_per_chip() == jm.memory_per_chip()
        for flops, byts in ((1e9, 1e3), (1e6, 1e9), (3.3e12, 7.7e10)):
            assert tm.compute_time(flops, byts) == pytest.approx(
                jm.compute_time(flops, byts), rel=PRICE_RTOL)
        for nbytes in (1 << 10, 1 << 24, 3 << 30):
            for n in (1, 2, 4, 16):
                for axes in (None, ("data",), ("model",), ("data", "model")):
                    for f in ("all_reduce_time", "all_gather_time",
                              "reduce_scatter_time", "all_to_all_time"):
                        want = getattr(jm, f)(nbytes, n, axes)
                        assert getattr(tm, f)(nbytes, n, axes) == \
                            pytest.approx(want, rel=PRICE_RTOL), (f, n)
                        n_checked += 1
            for hops in (1, 3):
                assert tm.p2p_time(nbytes, hops) == pytest.approx(
                    jm.p2p_time(nbytes, hops), rel=PRICE_RTOL)
    assert n_checked > 500


def test_machine_model_files_read_alike(tmp_path):
    """The same --machine-model-file gives the same machine."""
    for i, d in enumerate(({"chip": "v5p", "num_chips": 64,
                            "mxu_efficiency": 0.6},
                           {"chip": "v4", "num_chips": 8,
                            "torus_shape": [2, 2, 2],
                            "axis_map": {"data": [0, 1]}})):
        p = tmp_path / f"m{i}.json"
        p.write_text(json.dumps(d))
        jm, tm = jmm.TPUMachineModel.from_file(str(p)), \
            mm.TPUMachineModel.from_file(str(p))
        assert type(tm).__name__ == type(jm).__name__
        assert (tm.chip.name, tm.num_chips, tm.mxu_efficiency) == (
            jm.chip.name, jm.num_chips, jm.mxu_efficiency)
        assert tm.all_reduce_time(1 << 26, 4, ("data",)) == \
            jm.all_reduce_time(1 << 26, 4, ("data",))


# ---------------------------------------------------------------------------
# the cost model


@pytest.mark.parametrize("which", ["dp", "llama_tp"])
def test_graph_cost_matches_under_dp_and_tp(which):
    """graph_cost of the tiny Llama on v5p-8 {"data": 2, "model": 4},
    under plain DP and under the reference's llama_tp_strategy (its views
    carried across as JSON), training and inference: time, memory and
    the per-node breakdown to 1e-9."""
    jg, tg = llama_pair()
    axis_sizes = {"data": 2, "model": 4}
    jc, tc = cost_pair(axis_sizes)
    if which == "dp":
        jstrat = jspace.default_dp_strategy(jg, axis_sizes)
        tstrat = space.default_dp_strategy(tg, axis_sizes)
        assert_same_strategy(jstrat, tstrat)
    else:
        jstrat = dict(jspace.default_dp_strategy(jg, axis_sizes))
        jstrat.update(jllama.llama_tp_strategy(jllama.LlamaConfig(**TINY)))
        tstrat = to_port(jstrat)
    for training in (True, False):
        jgc = jcm.graph_cost(jg, jstrat, jc, training)
        tgc = cm.graph_cost(tg, tstrat, tc, training)
        assert tgc.time == pytest.approx(jgc.time, rel=COST_RTOL)
        assert tgc.memory_per_chip == pytest.approx(jgc.memory_per_chip,
                                                    rel=COST_RTOL)
    for jn, tn in zip(jg.topo_order(), tg.topo_order()):
        assert tn.name == jn.name
        assert tc.node_compute_time(tg, tn, tstrat.get(tn.name)) == \
            pytest.approx(jc.node_compute_time(jg, jn, jstrat.get(jn.name)),
                          rel=COST_RTOL)
        assert tc.node_comm_time(tg, tn, tstrat.get(tn.name)) == \
            pytest.approx(jc.node_comm_time(jg, jn, jstrat.get(jn.name)),
                          rel=COST_RTOL)


# ---------------------------------------------------------------------------
# the searches


def _winner(name, jg, tg, jc, tc):
    """(reference (graph, strategy, cost), port's) of one search entry."""
    if name == "mcmc":
        js = jmcmc.mcmc_optimize(jg, jc, budget=2000, seed=3)
        ts = mcmc.mcmc_optimize(tg, tc, budget=2000, seed=3)
        return ((jg, js, jcm.graph_cost(jg, js, jc).time),
                (tg, ts, cm.graph_cost(tg, ts, tc).time))
    if name == "view_dp":
        js = jdp.ViewDP(jc).optimize(jg)
        ts = dp.ViewDP(tc).optimize(tg)
        return ((jg, js, jcm.graph_cost(jg, js, jc).time),
                (tg, ts, cm.graph_cost(tg, ts, tc).time))
    if name == "memory_lambda":
        # 60% of the unconstrained footprint: the λ bisection runs
        free = jcm.graph_cost(jg, jdp.ViewDP(jc, training=False).optimize(
            jg), jc, training=False).memory_per_chip
        kw = dict(memory_limit=0.6 * free, budget=4, iters=3,
                  training=False)
        jr = jsub.memory_lambda_search(jg, jc, **kw)
        tr = sub.memory_lambda_search(tg, tc, **kw)
        return ((jr[0], jr[1], jr[2].time), (tr[0], tr[1], tr[2].time))
    fn = {"unity": (jsub.unity_search, sub.unity_search),
          "sequence_unity": (jsub.sequence_unity_search,
                             sub.sequence_unity_search)}[name]
    return fn[0](jg, jc, budget=3), fn[1](tg, tc, budget=3)


@pytest.mark.parametrize("name", ["mcmc", "view_dp", "unity",
                                  "sequence_unity", "memory_lambda"])
def test_search_winners_match_the_reference(name):
    """Each search entry, as tests/test_search.py runs it: MCMC, the view
    DP and the sequence search on the tiny Llama over v5p-4 {"data": 2,
    "model": 2} (seq 64; 3 layers for the sequence search, so it splits),
    the flat Unity search and the memory-λ search (inference, under a
    limit that forces the bisection) on the big-weight MLP over v5e-8
    {"data": 2, "model": 4}: the same winning graph (structure hash, node
    names) and views, and its cost to 1e-9."""
    if name in ("unity", "memory_lambda"):
        jg, tg = mlp_pair(batch=256 if name == "unity" else 2048, layers=2)
        jc, tc = cost_pair({"data": 2, "model": 4}, "v5e")
    else:
        jg, tg = llama_pair(seq=64, layers=3 if name == "sequence_unity"
                            else 2)
        jc, tc = cost_pair({"data": 2, "model": 2}, n=4)
    (jwg, jws, jcost), (twg, tws, tcost) = _winner(name, jg, tg, jc, tc)
    assert twg.structure_hash() == jwg.structure_hash()
    assert sorted(n.name for n in twg.nodes) == sorted(
        n.name for n in jwg.nodes)
    assert_same_strategy(jws, tws)
    assert tcost == pytest.approx(jcost, rel=COST_RTOL)


# ---------------------------------------------------------------------------
# the native engine


def _tables():
    """The MLP's (node, candidate view) tables, built by each package."""
    jg, tg = mlp_pair()
    axis_sizes = {"data": 2, "model": 4}
    jc, tc = cost_pair(axis_sizes, "v5e")
    out = []
    for g, c, sp, tab in ((jg, jc, jspace, jtable), (tg, tc, space, table)):
        cands = {n.name: sp.enumerate_views(n, axis_sizes)
                 for n in g.topo_order() if n.attrs is not None
                 and len(sp.enumerate_views(n, axis_sizes)) > 1}
        base = sp.default_dp_strategy(g, axis_sizes)
        out.append(tab.build_table(g, c, cands, base, True))
    return out


def test_native_engine_matches_the_reference_library():
    """csrc/ffsim.cc, built by the port into _build/, evaluates,
    simulates and anneals the same tables exactly as the reference's
    libffsim: eval (with and without overlap), simulate and mcmc."""
    assert native.available() and jnative.available()
    assert native.sim_library_path().parent == native.BUILD_DIR
    jt, tt = _tables()
    assert tt.compute == jt.compute and tt.sync == jt.sync
    jn, tn = jt.to_native(), tt.to_native()
    rs = np.random.RandomState(0)
    for _ in range(20):
        a = [int(rs.randint(len(v))) for v in jt.views]
        for overlap in (0.0, 0.5):
            assert tn.eval(a, overlap) == jn.eval(a, overlap)
        assert tn.simulate(a) == jn.simulate(a)
    start = [0] * len(jt.views)
    for sim in (False, True):
        assert tn.mcmc(start, budget=3000, alpha=0.05, seed=7,
                       use_simulate=sim) == jn.mcmc(
            start, budget=3000, alpha=0.05, seed=7, use_simulate=sim)


def test_python_search_path_matches_the_reference(monkeypatch):
    """With available() patched to False in both packages, the
    pure-Python anneal and polish give the reference's views; the native
    path (unpatched) is the other leg of the same comparison."""
    jg, tg = mlp_pair()
    jc, tc = cost_pair({"data": 2, "model": 4}, "v5e")
    native_ts = mcmc.mcmc_optimize(tg, tc, budget=300, seed=1)
    assert_same_strategy(jmcmc.mcmc_optimize(jg, jc, budget=300, seed=1),
                         native_ts)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    js = jmcmc.mcmc_optimize(jg, jc, budget=300, seed=1)
    ts = mcmc.mcmc_optimize(tg, tc, budget=300, seed=1)
    assert_same_strategy(js, ts)
    assert cm.graph_cost(tg, ts, tc).time == pytest.approx(
        jcm.graph_cost(jg, js, jc).time, rel=COST_RTOL)


def test_failed_engine_build_raises_with_the_compiler_output(
        monkeypatch, tmp_path):
    """A source g++ refuses raises RuntimeError with its output; the
    search never falls back on its own (the reference returns False)."""
    bad = tmp_path / "bad.cc"
    bad.write_text("not C++ at all")
    monkeypatch.setattr(native, "SIM_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_sim_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()


# ---------------------------------------------------------------------------
# the H100 machine (properties)


def test_h100_all_reduce_stays_on_nvlink_inside_a_node():
    m8 = mm.H100MachineModel.make("h100", 8)
    m8.axis_order = {"data": 8}
    m16 = mm.H100MachineModel.make("h100", 16)
    m16.axis_order = {"data": 16}
    nbytes = 1 << 30
    assert not m8._crosses_dcn(8, ("data",))
    # NVLink at the datasheet's 450 GB/s a direction, times the knob
    nv = 2 * nbytes * 7 / 8 / (450e9 * m8.ici_efficiency) \
        + m8.ici_latency * 8
    assert m8.all_reduce_time(nbytes, 8, ("data",)) == pytest.approx(nv)
    assert m16._crosses_dcn(16, ("data",))
    assert m16.all_reduce_time(nbytes, 16, ("data",)) > \
        5 * m8.all_reduce_time(nbytes, 8, ("data",))
    # a group of 8 inside a 16-GPU machine still stays in its node
    m16.axis_order = {"data": 2, "model": 8}
    assert not m16._crosses_dcn(8, ("model",))
    assert m16._crosses_dcn(2, ("data",))


def test_h100_datasheet_and_knobs(tmp_path):
    m = mm.H100MachineModel.make()
    assert (m.chip.bf16_flops, m.chip.hbm_bytes, m.chip.hbm_bw,
            m.chip.nvlink_bw, m.dcn_bw) == (989.4e12, 80e9, 3.35e12, 450e9,
                                            50e9)
    assert m.memory_per_chip() == 80e9
    assert m.compute_time(1e12, 0) == pytest.approx(
        1e12 / (989.4e12 * m.mxu_efficiency))
    p = tmp_path / "h.json"
    p.write_text('{"chip": "h100", "num_chips": 16, "gpus_per_node": 8}')
    f = mm.TPUMachineModel.from_file(str(p))
    assert isinstance(f, mm.H100MachineModel)
    assert (f.num_chips, f.gpus_per_node, f.chips_per_slice) == (16, 8, 8)
    # the port's default machine: H100s, as many as the mesh's positions
    cost = _cost_model({"model": 4, "data": 2}, FFConfig(device="cpu"))
    assert isinstance(cost.machine, mm.H100MachineModel)
    assert cost.machine.num_chips == 8
    assert list(cost.machine.axis_order) == ["data", "model"]


def test_search_on_an_h100_node_beats_dp_on_the_tiny_llama():
    """test_search_discovers_llama_tp_strategy's claim on a modeled
    8xH100 node: the Unity search beats plain DP by graph_cost."""
    _, g = llama_pair()
    axis_sizes = {"data": 2, "model": 4}
    cost = cm.CostModel(mm.H100MachineModel.make("h100", 8), axis_sizes)
    dp_t = cm.graph_cost(g, space.default_dp_strategy(g, axis_sizes),
                         cost).time
    _, _, found = sub.unity_search(g, cost, budget=2)
    assert found < dp_t, (found, dp_t)


def test_llama3_8b_searches_on_an_h100_node(tmp_path):
    """Llama-3-8B's full 32-layer graph at seq 2048 through the Unity
    search on {"chip": "h100", "num_chips": 8} at budget 2."""
    from flexflow_tpu_torch.search.api import graph_optimize

    cfg8b = llama.LlamaConfig.llama3_8b()
    assert cfg8b.layers == 32
    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    llama.build_llama(ff, cfg8b, seq_len=2048)
    ff.graph.infer_shapes()
    assert len(ff.graph) > 300
    p = tmp_path / "h100.json"
    p.write_text(json.dumps({"chip": "h100", "num_chips": 8}))
    cfg = FFConfig(batch_size=8, device="cpu", search_budget=2,
                   machine_model_file=str(p))
    stats = {}
    g, strategy = graph_optimize(ff.graph, {"data": 2, "model": 4}, cfg,
                                 stats_out=stats)
    assert strategy and stats["best_cost"] > 0
    assert stats["corpus_rules_full"] >= stats["corpus_rules_active"]
