"""The PyTorch port's serving slice held to the JAX reference, on the CPU.

Same builder calls give the same PCG in both packages; with the JAX
weights carried over (runtime.weights.params_from_numpy) the port's
ragged step matches the reference's probabilities, and its paged server
emits the same greedy tokens as the reference's paged server and
FFModel.generate.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402

# fp32 on the CPU, same weights: differences are summation order only
TOL = 1e-5
_MODELS = {}


def _tiny(kv_heads):
    return dict(vocab_size=512, dim=64, layers=2, heads=4,
                kv_heads=kv_heads, hidden=128, rope_theta=10000.0)


def _models(kv_heads):
    """(JAX model, port model carrying the JAX weights, LlamaConfig
    kwargs) for the tiny causal LM of tests/test_paged.py; kv_heads=2 is
    GQA (4 q heads), 4 is MHA. Built once per kv_heads."""
    if kv_heads not in _MODELS:
        jff = JFFModel(JFFConfig(batch_size=1, seed=7))
        jbuild_llama(jff, JLlamaConfig(**_tiny(kv_heads)), batch_size=1,
                     seq_len=8, dtype=JDataType.FLOAT)
        jff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        tff = FFModel(FFConfig(batch_size=1, seed=7, device="cpu"))
        build_llama(tff, LlamaConfig(**_tiny(kv_heads)), batch_size=1,
                    seq_len=8, dtype=DataType.FLOAT)
        jtr, jntr = jff._params
        tff.compile(params=params_from_numpy(
            {k: {n: np.asarray(a) for n, a in w.items()}
             for k, w in jtr.items()},
            {k: {n: np.asarray(a) for n, a in w.items()}
             for k, w in jntr.items()}, device="cpu"))
        _MODELS[kv_heads] = (jff, tff)
    return _MODELS[kv_heads]


def test_build_llama_tiny_same_graph_in_both_packages():
    jff = JFFModel(JFFConfig(batch_size=1, seed=0))
    jbuild_llama(jff, JLlamaConfig.tiny(), batch_size=1, seq_len=8)
    tff = FFModel(FFConfig(batch_size=1, seed=0, device="cpu"))
    build_llama(tff, LlamaConfig.tiny(), batch_size=1, seq_len=8)

    def describe(ff):
        return [(n.stable_key(), n.op_type.value, repr(n.attrs),
                 [(tuple(d.size for d in o.dims), o.dtype.value)
                  for o in n.outputs])
                for n in ff.graph.topo_order()]

    assert describe(jff) == describe(tff)
    assert jff.graph.structure_hash() == tff.graph.structure_hash()
    jff.graph.infer_shapes()
    tff.graph.infer_shapes()
    from flexflow_tpu.runtime.executor import Executor as JExecutor

    jspecs = JExecutor(jff.graph, None, loss_type=None, metrics=(),
                       optimizer=None).weight_specs()
    tspecs = tff.compile().executor.weight_specs()
    assert {k: {n: (s.shape.dims, s.shape.dtype.value, s.initializer)
                for n, s in w.items()} for k, w in jspecs.items()} == \
        {k: {n: (s.shape.dims, s.shape.dtype.value, s.initializer)
             for n, s in w.items()} for k, w in tspecs.items()}
    tr, _ = tff._params
    for k, w in jspecs.items():
        for n, s in w.items():
            assert tuple(tr[k][n].shape) == tuple(s.shape.dims), (k, n)


@pytest.mark.parametrize("kv_heads", [2, 4])  # GQA and MHA
def test_ragged_step_matches_jax(kv_heads):
    """Two packed ragged steps on the same pools: first two prompt
    chunks (5 and 6 rows) beside a pad entry, then a decode row, an
    8-row prefill piece continuing a prompt, and a pad entry. Probs and
    the written pools agree at TOL."""
    jff, tff = _models(kv_heads)
    jex, tex = jff.executor, tff.executor
    P, N, MAXP = 4, 16, 6
    jcaches = jex.init_paged_kv_cache(N, P)
    tcaches = tex.init_paged_kv_cache(N, P)
    tables = np.zeros((3, MAXP), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :4] = [2, 9, 5, 11]
    rs = np.random.RandomState(4)
    launches = [
        # (pos, q_lens, ids) with window 6, then window 8
        (np.array([0, 0, 0], np.int32), np.array([5, 6, 0], np.int32),
         rs.randint(0, 512, (3, 6)).astype(np.int32)),
        (np.array([5, 6, 0], np.int32), np.array([1, 8, 0], np.int32),
         rs.randint(0, 512, (3, 8)).astype(np.int32)),
    ]
    jstep, tstep = jex.ragged_step_fn(), tex.ragged_step_fn
    jtr, jntr = jff._params
    ttr, tntr = tff._params
    for pos, qls, ids in launches:
        W = ids.shape[1]
        deps = np.tile(np.arange(W, dtype=np.int32), (3, 1))
        anc = np.tile(np.tril(np.ones((W, W), bool)), (3, 1, 1))
        jprobs, jcaches = jstep(jtr, jntr, jcaches, jnp.asarray(tables),
                                jnp.asarray(pos), jnp.asarray(qls),
                                jnp.asarray(deps), jnp.asarray(anc),
                                jnp.asarray(ids))
        tprobs, tcaches = tstep(ttr, tntr, tcaches,
                                torch.from_numpy(tables),
                                torch.from_numpy(pos), torch.from_numpy(qls),
                                torch.from_numpy(deps), torch.from_numpy(anc),
                                torch.from_numpy(ids))
        jp, tp = np.asarray(jprobs), tprobs.numpy()
        for b in range(3):
            n = int(qls[b])
            np.testing.assert_allclose(tp[b, :n], jp[b, :n], atol=TOL,
                                       rtol=TOL)
        live = sorted(set(tables[:2].ravel()) - {0})
        for key in jcaches:
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    tcaches[key][name].numpy()[live],
                    np.asarray(jcaches[key][name])[live], atol=TOL,
                    rtol=TOL)


@pytest.mark.parametrize("kv_heads", [2, 4])  # GQA and MHA
def test_paged_server_greedy_tokens_match_jax(kv_heads):
    """The fixture of tests/test_paged.py (prompts of 3, 8, 5, 2 and 6
    tokens; page_size 4; 2 slots; 5 new tokens): the port's paged server
    emits exactly the reference paged server's and generate()'s tokens."""
    jff, tff = _models(kv_heads)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (3, 8, 5, 2, 6)]
    want = [jff.generate(p[None, :], max_new_tokens=5)[0] for p in prompts]
    jserver = jff.serve_generation(slots=2, max_len=32, paged=True,
                                   page_size=4)
    try:
        jgot = [f.result(timeout=120) for f in
                [jserver.submit(p, max_new_tokens=5) for p in prompts]]
    finally:
        jserver.stop()
    tserver = tff.serve_generation(slots=2, max_len=32, paged=True,
                                   page_size=4)
    try:
        tgot = [f.result(timeout=120) for f in
                [tserver.submit(p, max_new_tokens=5) for p in prompts]]
    finally:
        tserver.stop()
    for w, j, t in zip(want, jgot, tgot):
        np.testing.assert_array_equal(j, w)
        np.testing.assert_array_equal(t, w)
    assert tserver.requests_served == len(prompts)
    assert tserver.decode_steps < 25  # continuous, not serial


def test_unsupported_server_knobs_raise():
    """megastep_ticks=4, the mixed megastep (with overlap_dispatch), the
    unpacked launch and the dense default all serve, each with the
    reference's greedy tokens; speculate=object() raises TypeError and
    overlap_dispatch without the mixed megastep ValueError, as the
    reference does; the host tier and the kv_quant_canary shadow cache
    serve with the reference's greedy tokens too (the knobs the port
    does not serve yet are held to raising NotImplementedError by
    tests/test_torch_batch_serving.py); an unknown kv_dtype is a
    ValueError."""
    jff, tff = _models(2)
    prompt = np.arange(1, 7, dtype=np.int32)
    want = np.asarray(jff.generate(prompt[None], max_new_tokens=5)[0])
    for kw in ({"paged": True, "megastep_ticks": 4},
               {"paged": True, "megastep_ticks": 4, "megastep_mixed": True,
                "overlap_dispatch": True},
               {"paged": True, "ragged_pack": False},
               {"paged": True, "host_tier": 8},
               {"paged": True, "kv_quant_canary": 2}, {}):
        server = tff.serve_generation(slots=2, max_len=32, page_size=4,
                                      **kw)
        try:
            got = server.generate(prompt, 5, timeout=120)
        finally:
            server.stop()
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        if kw.get("megastep_ticks"):
            assert server.metrics()["megastep"]["dispatches"] > 0
    with pytest.raises(TypeError, match="SpecConfig"):
        tff.serve_generation(slots=2, max_len=32, paged=True, page_size=4,
                             speculate=object())
    with pytest.raises(ValueError, match="megastep_mixed"):
        tff.serve_generation(slots=2, max_len=32, paged=True, page_size=4,
                             overlap_dispatch=True)
    with pytest.raises(ValueError, match="kv_dtype"):
        tff.serve_generation(slots=2, max_len=32, paged=True, page_size=4,
                             kv_dtype="int7")


def test_chunked_prefill_across_ticks_matches_generate():
    """Prompts longer than the per-tick prefill budget (5 tokens) and the
    packed window (8 rows): prefill spans several ticks, rotates between
    slots and splits chunks into pieces, and the greedy tokens still equal
    the reference's generate()."""
    jff, tff = _models(2)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (17, 4, 11, 23)]
    want = [jff.generate(p[None, :], max_new_tokens=4)[0] for p in prompts]
    server = tff.serve_generation(slots=3, max_len=32, paged=True,
                                  page_size=4, prefill_chunk=5)
    try:
        got = [f.result(timeout=120) for f in
               [server.submit(p, max_new_tokens=4) for p in prompts]]
    finally:
        server.stop()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    m = server.metrics()
    assert m["prefill_ticks"] >= sum(len(p) for p in prompts) // 5
    assert m["pages_in_use"] == 0  # every page freed


def test_sampling_is_seeded_and_eos_stops():
    """Temperature sampling draws from the server's seeded generator: the
    same seed gives the same tokens, and eos_id ends a request early."""
    _, tff = _models(2)
    prompt = np.arange(1, 7, dtype=np.int32)
    runs = []
    for _ in range(2):
        server = tff.serve_generation(slots=2, max_len=32, paged=True,
                                      page_size=4, seed=3)
        try:
            runs.append(server.generate(prompt, 6, temperature=0.8,
                                        timeout=120))
        finally:
            server.stop()
    np.testing.assert_array_equal(runs[0], runs[1])
    assert ((0 <= runs[0]) & (runs[0] < 512)).all()
    greedy = tff.serve_generation(slots=1, max_len=32, paged=True,
                                  page_size=4)
    try:
        first = greedy.generate(prompt, 6, timeout=120)
    finally:
        greedy.stop()
    eos = tff.serve_generation(slots=1, max_len=32, paged=True, page_size=4,
                               eos_id=int(first[2]))
    try:
        cut = eos.generate(prompt, 6, timeout=120)
    finally:
        eos.stop()
    stop_at = list(first).index(first[2])  # its first occurrence ends it
    np.testing.assert_array_equal(cut, first[:stop_at + 1])


def test_stop_cancels_pending_requests():
    _, tff = _models(2)
    server = tff.serve_generation(slots=1, max_len=32, paged=True,
                                  page_size=4)
    server.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(np.arange(3, dtype=np.int32), 2)
