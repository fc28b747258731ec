"""The port's Mixtral-style MoE decoder (models/mixtral.py) held to the JAX
reference on the CPU at MixtralConfig.tiny's widths (4 experts top-2,
capacity factor 1.25, GQA attention with RoPE), fp32, from the JAX
model's weights (runtime.weights.params_from_numpy): predict, three Adam
steps (the reported loss without the load-balance term, the parameters
moved by its gradient), one ragged step whose window holds pad rows, and
the paged server's greedy tokens. Every row of a launch is routed, pads
included, so capacity depends on the launch shape: the two packages are
compared at the same shapes."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import MetricsType as JMetricsType  # noqa: E402
from flexflow_tpu.models import mixtral as jmixtral  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    MetricsType,
)
from flexflow_tpu_torch.models import mixtral  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.runtime.loss import compute_loss  # noqa: E402
from flexflow_tpu_torch.runtime.weights import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)

# fp32 on the CPU, same weights: summation order only; a training step
# at test_align's bar
TOL, STEP_TOL = 1e-5, 1e-4
VOCAB = 512
_METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


def _pair(seq, batch, train):
    """A JAX tiny Mixtral and the port's carrying its weights, fp32;
    compiled with Adam(1e-3) when `train`."""
    jff = JFFModel(JFFConfig(batch_size=batch, seed=7, num_devices=1,
                             remat="none"))
    jmixtral.build_mixtral(jff, jmixtral.MixtralConfig.tiny(VOCAB),
                           batch_size=batch, seq_len=seq,
                           dtype=JDataType.FLOAT)
    tff = FFModel(FFConfig(batch_size=batch, seed=7, device="cpu",
                           remat="none"))
    mixtral.build_mixtral(tff, mixtral.MixtralConfig.tiny(VOCAB),
                          batch_size=batch, seq_len=seq, dtype=DataType.FLOAT)
    if train:
        jff.compile(optimizer=jopt.AdamOptimizer(lr=1e-3),
                    metrics=[getattr(JMetricsType, m) for m in _METRICS])
    else:
        jff.compile()
    params = params_from_numpy(*map(_np_tree, jff._params), device="cpu")
    tff.compile(optimizer=AdamOptimizer(lr=1e-3) if train else None,
                metrics=[getattr(MetricsType, m) for m in _METRICS],
                params=params)
    return jff, tff


def _tokens(n, seq, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, VOCAB, (n, seq)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def test_tiny_mixtral_builds_the_reference_graph_and_predicts_like_jax():
    jff, tff = _pair(16, 2, train=False)
    assert tff.graph.structure_hash() == jff.graph.structure_hash()
    x, _ = _tokens(3, 16, seed=0)
    np.testing.assert_allclose(tff.predict(x), jff.predict(x), atol=TOL,
                               rtol=TOL)


def test_tiny_mixtral_train_steps_match_jax():
    """Three Adam steps on batches of 2 x 32 tokens (t 64 rows, cap 40 a
    layer): each step's reported loss and accuracy count equal JAX's,
    which leave out the load-balance term; every parameter afterwards
    equals JAX's, whose gradient includes it. The port's reported loss is
    the cross-entropy of the logits alone, and the term is live (its
    gradient reaches the routers)."""
    jff, tff = _pair(32, 2, train=True)
    jstep = jff.executor.train_step()
    jtr, jntr = jff._params
    jos = jff._opt_state
    ttr, tntr = tff._params
    tos = tff._opt_state
    x, y = _tokens(6, 32, seed=1)
    for i in range(3):
        bx, by = x[2 * i:2 * i + 2], y[2 * i:2 * i + 2]
        jtr, jntr, jos, jm = jstep(jtr, jntr, jos, jax.random.key(i),
                                   jnp.asarray(by), jnp.asarray(bx))
        ttr, tntr, tos, tm = tff.executor.train_step(
            ttr, tntr, tos, torch.from_numpy(by), torch.from_numpy(bx))
        for key in ("loss", "accuracy_correct"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=STEP_TOL, rtol=STEP_TOL,
                                       err_msg=f"{key} of step {i}")
    got, _ = params_to_numpy(ttr, tntr)
    for k, w in jtr.items():
        for n, a in w.items():
            np.testing.assert_allclose(got[k][n], np.asarray(a),
                                       atol=STEP_TOL, rtol=STEP_TOL,
                                       err_msg=(k, n))
    ex = tff.executor
    bx, by = torch.from_numpy(x[:2]), torch.from_numpy(y[:2])
    loss, logits, grads = ex.loss_and_grads(ttr, tntr, by, bx)
    assert float(loss) == float(compute_loss(ex.loss_type, logits, by,
                                             False))
    _, aux = ex.run_forward(ttr, tntr, [bx], training=True,
                            skip_sink_softmax=True, return_aux=True)
    assert float(aux) > 0  # 2 layers x lambda 1e-2 x n sum f p ~ 2e-2
    assert all(float(g.abs().max()) > 0 for k, w in grads.items()
               if "router" in k for g in w.values())


def test_ragged_step_with_pad_rows_matches_jax():
    """One packed ragged step at window 8: a 5-row prompt chunk, a decode
    row and a pad entry (q_len 0), so 24 rows are routed (cap 15 a
    layer, the pads counted as the reference counts them): the live
    rows' probabilities and the written pools equal JAX's."""
    jff, tff = _pair(8, 1, train=False)
    jex, tex = jff.executor, tff.executor
    P, N = 4, 12
    jcaches, tcaches = (ex.init_paged_kv_cache(N, P) for ex in (jex, tex))
    tables = np.zeros((3, 4), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [2, 9, 5]
    pos = np.array([0, 9, 0], np.int32)
    qls = np.array([5, 1, 0], np.int32)
    ids = np.random.RandomState(2).randint(0, VOCAB, (3, 8)).astype(np.int32)
    deps = np.tile(np.arange(8, dtype=np.int32), (3, 1))
    anc = np.tile(np.tril(np.ones((8, 8), bool)), (3, 1, 1))
    jp, jcaches = jex.ragged_step_fn()(
        *jff._params, jcaches, *(jnp.asarray(a) for a in (
            tables, pos, qls, deps, anc, ids)))
    tp, tcaches = tex.ragged_step_fn(
        *tff._params, tcaches, *(torch.from_numpy(a) for a in (
            tables, pos, qls, deps, anc, ids)))
    jp, tp = np.asarray(jp), tp.numpy()
    for b in range(3):
        n = int(qls[b])
        np.testing.assert_allclose(tp[b, :n], jp[b, :n], atol=TOL, rtol=TOL)
    live = sorted(set(tables.ravel()) - {0})
    for key in jcaches:
        for name in ("k", "v"):
            np.testing.assert_allclose(tcaches[key][name].numpy()[live],
                                       np.asarray(jcaches[key][name])[live],
                                       atol=TOL, rtol=TOL)


def _serve(ff, prompts, new):
    """Every prompt queued before the loop starts (defer_start), so the
    schedule, and with it each launch's shape, depends on the tokens
    alone."""
    server = ff.serve_generation(paged=True, slots=2, max_len=64,
                                 page_size=4, defer_start=True)
    try:
        futs = [server.submit(p, max_new_tokens=new) for p in prompts]
        server.start()
        return [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        server.stop()


def test_paged_server_greedy_tokens_match_jax(monkeypatch):
    """Prompts of 3, 9, 6 and 14 tokens, 2 slots, page 4, 8 new tokens:
    the port's paged server emits exactly the JAX paged server's greedy
    tokens, at the same launch shapes, with (row, choice) pairs dropped
    at capacity along the way."""
    jff, tff = _pair(8, 1, train=False)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32)
               for n in (3, 9, 6, 14)]
    want = _serve(jff, prompts, 8)
    drops = []
    real = torch_ops.sorted_dispatch

    def counting(topi, n, cap):
        slot, kept = real(topi, n, cap)
        drops.append(int((slot == n * cap).sum()))
        return slot, kept

    monkeypatch.setattr(torch_ops, "sorted_dispatch", counting)
    got = _serve(tff, prompts, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert drops and sum(drops) > 0


def test_expert_parallelism_is_refused_by_item():
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        mixtral.mixtral_ep_strategy(mixtral.MixtralConfig.tiny())
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        FFConfig(device="cpu", mesh_shape={"data": 1, "expert": 2})


def test_generate_and_megastep_serve_mixtral_like_jax():
    """The dense KV-cache path and the decode megastep take the same
    EXPERTS lowering: generate()'s greedy tokens (prefill of 2 x 5, then
    single-token steps) equal JAX's, and the paged server with
    megastep_ticks=4 emits the JAX one-tick server's tokens where both
    launch the same decode shape."""
    jff, tff = _pair(8, 1, train=False)
    x, _ = _tokens(2, 5, seed=4)
    np.testing.assert_array_equal(tff.generate(x, 6),
                                  np.asarray(jff.generate(x, 6)))
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in (4, 7)]
    want = _serve(jff, prompts, 8)
    server = tff.serve_generation(paged=True, slots=2, max_len=64,
                                  page_size=4, defer_start=True,
                                  megastep_ticks=4)
    try:
        futs = [server.submit(p, max_new_tokens=8) for p in prompts]
        server.start()
        got = [np.asarray(f.result(timeout=120)) for f in futs]
    finally:
        server.stop()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
