"""The port's training slice held to the JAX reference on the CPU: the loss
and its gradient, the step metrics, the optimizers, and the Llama training
step and fit loop with the JAX weights carried over
(runtime.weights.params_from_numpy). Inputs are numpy arrays from a seed,
fed to both packages."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.ffconst import MetricsType as JMetricsType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.runtime import loss as jloss  # noqa: E402
from flexflow_tpu.runtime import metrics as jmetrics  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
    MetricsType,
    SGDOptimizer,
)
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime import loss, metrics  # noqa: E402
from flexflow_tpu_torch.runtime.weights import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)

# fp32 on the CPU, same inputs: summation order and libm ulps only
TOL = 1e-5
# a whole training step (forward, backward, Adam) over a model: the fp32
# bar of tests/test_align.py
STEP_TOL = 1e-4


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


# ---------------------------------------------------------------------------
# (b) loss and step metrics


def _logits_labels(shape, seed, vocab=11):
    rs = np.random.RandomState(seed)
    logits = (3 * rs.standard_normal(shape + (vocab,))).astype(np.float32)
    labels = rs.randint(0, vocab, shape).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("softmax_sink", [False, True])
@pytest.mark.parametrize("shape", [(6,), (2, 5)])  # classifier, per-token LM
def test_sparse_cce_loss_and_grad_match_jax(shape, softmax_sink):
    logits, labels = _logits_labels(shape, seed=len(shape))
    if softmax_sink:  # the graph's sink is a real softmax: probabilities
        logits = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    lt = JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
    jval, jgrad = jax.value_and_grad(
        lambda lg: jloss.compute_loss(lt, lg, jnp.asarray(labels),
                                      softmax_sink))(jnp.asarray(logits))
    t = torch.from_numpy(logits.copy()).requires_grad_()
    val = loss.compute_loss(LossType.SPARSE_CATEGORICAL_CROSSENTROPY, t,
                            torch.from_numpy(labels), softmax_sink)
    val.backward()
    val = val.detach()
    np.testing.assert_allclose(float(val), float(jval), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=TOL,
                               rtol=TOL)


def test_fused_sparse_cce_clamps_labels_and_keeps_the_logits_dtype():
    logits, labels = _logits_labels((8,), seed=4)
    labels[:2] = [-3, 40]  # out of range: clamped in forward and backward
    lt = JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
    jval, jgrad = jax.value_and_grad(
        lambda lg: jloss.compute_loss(lt, lg, jnp.asarray(labels), False))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    val = loss.compute_loss(LossType.SPARSE_CATEGORICAL_CROSSENTROPY, t,
                            torch.from_numpy(labels), False)
    val.backward()
    val = val.detach()
    np.testing.assert_allclose(float(val), float(jval), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=TOL,
                               rtol=TOL)
    tb = torch.from_numpy(logits).bfloat16().requires_grad_()
    loss.compute_loss(LossType.SPARSE_CATEGORICAL_CROSSENTROPY, tb,
                      torch.from_numpy(labels), False).backward()
    assert tb.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["CATEGORICAL_CROSSENTROPY",
                                  "MEAN_SQUARED_ERROR_AVG_REDUCE",
                                  "MEAN_SQUARED_ERROR_SUM_REDUCE",
                                  "IDENTITY"])
def test_dense_losses_match_jax(name):
    rs = np.random.RandomState(5)
    logits = rs.standard_normal((6, 7)).astype(np.float32)
    labels = np.eye(7, dtype=np.float32)[rs.randint(0, 7, 6)]
    jval, jgrad = jax.value_and_grad(
        lambda lg: jloss.compute_loss(getattr(JLossType, name), lg,
                                      jnp.asarray(labels), False))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    val = loss.compute_loss(getattr(LossType, name), t,
                            torch.from_numpy(labels), False)
    val.backward()
    val = val.detach()
    np.testing.assert_allclose(float(val), float(jval), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("softmax_sink", [False, True])
@pytest.mark.parametrize("shape", [(6,), (2, 5)])
def test_step_metrics_match_jax(shape, softmax_sink):
    logits, labels = _logits_labels(shape, seed=7)
    if softmax_sink:
        logits = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    names = ["ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY"]
    want = jmetrics.compute_step_metrics(
        [getattr(JMetricsType, n) for n in names],
        JLossType.SPARSE_CATEGORICAL_CROSSENTROPY, jnp.asarray(logits),
        jnp.asarray(labels), softmax_sink)
    got = metrics.compute_step_metrics(
        [getattr(MetricsType, n) for n in names],
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY, torch.from_numpy(logits),
        torch.from_numpy(labels), softmax_sink)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)


def test_dense_step_metrics_match_jax():
    rs = np.random.RandomState(8)
    logits = rs.standard_normal((6, 7)).astype(np.float32)
    labels = np.eye(7, dtype=np.float32)[rs.randint(0, 7, 6)]
    names = ["ACCURACY", "CATEGORICAL_CROSSENTROPY", "MEAN_SQUARED_ERROR",
             "ROOT_MEAN_SQUARED_ERROR", "MEAN_ABSOLUTE_ERROR"]
    want = jmetrics.compute_step_metrics(
        [getattr(JMetricsType, n) for n in names],
        JLossType.CATEGORICAL_CROSSENTROPY, jnp.asarray(logits),
        jnp.asarray(labels), False)
    got = metrics.compute_step_metrics(
        [getattr(MetricsType, n) for n in names],
        LossType.CATEGORICAL_CROSSENTROPY, torch.from_numpy(logits),
        torch.from_numpy(labels), False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)


# ---------------------------------------------------------------------------
# (c) optimizers


@pytest.mark.parametrize("kind,kwargs", [
    ("SGD", dict(lr=0.05)),
    ("SGD", dict(lr=0.05, momentum=0.9)),
    ("SGD", dict(lr=0.05, momentum=0.9, nesterov=True, weight_decay=0.01)),
    ("Adam", dict(lr=1e-2, adamw=False, weight_decay=0.01)),
    ("Adam", dict(lr=1e-2, weight_decay=0.1)),
    ("Adam", dict(lr=1e-2, weight_decay=0.1, state_dtype="bfloat16")),
])
def test_optimizer_matches_jax_over_five_steps(kind, kwargs):
    rs = np.random.RandomState(11)
    params = {"a": {"kernel": rs.standard_normal((4, 3)).astype(np.float32),
                    "bias": rs.standard_normal(3).astype(np.float32)},
              "b": {"scale": rs.standard_normal(5).astype(np.float32)}}
    grads = [{k: {n: rs.standard_normal(a.shape).astype(np.float32)
                  for n, a in w.items()} for k, w in params.items()}
             for _ in range(5)]
    jo = getattr(jopt, f"{kind}Optimizer")(**kwargs)
    to = {"SGD": SGDOptimizer, "Adam": AdamOptimizer}[kind](**kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init_state(jp)
    tp = {k: {n: torch.from_numpy(a.copy()) for n, a in w.items()}
          for k, w in params.items()}
    ts = to.init_state(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), jp, js)
        tp, ts = to.update({k: {n: torch.from_numpy(a) for n, a in w.items()}
                            for k, w in g.items()}, tp, ts)
    assert ts["step"] == int(js["step"]) == 5
    for k, w in params.items():
        for n in w:
            np.testing.assert_allclose(tp[k][n].numpy(), np.asarray(jp[k][n]),
                                       atol=TOL, rtol=TOL, err_msg=(k, n))
    for slot in ("m", "v"):
        if slot in js:
            for k, w in params.items():
                for n in w:
                    np.testing.assert_allclose(
                        ts[slot][k][n].float().numpy(),
                        np.asarray(js[slot][k][n], np.float32), atol=TOL,
                        rtol=TOL, err_msg=(slot, k, n))


# ---------------------------------------------------------------------------
# (d), (e) the training slice: build_llama -> compile(Adam) -> fit/train_step

_METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")


def _pair(cfg, seq, batch, remat, lr):
    """A JAX model and a port model carrying its initial weights, both
    compiled with Adam(lr) and the same metrics."""
    jff = JFFModel(JFFConfig(batch_size=batch, seed=3, num_devices=1,
                             remat=remat))
    jbuild_llama(jff, JLlamaConfig(**cfg), batch_size=batch, seq_len=seq,
                 dtype=JDataType.FLOAT)
    jff.compile(optimizer=jopt.AdamOptimizer(lr=lr),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[getattr(JMetricsType, m) for m in _METRICS])
    tff = FFModel(FFConfig(batch_size=batch, seed=3, device="cpu",
                           remat=remat))
    build_llama(tff, LlamaConfig(**cfg), batch_size=batch, seq_len=seq,
                dtype=DataType.FLOAT)
    tff.compile(optimizer=AdamOptimizer(lr=lr),
                metrics=[getattr(MetricsType, m) for m in _METRICS],
                params=params_from_numpy(*map(_np_tree, jff._params),
                                         device="cpu"))
    return jff, tff


def _leaf(tree, prefix, name="kernel"):
    """The leaf `name` of the node whose key starts with `prefix` (keys
    carry the node's guid)."""
    (key,) = [k for k in tree if k.startswith(prefix + "_")]
    return tree[key][name]


def _tokens(n, seq, vocab, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, vocab, (n, seq)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _steps_match(jff, tff, x, y, steps):
    """`steps` train steps of each package on the same batches: the loss
    of every step and every parameter afterwards within STEP_TOL."""
    jstep = jff.executor.train_step()
    jtr, jntr = jff._params
    jos = jff._opt_state
    ttr, tntr = tff._params
    tos = tff._opt_state
    b = x.shape[0] // steps
    for i in range(steps):
        bx, by = x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]
        jtr, jntr, jos, jm = jstep(jtr, jntr, jos, jax.random.key(i),
                                   jnp.asarray(by), jnp.asarray(bx))
        ttr, tntr, tos, tm = tff.executor.train_step(
            ttr, tntr, tos, torch.from_numpy(by), torch.from_numpy(bx))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=f"loss of step {i}")
    got, _ = params_to_numpy(ttr, tntr)
    for k, w in jtr.items():
        for n, a in w.items():
            assert got[k][n].dtype == np.float32  # fp32 masters
            np.testing.assert_allclose(got[k][n], np.asarray(a),
                                       atol=STEP_TOL, rtol=STEP_TOL,
                                       err_msg=(k, n))


_TINY = dict(vocab_size=512, dim=64, layers=2, heads=4, kv_heads=2,
             hidden=128, rope_theta=10000.0)


@pytest.mark.parametrize("remat", ["none", "attention"])
def test_tiny_llama_fit_and_train_steps_match_jax(remat):
    """(d) LlamaConfig.tiny (GQA, fp32, seq 16): one fit epoch gives the
    JAX fit's epoch metrics, then three more train steps give the same
    losses and parameters."""
    jff, tff = _pair(_TINY, seq=16, batch=2, remat=remat, lr=1e-3)
    x, y = _tokens(8, 16, 512, seed=0)
    jm = jff.fit(x, y, epochs=1, verbose=False)
    tm = tff.fit(x, y, epochs=1, verbose=False)
    assert tm.train_all == jm.train_all == 8
    assert tm.train_correct == jm.train_correct
    np.testing.assert_allclose(tm.sparse_cce_loss, jm.sparse_cce_loss,
                               atol=STEP_TOL, rtol=STEP_TOL)
    x2, y2 = _tokens(6, 16, 512, seed=1)
    _steps_match(jff, tff, x2, y2, steps=3)


def test_remat_modes_train_alike():
    """remat="attention" recomputes each attention lowering in the
    backward pass; the step's result does not change."""
    x, y = _tokens(4, 16, 512, seed=2)
    out = []
    for remat in ("none", "attention"):
        ff = FFModel(FFConfig(batch_size=2, seed=5, device="cpu",
                              remat=remat))
        build_llama(ff, LlamaConfig.tiny(), seq_len=16, dtype=DataType.FLOAT)
        ff.compile(optimizer=AdamOptimizer(lr=1e-3))
        ff.fit(x, y, verbose=False)
        out.append(params_to_numpy(*ff._params)[0])
    for k, w in out[0].items():
        for n, a in w.items():
            np.testing.assert_allclose(out[1][k][n], a, atol=1e-6, rtol=1e-6)


def test_head_dim_128_train_steps_match_jax_pallas(monkeypatch):
    """(e) head dim 128 (dim 256, 2 heads, 1 kv head), seq 128: the JAX
    step runs the Pallas K1/K2 in interpret mode; the port its plain
    version. Adam's update m/sqrt(v) has about the same size whatever the
    gradient's, so one weight whose gradients change sign between steps
    turns a 1e-6 gradient difference into an lr-sized one; lr 1e-4 keeps
    that inside STEP_TOL (at lr 1e-3, 1 weight of 131072 lands at
    1.1e-4)."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    cfg = dict(vocab_size=512, dim=256, layers=2, heads=2, kv_heads=1,
               hidden=512, rope_theta=10000.0)
    jff, tff = _pair(cfg, seq=128, batch=2, remat="attention", lr=1e-4)
    x, y = _tokens(6, 128, 512, seed=3)
    _steps_match(jff, tff, x, y, steps=3)
    from flexflow_tpu.ops import jax_ops

    assert jax_ops.LAST_ATTENTION_KERNEL == "pallas_flash"


def test_head_dim_64_train_steps_match_jax_pallas(monkeypatch):
    """(e) head dim 64, the head geometry of bench.py's 200m Llama (dim
    1024, 16 heads over 8 kv heads) at a small size: dim 256, 4 heads
    over 2 kv heads (D 64, GQA 2), 2 layers, seq 128. Three Adam steps
    through fit (6 sequences, batch 2) give the JAX fit's epoch metrics
    and parameters within STEP_TOL: the JAX step runs its Pallas
    head-major kernels (`_fwd`, `_bwd`) interpreted, the port takes the
    head-major route (K4's plain versions on the CPU) once per layer and
    step. lr 1e-4 for the reason test_head_dim_128_... gives."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    from flexflow_tpu.ops import jax_ops
    from flexflow_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa._head_major_attention

    def head_major(q, *args):
        calls.append(q.shape[-1])
        return real(q, *args)

    monkeypatch.setattr(fa, "_head_major_attention", head_major)
    cfg = dict(vocab_size=512, dim=256, layers=2, heads=4, kv_heads=2,
               hidden=512, rope_theta=10000.0)
    jff, tff = _pair(cfg, seq=128, batch=2, remat="none", lr=1e-4)
    x, y = _tokens(6, 128, 512, seed=9)
    jm = jff.fit(x, y, epochs=1, verbose=False)
    assert jax_ops.LAST_ATTENTION_KERNEL == "pallas_flash"
    tm = tff.fit(x, y, epochs=1, verbose=False)
    assert calls == [64] * (2 * 3)
    assert tm.train_all == jm.train_all == 6
    assert tm.train_correct == jm.train_correct
    np.testing.assert_allclose(tm.sparse_cce_loss, jm.sparse_cce_loss,
                               atol=STEP_TOL, rtol=STEP_TOL)
    got, _ = params_to_numpy(*tff._params)
    for k, w in jff._params[0].items():
        for n, a in w.items():
            assert got[k][n].dtype == np.float32  # fp32 masters
            np.testing.assert_allclose(got[k][n], np.asarray(a),
                                       atol=STEP_TOL, rtol=STEP_TOL,
                                       err_msg=(k, n))


def test_compile_without_optimizer_trains_with_sgd_on_fp32_masters():
    """compile() with no optimizer keeps the use-site dtypes (bf16 here,
    as serving stores them); fit trains with SGDOptimizer() and turns the
    trainable leaves into fp32 masters at its first step."""
    ff = FFModel(FFConfig(batch_size=2, seed=1, device="cpu"))
    build_llama(ff, LlamaConfig.tiny(), seq_len=8)
    ff.compile()
    assert _leaf(ff._params[0], "tok_emb").dtype == torch.bfloat16
    x, y = _tokens(4, 8, 512, seed=4)
    before = _leaf(ff._params[0], "tok_emb").float().clone()
    ff.fit(x, y, verbose=False)
    emb = _leaf(ff._params[0], "tok_emb")
    assert emb.dtype == torch.float32
    assert isinstance(ff._optimizer, SGDOptimizer)
    assert not torch.equal(emb, before)
    probs = ff.predict(x[:3])
    assert probs.shape == (3, 8, 512) and np.isfinite(probs).all()
    pm = ff.eval(x, y, verbose=False)
    assert pm.train_all == 4


def test_bf16_model_compiled_to_train_keeps_fp32_masters():
    ff = FFModel(FFConfig(batch_size=2, seed=1, device="cpu"))
    build_llama(ff, LlamaConfig.tiny(), seq_len=8)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    tr, _ = ff._params
    assert {t.dtype for w in tr.values() for t in w.values()} == {
        torch.float32}
    m = _leaf(ff._opt_state["m"], "tok_emb")
    assert m.dtype == torch.float32 and m.shape == _leaf(tr, "tok_emb").shape
    x, y = _tokens(4, 8, 512, seed=6)
    pm = ff.fit(x, y, epochs=2, verbose=False)
    assert np.isfinite(pm.sparse_cce_loss)
