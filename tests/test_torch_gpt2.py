"""The port's GPT-2 path held to the JAX reference on the CPU: the ops it
adds (LAYER_NORM, WEIGHT, the learned position table's three cases), the
tiny GPT-2 built in both packages (same PCG; forward logits; Adam steps;
the paged server's steps and greedy tokens) with the JAX weights carried
over (runtime.weights.params_from_numpy). The JAX training legs run the
reference's head-major Pallas kernel K4 (`_fwd`/`_bwd`) in interpret
mode, as tests/test_pallas_flash.py does; the port's CPU path runs the
plain versions of K4's contracts through the same autograd.Function the
card runs with the kernels. Inputs are numpy arrays from a seed, fed to
both packages."""

import dataclasses

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
from flexflow_tpu.models.gpt2 import GPT2Config as JGPT2Config  # noqa: E402
from flexflow_tpu.models.gpt2 import build_gpt2 as jbuild_gpt2  # noqa: E402
from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.ops.registry import LowerCtx as JLowerCtx  # noqa: E402
from flexflow_tpu.pcg.tensor import TensorShape as JTensorShape  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    MetricsType,
    OpType,
)
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2  # noqa: E402
from flexflow_tpu_torch.ops import attrs as A  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.ops.registry import LowerCtx  # noqa: E402
from flexflow_tpu_torch.pcg.tensor import TensorShape  # noqa: E402
from flexflow_tpu_torch.runtime.weights import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)

# fp32 on the CPU, same inputs: one op differs by summation order only
OP_TOL = 1e-5
# a whole model's logits, and a whole training step (forward, backward,
# Adam): the fp32 bar of tests/test_align.py
TOL = 1e-4
SEQ = 128  # the reference's _pick_block tiles it: its flash path runs
VOCAB = 256
_METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


def _pair(seq, batch, optimizer=True, remat="attention", lr=1e-3,
          dtype="FLOAT"):
    """A tiny GPT-2 in each package (fp32 unless `dtype` names another
    DataType), the port's carrying the JAX model's initial weights;
    compiled with Adam(lr) when `optimizer`."""
    jff = JFFModel(JFFConfig(batch_size=batch, seed=3, num_devices=1,
                             remat=remat))
    jbuild_gpt2(jff, JGPT2Config.tiny(VOCAB), batch_size=batch, seq_len=seq,
                dtype=getattr(JDataType, dtype))
    tff = FFModel(FFConfig(batch_size=batch, seed=3, device="cpu",
                           remat=remat))
    build_gpt2(tff, GPT2Config.tiny(VOCAB), batch_size=batch, seq_len=seq,
               dtype=getattr(DataType, dtype))
    if optimizer:
        jff.compile(optimizer=jopt.AdamOptimizer(lr=lr),
                    loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                    metrics=[getattr(JMetricsType, m) for m in _METRICS])
        tff.compile(optimizer=AdamOptimizer(lr=lr),
                    metrics=[getattr(MetricsType, m) for m in _METRICS],
                    params=params_from_numpy(*map(_np_tree, jff._params),
                                             device="cpu"))
    else:
        jff.compile(loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        tff.compile(params=params_from_numpy(*map(_np_tree, jff._params),
                                             device="cpu"))
    return jff, tff


def _tokens(n, seq, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, VOCAB, (n, seq)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# the ops GPT-2 adds, each against its JAX lowering


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax(affine, dtype):
    """fp32 statistics and affine, cast back; forward and the gradients
    of x, scale and bias (fp32), forward only in bf16."""
    rs = np.random.RandomState(1)
    x = (3 * rs.standard_normal((2, 5, 24)) + 1).astype(np.float32)
    params = {"scale": rs.standard_normal(24).astype(np.float32),
              "bias": rs.standard_normal(24).astype(np.float32)}
    if not affine:
        params = {}
    w = rs.standard_normal((2, 5, 24)).astype(np.float32)
    jattrs = JA.LayerNormAttrs((-1,), affine, 1e-5)
    tattrs = A.LayerNormAttrs((-1,), affine, 1e-5)
    assert repr(jattrs) == repr(tattrs)
    if dtype == "bfloat16":
        (jy,) = jax_ops._layer_norm(jattrs, [jnp.asarray(x, jnp.bfloat16)],
                                    {k: jnp.asarray(v) for k, v in
                                     params.items()}, JLowerCtx())
        (ty,) = torch_ops._layer_norm(
            tattrs, [torch.from_numpy(x).bfloat16()],
            {k: torch.from_numpy(v) for k, v in params.items()},
            LowerCtx())
        assert ty.dtype == torch.bfloat16
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy, np.float32), atol=1e-2,
                                   rtol=1e-2)
        return

    def jloss(xx, ps):
        (y,) = jax_ops._layer_norm(jattrs, [xx], ps, JLowerCtx())
        return jnp.sum(y * jnp.asarray(w)), y

    (_, jy), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    (ty,) = torch_ops._layer_norm(tattrs, [tx], tp, LowerCtx())
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=OP_TOL,
                               rtol=OP_TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   atol=OP_TOL, rtol=OP_TOL, err_msg=k)


def test_layer_norm_over_leading_axes_matches_jax():
    """Axes that are not the trailing ones take the reference's
    formula."""
    rs = np.random.RandomState(2)
    x = rs.standard_normal((3, 4, 5)).astype(np.float32)
    jattrs = JA.LayerNormAttrs((0, 1), False, 1e-5)
    (jy,) = jax_ops._layer_norm(jattrs, [jnp.asarray(x)], {}, JLowerCtx())
    (ty,) = torch_ops._layer_norm(A.LayerNormAttrs((0, 1), False, 1e-5),
                                  [torch.from_numpy(x)], {}, LowerCtx())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OP_TOL,
                               rtol=OP_TOL)


def test_weight_matches_jax_and_takes_its_declared_dtype():
    rs = np.random.RandomState(3)
    table = rs.standard_normal((6, 8)).astype(np.float32)
    jattrs = JA.WeightAttrs(JTensorShape((6, 8), JDataType.FLOAT))
    tattrs = A.WeightAttrs(TensorShape((6, 8), DataType.FLOAT))
    assert repr(jattrs) == repr(tattrs)
    (jw,) = jax_ops._weight(jattrs, [], {"weight": jnp.asarray(table)},
                            JLowerCtx())
    (tw,) = torch_ops._weight(tattrs, [], {"weight": torch.from_numpy(table)},
                              LowerCtx())
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # a bf16 weight's fp32 master reaches its use as it is, fp32, as the
    # reference's does (jnp promotion then follows from it)
    battrs = A.WeightAttrs(TensorShape((6, 8), DataType.BFLOAT16))
    (bw,) = torch_ops._weight(battrs, [], {"weight": torch.from_numpy(table)},
                              LowerCtx())
    (jbw,) = jax_ops._weight(
        JA.WeightAttrs(JTensorShape((6, 8), JDataType.BFLOAT16)), [],
        {"weight": jnp.asarray(table)}, JLowerCtx())
    assert bw.dtype == torch.float32 and jbw.dtype == jnp.float32
    # and is stored fp32, its master, whatever the compile
    ff = FFModel(FFConfig(batch_size=1, device="cpu"))
    ff.create_weight((6, 8), DataType.BFLOAT16, name="table")
    for optimizer in (None, AdamOptimizer()):
        (w,) = ff.compile(optimizer=optimizer)._params[0].values()
        assert w["weight"].dtype == torch.float32
    assert {n: s.shape.dims for n, s in tattrs.weights().items()} == {
        n: s.shape.dims for n, s in jattrs.weights().items()}


def _position_case(case, rs):
    """(activations, table, JAX ctx, port ctx) for one of the lowering's
    three cases, on a (B 3, S 4, E 8) window and a 16-row table (S rows
    without a cache, as the graph builds it)."""
    a = rs.standard_normal((3, 4, 8)).astype(np.float32)
    if case == "no_cache":
        table = rs.standard_normal((4, 8)).astype(np.float32)
        return a, table, JLowerCtx(), LowerCtx()
    table = rs.standard_normal((16, 8)).astype(np.float32)
    # padded rows of the last entry run past the table: clamped in both
    pos = np.array([0, 5, 14], np.int32)
    if case == "per_row":
        return (a, table, JLowerCtx(cache_position=jnp.asarray(pos)),
                LowerCtx(cache_position=torch.from_numpy(pos)))
    # ragged: chain depths for two entries, a tree's depths for one
    deps = np.array([[0, 1, 2, 3], [0, 1, 1, 2], [0, 1, 2, 3]], np.int32)
    return (a, table,
            JLowerCtx(cache_position=jnp.asarray(pos),
                      ragged_depths=jnp.asarray(deps)),
            LowerCtx(cache_position=torch.from_numpy(pos),
                     ragged_depths=torch.from_numpy(deps)))


@pytest.mark.parametrize("case", ["no_cache", "per_row", "ragged"])
def test_position_table_add_matches_jax(case):
    """ELEMENT_BINARY's position-table branch: a broadcast add without a
    cache; rows pos[:, None] + arange(S) per row; rows pos[:, None] +
    depths in a ragged step."""
    rs = np.random.RandomState(4)
    a, table, jctx, tctx = _position_case(case, rs)
    jattrs = JA.ElementBinaryAttrs("add", position_table=True)
    tattrs = A.ElementBinaryAttrs("add", position_table=True)
    assert repr(jattrs) == repr(tattrs)
    (jy,) = jax_ops._element_binary(jattrs, [jnp.asarray(a),
                                             jnp.asarray(table)], {}, jctx)
    (ty,) = torch_ops._element_binary(tattrs, [torch.from_numpy(a),
                                               torch.from_numpy(table)], {},
                                      tctx)
    assert ty.shape == (3, 4, 8)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_position_table_shape_inference_matches_jax():
    from flexflow_tpu.pcg.tensor import (
        ParallelTensorShape as JPTS,
    )
    from flexflow_tpu_torch.pcg.tensor import ParallelTensorShape as PTS

    a, b = (2, 16, 8), (16, 8)
    (jo,) = JA.ElementBinaryAttrs("add", position_table=True).infer(
        JPTS.from_shape(JTensorShape(a, JDataType.FLOAT)),
        JPTS.from_shape(JTensorShape(b, JDataType.FLOAT)))
    (to,) = A.ElementBinaryAttrs("add", position_table=True).infer(
        PTS.from_shape(TensorShape(a, DataType.FLOAT)),
        PTS.from_shape(TensorShape(b, DataType.FLOAT)))
    assert [d.size for d in to.dims] == [d.size for d in jo.dims] == list(a)
    assert to.dtype.value == jo.dtype.value


# ---------------------------------------------------------------------------
# the tiny GPT-2 built in both packages


def test_build_gpt2_tiny_same_graph_in_both_packages():
    jff = JFFModel(JFFConfig(batch_size=1, seed=0))
    jbuild_gpt2(jff, JGPT2Config.tiny(), batch_size=1, seq_len=16)
    tff = FFModel(FFConfig(batch_size=1, seed=0, device="cpu"))
    build_gpt2(tff, GPT2Config.tiny(), batch_size=1, seq_len=16)

    def describe(ff):
        return [(n.stable_key(), n.op_type.value, repr(n.attrs),
                 [(tuple(d.size for d in o.dims), o.dtype.value)
                  for o in n.outputs])
                for n in ff.graph.topo_order()]

    assert describe(jff) == describe(tff)
    assert jff.graph.structure_hash() == tff.graph.structure_hash()
    assert tff.position_table_rows() == jff.position_table_rows() == 16
    jff.graph.infer_shapes()
    from flexflow_tpu.runtime.executor import Executor as JExecutor

    jspecs = JExecutor(jff.graph, None, loss_type=None, metrics=(),
                       optimizer=None).weight_specs()
    tspecs = tff.compile().executor.weight_specs()
    assert {k: {n: (s.shape.dims, s.shape.dtype.value, s.initializer)
                for n, s in w.items()} for k, w in jspecs.items()} == \
        {k: {n: (s.shape.dims, s.shape.dtype.value, s.initializer)
             for n, s in w.items()} for k, w in tspecs.items()}


def test_gpt2_leaves_carry_across_packages():
    """params_from_numpy / params_to_numpy carry every GPT-2 leaf (wte
    kernel, wpe weight, LayerNorm scale/bias, wq..wo and bq..bo, dense
    kernel/bias) exactly; a bf16 model compiled for serving stores the
    LayerNorm leaves and the position table (the reference's fp32
    masters, which their lowerings use as fp32) in fp32, the rest in
    bf16."""
    jff, tff = _pair(16, 1, optimizer=False)
    jtr, jntr = _np_tree(jff._params[0]), _np_tree(jff._params[1])
    got, _ = params_to_numpy(*tff._params)
    names = {(k.rsplit("_", 1)[0], n) for k, w in got.items() for n in w}
    for want in [("wte", "kernel"), ("wpe", "weight"), ("h0_ln1", "scale"),
                 ("h0_ln1", "bias"), ("h1_attn", "wq"), ("h1_attn", "bo"),
                 ("h0_fc", "kernel"), ("h0_fc", "bias"),
                 ("lm_head", "kernel"), ("ln_f", "bias")]:
        assert want in names, want
    assert set(got) == set(jtr)
    for k, w in jtr.items():
        assert set(got[k]) == set(w)
        for n, a in w.items():
            np.testing.assert_array_equal(got[k][n], a)
    bff = FFModel(FFConfig(batch_size=1, device="cpu"))
    build_gpt2(bff, GPT2Config.tiny(), batch_size=1, seq_len=16,
               dtype=DataType.BFLOAT16)
    bff.compile()
    for k, w in bff._params[0].items():
        for n, t in w.items():
            fp32 = k.startswith(("h0_ln", "h1_ln", "ln_f", "wpe"))
            assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), \
                (k, n)


def test_tiny_gpt2_forward_logits_match_jax(monkeypatch):
    """Forward logits (the sink softmax skipped), fp32, seq 128: the JAX
    side through its Pallas K4 in interpret mode."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    jff, tff = _pair(SEQ, 2, optimizer=False)
    x, _ = _tokens(2, SEQ, seed=0)
    jl = jff.executor.run_forward(*jff._params, [jnp.asarray(x)],
                                  training=False, rng=None,
                                  skip_sink_softmax=True)[0]
    assert jax_ops.LAST_ATTENTION_KERNEL == "pallas_flash"
    tl = tff.executor.run_forward(*tff._params, [torch.from_numpy(x)],
                                  skip_sink_softmax=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    probs = tff.predict(x)
    np.testing.assert_allclose(probs, np.asarray(jff.predict(x)), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("remat", ["none", "attention"])
def test_tiny_gpt2_adam_steps_match_jax(monkeypatch, remat):
    """Two Adam steps of the tiny GPT-2 (fp32, seq 128, batch 2): every
    step's loss and every parameter afterwards within TOL, the JAX steps
    through its Pallas K4 forward and backward in interpret mode. lr 1e-4
    for the reason test_torch_training.py's head-dim-128 test gives:
    Adam's first steps move a weight by about lr whatever its gradient,
    so a gradient near 0 turns summation-order noise into an lr-sized
    difference."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    jff, tff = _pair(SEQ, 2, remat=remat, lr=1e-4)
    x, y = _tokens(4, SEQ, seed=1)
    jstep = jff.executor.train_step()
    jtr, jntr = jff._params
    jos = jff._opt_state
    ttr, tntr = tff._params
    tos = tff._opt_state
    for i in range(2):
        bx, by = x[2 * i:2 * i + 2], y[2 * i:2 * i + 2]
        jtr, jntr, jos, jm = jstep(jtr, jntr, jos, jax.random.key(i),
                                   jnp.asarray(by), jnp.asarray(bx))
        ttr, tntr, tos, tm = tff.executor.train_step(
            ttr, tntr, tos, torch.from_numpy(by), torch.from_numpy(bx))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"loss of step {i}")
    assert jax_ops.LAST_ATTENTION_KERNEL == "pallas_flash"
    got, _ = params_to_numpy(ttr, tntr)
    for k, w in jtr.items():
        for n, a in w.items():
            assert got[k][n].dtype == np.float32  # fp32 masters
            np.testing.assert_allclose(got[k][n], np.asarray(a), atol=TOL,
                                       rtol=TOL, err_msg=(k, n))


def test_bf16_gpt2_compiled_to_train_computes_as_the_reference(
        monkeypatch):
    """A tiny GPT-2 declared bf16, compiled to train: the reference's
    position add meets the fp32 master of the table, so jnp promotion
    runs the residual stream, attention (K4 in fp32) and lm_head in fp32
    from there. The port's forward logits have the reference's dtype and
    values, and so do one Adam step's loss and every parameter after it
    (TOL: both run fp32 after the same bf16 embedding gather)."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    jff, tff = _pair(SEQ, 2, lr=1e-4, dtype="BFLOAT16")
    x, y = _tokens(2, SEQ, seed=5)
    jl = jff.executor.run_forward(*jff._params, [jnp.asarray(x)],
                                  training=False, rng=None,
                                  skip_sink_softmax=True)[0]
    tl = tff.executor.run_forward(*tff._params, [torch.from_numpy(x)],
                                  skip_sink_softmax=True)
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    jtr, jntr, _, jm = jff.executor.train_step()(
        *jff._params, jff._opt_state, jax.random.key(0), jnp.asarray(y),
        jnp.asarray(x))
    ttr, _, _, tm = tff.executor.train_step(*tff._params, tff._opt_state,
                                            torch.from_numpy(y),
                                            torch.from_numpy(x))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=TOL, rtol=TOL)
    got, _ = params_to_numpy(ttr, {})
    for k, w in jtr.items():
        for n, a in w.items():
            np.testing.assert_allclose(got[k][n], np.asarray(a), atol=TOL,
                                       rtol=TOL, err_msg=(k, n))


def test_bf16_gpt2_inference_and_paged_serving_compute_as_the_reference(
        monkeypatch):
    """The same bf16 tiny GPT-2 compiled for inference (the reference
    keeps fp32 masters there too): predict's probabilities, the logits'
    dtype, and the paged server's greedy tokens are the reference's."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    jff, tff = _pair(SERVE_SEQ, 1, optimizer=False, dtype="BFLOAT16")
    x, _ = _tokens(1, SERVE_SEQ, seed=6)
    tl = tff.executor.run_forward(*tff._params, [torch.from_numpy(x)],
                                  skip_sink_softmax=True)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tff.predict(x), np.asarray(jff.predict(x)),
                               atol=TOL, rtol=TOL)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in (4, 11)]
    out = []
    for ff in (jff, tff):
        server = ff.serve_generation(slots=2, max_len=SERVE_SEQ, paged=True,
                                     page_size=4)
        try:
            out.append([f.result(timeout=120) for f in
                        [server.submit(p, max_new_tokens=5)
                         for p in prompts]])
        finally:
            server.stop()
    for j, t in zip(*out):
        np.testing.assert_array_equal(t, j)


def test_tiny_gpt2_fit_learns_a_repeated_batch():
    """build_gpt2 -> compile(Adam) -> fit, the training entry points: the
    loss falls over epochs on one repeated batch."""
    ff = FFModel(FFConfig(batch_size=2, seed=1, device="cpu"))
    build_gpt2(ff, GPT2Config.tiny(VOCAB), batch_size=2, seq_len=32)
    ff.compile(optimizer=AdamOptimizer(lr=1e-2),
               metrics=[getattr(MetricsType, m) for m in _METRICS])
    x, y = _tokens(2, 32, seed=2)
    losses = [ff.fit(x, y, verbose=False).sparse_cce_loss for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# the paged server on the tiny GPT-2

_SERVE = []
SERVE_SEQ = 32  # the position table's rows: the servers' max_len


def _serve_models():
    if not _SERVE:
        _SERVE.append(_pair(SERVE_SEQ, 1, optimizer=False))
    return _SERVE[0]


def test_gpt2_ragged_steps_match_jax():
    """Two packed ragged steps on the same pools: two prompt chunks (5 and
    6 rows) beside a pad entry, then a decode row, an 8-row piece
    continuing a prompt, and a decode row near the table's end whose
    padded rows run past it. Probabilities of the live rows and the
    written pools agree at TOL."""
    jff, tff = _serve_models()
    jex, tex = jff.executor, tff.executor
    P, N, MAXP = 4, 16, 8
    jcaches = jex.init_paged_kv_cache(N, P)
    tcaches = tex.init_paged_kv_cache(N, P)
    tables = np.zeros((3, MAXP), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :4] = [2, 9, 5, 11]
    tables[2, :MAXP] = [4, 6, 8, 10, 12, 13, 14, 15]
    rs = np.random.RandomState(4)
    launches = [
        (np.array([0, 0, 0], np.int32), np.array([5, 6, 0], np.int32),
         rs.randint(0, VOCAB, (3, 6)).astype(np.int32)),
        (np.array([5, 6, 29], np.int32), np.array([1, 8, 1], np.int32),
         rs.randint(0, VOCAB, (3, 8)).astype(np.int32)),
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


def test_gpt2_paged_server_greedy_tokens_match_jax():
    """Prompts of 3, 8, 5, 2, 6 and 20 tokens, page 4, 2 slots, 5 new
    tokens (the last request reaches position 24 of the 32-row table):
    the port's paged server emits exactly the JAX paged server's and
    generate()'s tokens, and its pool is clean after the drain."""
    jff, tff = _serve_models()
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32)
               for n in (3, 8, 5, 2, 6, 20)]
    want = [jff.generate(p[None, :], max_new_tokens=5)[0] for p in prompts]
    out = []
    for ff in (jff, tff):
        server = ff.serve_generation(slots=2, max_len=SERVE_SEQ, paged=True,
                                     page_size=4)
        try:
            out.append([f.result(timeout=120) for f in
                        [server.submit(p, max_new_tokens=5)
                         for p in prompts]])
        finally:
            server.stop()
    for w, j, t in zip(want, *out):
        np.testing.assert_array_equal(j, w)
        np.testing.assert_array_equal(t, w)
    assert server.requests_served == len(prompts)
    server.pool.check_invariants(owners={})


def test_gpt2_server_refuses_max_len_past_the_position_table():
    jff, tff = _serve_models()
    for ff in (jff, tff):
        with pytest.raises(ValueError, match="position table"):
            ff.serve_generation(slots=2, max_len=SERVE_SEQ + 1, paged=True,
                                page_size=4)


def test_gpt2_attention_takes_the_head_major_route(monkeypatch):
    """GPT-2's head dim (16 here, 64 at every published size) is not a
    multiple of 128: its attention runs FlashAttentionHeadMajorFunction,
    forward and backward, and never the flat-layout K1/K2 route."""
    from flexflow_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.FlashAttentionHeadMajorFunction.apply

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(fa.FlashAttentionHeadMajorFunction, "apply", counted)
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a: pytest.fail("flat route taken"))
    ff = FFModel(FFConfig(batch_size=2, seed=1, device="cpu", remat="none"))
    cfg = dataclasses.replace(GPT2Config.tiny(VOCAB), layers=3)
    build_gpt2(ff, cfg, batch_size=2, seq_len=16)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3))
    x, y = _tokens(2, 16, seed=3)
    ff.fit(x, y, verbose=False)
    assert calls == [(2 * 4, 16, 16)] * 3
    assert [n.op_type for n in ff.graph.topo_order()].count(
        OpType.LAYER_NORM) == 2 * 3 + 1
