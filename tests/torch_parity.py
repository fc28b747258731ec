"""Shared by the port's parity tests: run one lowering of each package on
the same numpy inputs and return outputs, gradients and state updates
as fp32 numpy.

`run_jax(lower, attrs, ins, params, cots, ...)` differentiates
sum(out_i * cot_i) over the floating inputs and every parameter with
jax.value_and_grad; `run_torch` does the same with autograd. Floating
inputs are cast to `dtype` on both sides (jnp and torch round fp32 to
bf16 alike); parameters stay fp32, as the executors' masters are."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from flexflow_tpu.ops.registry import LowerCtx as JCtx
from flexflow_tpu_torch.ops.registry import LowerCtx

# fp32 on the CPU, same inputs: summation order only (test_align's bar)
TOL = 1e-4
# bf16: no catalog entry in analysis/num_budgets.py covers these ops, so
# the bound is chip_smoke's bf16 kernel bar, max |err| <= 2e-2 * max(1,
# max |JAX|): bf16's 8 mantissa bits, rounded where both packages round
BF16_TOL = 2e-2

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _is_float(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def run_jax(lower, attrs, ins, params, cots, dtype=torch.float32,
            training=False, seq_length=None, rng=None, grad=True):
    """(outputs, input grads (None for int inputs), param grads, state
    updates), each fp32 numpy; without `grad` the gradients are empty."""
    jdt = JDT[dtype]
    fl = [i for i, a in enumerate(ins) if _is_float(a)]
    jins = [jnp.asarray(a, jdt) if _is_float(a) else jnp.asarray(a)
            for a in ins]
    jparams = {k: jnp.asarray(v) for k, v in params.items()}

    def f(fins, fparams):
        full = list(jins)
        for i, a in zip(fl, fins):
            full[i] = a
        ctx = JCtx(training=training, rng=rng, mesh=None,
                   seq_length=seq_length)
        outs = lower(attrs, full, fparams, ctx)
        loss = sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(outs, cots) if c is not None)
        return loss, (outs, dict(ctx.state_updates))

    if not grad:
        _, (outs, state) = f([jins[i] for i in fl], jparams)
        return ([_np(o) for o in outs], [None] * len(ins), {},
                {k: _np(v) for k, v in state.items()})
    (_, (outs, state)), (gi, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))([jins[i] for i in fl], jparams)
    grads_in = [None] * len(ins)
    for i, g in zip(fl, gi):
        grads_in[i] = _np(g)
    return ([_np(o) for o in outs], grads_in,
            {k: _np(v) for k, v in gp.items()},
            {k: _np(v) for k, v in state.items()})


def run_torch(lower, attrs, ins, params, cots, dtype=torch.float32,
              training=False, seq_length=None, rng_seed=None, grad=True):
    """run_jax's counterpart through the port's lowering and autograd."""
    tins = []
    for a in ins:
        t = torch.from_numpy(np.array(a))
        if _is_float(a):
            t = t.to(dtype).requires_grad_()
        tins.append(t)
    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in params.items()}
    ctx = LowerCtx(training=training, seq_length=seq_length,
                   rng_seed=rng_seed)
    outs = lower(attrs, tins, tparams, ctx)
    loss = sum((o.float() * torch.from_numpy(np.asarray(c))).sum()
               for o, c in zip(outs, cots) if c is not None)
    if grad and isinstance(loss, torch.Tensor) and loss.requires_grad:
        loss.backward()
    return ([_np(o) for o in outs],
            [None if not t.is_floating_point() else
             (np.zeros(t.shape, np.float32) if t.grad is None
              else _np(t.grad)) for t in tins],
            {k: (np.zeros(v.shape, np.float32) if v.grad is None
                 else _np(v.grad)) for k, v in tparams.items()},
            {k: _np(v) for k, v in ctx.state_updates.items()})


def assert_close(got, want, dtype, what=""):
    """fp32: within TOL (abs and rel); bf16: max |err| within BF16_TOL *
    max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=what)
    else:
        err = float(np.abs(got - want).max()) if got.size else 0.0
        bound = BF16_TOL * max(1.0, float(np.abs(want).max()))
        assert err <= bound, (what, err, bound)


def compare(lower_j, lower_t, jattrs, tattrs, ins, params, cots,
            dtype=torch.float32, **kw):
    """Outputs, every gradient and every state update of the two
    lowerings, within assert_close. Returns the port's outputs."""
    rng = kw.pop("rng", None)
    rng_seed = kw.pop("rng_seed", None)
    jo, jgi, jgp, jst = run_jax(lower_j, jattrs, ins, params, cots, dtype,
                                rng=rng, **kw)
    to, tgi, tgp, tst = run_torch(lower_t, tattrs, ins, params, cots,
                                  dtype, rng_seed=rng_seed, **kw)
    assert len(to) == len(jo)
    for i, (a, b) in enumerate(zip(to, jo)):
        assert_close(a, b, dtype, f"output {i}")
    for i, (a, b) in enumerate(zip(tgi, jgi)):
        if b is not None:
            assert_close(a, b, dtype, f"grad of input {i}")
    for k in jgp:
        assert_close(tgp[k], jgp[k], dtype, f"grad of {k}")
    assert sorted(tst) == sorted(jst)
    for k in jst:
        assert_close(tst[k], jst[k], dtype, f"state {k}")
    return to


# ---------------------------------------------------------------------------
# whole models: one builder in both packages


def graph_summary(graph):
    """Per node in topological order: name, stable key, op type, attrs
    repr, output dims and dtypes, and weight specs (shape, dtype,
    initializer, trainable). The enums of both packages share their
    class names, so the reprs compare as strings."""
    rows = []
    for n in graph.topo_order():
        ws = n.attrs.weights(*graph.input_shapes(n)) if n.attrs else {}
        rows.append((
            n.name, n.stable_key(), n.op_type.value, repr(n.attrs),
            [(tuple(d.size for d in o.dims), o.dtype.value)
             for o in n.outputs],
            {k: (tuple(w.shape.dims), w.shape.dtype.value, w.initializer,
                 w.trainable) for k, w in sorted(ws.items())}))
    return rows


def numpy_init(monkeypatch, seed=0):
    """Draw the JAX package's parameters with numpy in place of its
    per-leaf jax.random draws (a compile each, most of a ResNet's
    compile() on the CPU): glorot-uniform kernels, the declared ones and
    zeros, unit normals for "normal" leaves, every leaf fp32, as the
    reference's masters are. The port takes the same values through
    runtime.weights.params_from_numpy."""
    from flexflow_tpu.runtime.executor import Executor

    def init_params(self, rng, overrides=None, weight_dtype=None):
        rs = np.random.RandomState(seed)
        tr, ntr = {}, {}
        for nk, ws in sorted(self.weight_specs().items()):
            for wn, spec in sorted(ws.items()):
                shape = tuple(spec.shape.dims)
                if spec.initializer == "zeros":
                    a = np.zeros(shape, np.float32)
                elif spec.initializer == "ones":
                    a = np.ones(shape, np.float32)
                elif spec.initializer == "normal":
                    a = rs.randn(*shape).astype(np.float32)
                else:
                    rf = int(np.prod(shape[2:])) if len(shape) == 4 else 1
                    if len(shape) == 4:
                        fan_in, fan_out = shape[1] * rf, shape[0] * rf
                    else:
                        fan_in = int(np.prod(shape[:-1]))
                        fan_out = shape[-1]
                    lim = np.sqrt(6.0 / (fan_in + fan_out))
                    a = rs.uniform(-lim, lim, shape).astype(np.float32)
                d = tr if spec.trainable else ntr
                d.setdefault(nk, {})[wn] = jnp.asarray(a)
        return tr, ntr

    monkeypatch.setattr(Executor, "init_params", init_params)


def model_pair(monkeypatch, build_j, build_t, batch, loss, lr=1.0, seed=3):
    """(JAX FFModel, port FFModel) built by the two builders, compiled
    with SGD at `lr` and `loss`, the port's weights carried from the
    JAX model's (numpy_init)."""
    from flexflow_tpu import FFConfig as JFFConfig
    from flexflow_tpu import FFModel as JFFModel
    from flexflow_tpu.ffconst import LossType as JLossType
    from flexflow_tpu.runtime import optimizer as jopt
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.runtime.weights import params_from_numpy

    numpy_init(monkeypatch, seed)
    jff = JFFModel(JFFConfig(batch_size=batch, seed=seed, num_devices=1))
    build_j(jff)
    jff.compile(optimizer=jopt.SGDOptimizer(lr=lr),
                loss_type=getattr(JLossType, loss.name))
    tff = FFModel(FFConfig(batch_size=batch, seed=seed, device="cpu"))
    build_t(tff)
    assert graph_summary(tff.graph) == graph_summary(jff.graph)
    tff.compile(optimizer=SGDOptimizer(lr=lr), loss_type=loss,
                params=params_from_numpy(
                    *({k: {n: np.array(a) for n, a in w.items()}
                       for k, w in tree.items()} for tree in jff._params),
                    device="cpu"))
    return jff, tff


def check_forward_and_step(jff, tff, xs, y, tol=TOL, update_cos=None):
    """predict (eval: BatchNorm on its running statistics, dropout off)
    equal; then one train step of each: the loss, every trainable leaf
    and every non-trainable leaf (BatchNorm's moved running statistics)
    equal within `tol`. With `update_cos` the trainable leaves are held
    by their update instead (before - after, lr times the gradient): its
    cosine with the reference's at least `update_cos` wherever the
    reference's gradient is not rounding noise (largest entry above
    1e-4), and below 1e-4 everywhere where it is. Returns the port's
    non-trainable tree before and after the step."""
    from flexflow_tpu_torch.runtime.weights import params_to_numpy

    np.testing.assert_allclose(tff.predict(xs), jff.predict(xs), atol=tol,
                               rtol=tol, err_msg="predict")
    # the port's step updates its masters in place: keep the start
    before = {k: {n: a.copy() for n, a in w.items()}
              for k, w in params_to_numpy(tff._params[0], {})[0].items()}
    jstep = jff.executor.train_step()
    jtr, jntr = jff._params
    jtr, jntr, _, jm = jstep(jtr, jntr, jff._opt_state, jax.random.key(0),
                             jnp.asarray(y), *(jnp.asarray(a) for a in xs))
    ttr, tntr0 = tff._params
    ttr, tntr, _, tm = tff.executor.train_step(
        ttr, tntr0, tff._opt_state, torch.from_numpy(y),
        *(torch.from_numpy(a) for a in xs))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=tol, rtol=tol, err_msg="loss")
    got_tr, got_ntr = params_to_numpy(ttr, tntr)
    pairs = [(got_tr, jtr), (got_ntr, jntr)]
    if update_cos is not None:
        pairs = pairs[1:]
        for k, w in jtr.items():
            for n, a in w.items():
                want = (before[k][n] - np.asarray(a)).ravel()
                got = (before[k][n] - got_tr[k][n]).ravel()
                lr = jff._optimizer.lr
                if np.abs(want).max() <= 1e-4 * lr:
                    assert np.abs(got).max() <= 1e-4 * lr, (k, n)
                    continue
                cos = float(got @ want / np.linalg.norm(got)
                            / np.linalg.norm(want))
                assert cos >= update_cos, (k, n, cos)
    for tree_got, tree_want in pairs:
        assert sorted(tree_got) == sorted(tree_want)
        for k, w in tree_want.items():
            for n, a in w.items():
                np.testing.assert_allclose(tree_got[k][n], np.asarray(a),
                                           atol=tol, rtol=tol,
                                           err_msg=f"{k}/{n}")
    return tntr0, tntr
