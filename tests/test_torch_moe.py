"""The port's TOPK and MoE lowerings (GROUP_BY, AGGREGATE, AGGREGATE_SPEC,
EXPERTS) held to the JAX reference on the CPU: the same numpy inputs
through jax_ops and torch_ops, outputs, load-balance terms and gradients,
the tie order of top-k and the (row, choice) pairs dropped at capacity;
then the MoE classifiers trained three SGD steps in both packages from
the same weights (runtime.weights.params_from_numpy)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import ActiMode as JActiMode  # noqa: E402
from flexflow_tpu.ffconst import MetricsType as JMetricsType  # noqa: E402
from flexflow_tpu.models import mixtral as jmixtral  # noqa: E402
from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.ops.registry import LowerCtx as JCtx  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    ActiMode,
    FFConfig,
    FFModel,
    MetricsType,
    SGDOptimizer,
)
from flexflow_tpu_torch.models import mixtral  # noqa: E402
from flexflow_tpu_torch.ops import attrs as A  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.ops.registry import LowerCtx  # noqa: E402
from flexflow_tpu_torch.runtime.weights import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)

# fp32 on the CPU, same inputs: summation order only (test_align's bar)
TOL = 1e-4
# bf16 forward: no catalog entry in analysis/num_budgets.py covers the
# expert bank, so the bound is chip_smoke's bf16 kernel bar: max |err|
# <= 2e-2 * max(1, max |JAX|) (bf16's 8 mantissa bits, rounded at the
# two matmuls, the activation and the weighted k-sum)
BF16_TOL = 2e-2


def test_topk_matches_lax_top_k_with_planted_ties():
    """Values equal in many places (small integers, fp32 and bf16): the
    port's TOPK gives lax.top_k's values and int32 indices exactly, the
    lower index first on a tie."""
    rs = np.random.RandomState(0)
    x = rs.randint(0, 4, (6, 5, 9)).astype(np.float32)
    x[0, 0] = 1.0  # a row of nine equal values
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        for k in (1, 3, 9):
            jv, ji = lax.top_k(jnp.asarray(x, jdt), k)
            tv, ti = torch_ops._topk(A.TopKAttrs(k), [
                torch.from_numpy(x).to(dt)], {}, LowerCtx())
            assert ti.dtype == torch.int32
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.float().numpy(),
                                          np.asarray(jv, np.float32))
    assert ti[0, 0].tolist() == list(range(9))


def _moe_inputs(t, d, n, h, o, seed, lead=None):
    rs = np.random.RandomState(seed)
    lead = lead or (t,)
    x = rs.randn(*lead, d).astype(np.float32)
    gl = (rs.randn(*lead, n) * 2).astype(np.float32)
    w1 = (rs.randn(n, d, h) * 0.1).astype(np.float32)
    w2 = (rs.randn(n, h, o) * 0.1).astype(np.float32)
    cot = rs.randn(*lead, o).astype(np.float32)
    return x, gl, w1, w2, cot


def _jax_experts(at, x, gl, w1, w2, cot):
    """(y, aux, grads of (x, gl, w1, w2)) of sum(y * cot) + aux."""

    def f(x, gl, w1, w2):
        ctx = JCtx(training=True, rng=None, mesh=None)
        y = jax_ops._experts(at, [x, gl], {"w1": w1, "w2": w2}, ctx)[0]
        aux = ctx.state_updates["__aux_loss__"]
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (x, gl, w1, w2)))
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _torch_experts(at, x, gl, w1, w2, cot, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (x, gl, w1, w2)]
    ctx = LowerCtx(training=True)
    y = torch_ops._experts(at, leaves[:2], {"w1": leaves[2],
                                            "w2": leaves[3]}, ctx)[0]
    ((y.float() * torch.from_numpy(cot)).sum() + ctx.aux_loss).backward()
    return (y.detach().float().numpy(), float(ctx.aux_loss.detach()),
            [t.grad.float().numpy() for t in leaves])


@pytest.mark.parametrize("lead", [None, (2, 32)])  # (t, d) and (B, S, d)
@pytest.mark.parametrize("dispatch", ["sort", "dense"])
@pytest.mark.parametrize("alpha", [2.0, 0.5])  # ample and binding capacity
def test_experts_match_jax_forward_aux_and_gradients(alpha, dispatch, lead):
    """EXPERTS at 64 rows, 8 experts top-2 (GELU, normalized), both
    dispatches against the JAX lowering with the same dispatch: output,
    load-balance term, and the gradients of x, the gate logits, w1 and
    w2, fp32 within TOL. At alpha 0.5 a quarter of the (row, choice)
    pairs find their expert full."""
    t, d, n, k, h, o = 64, 16, 8, 2, 32, 16
    x, gl, w1, w2, cot = _moe_inputs(t, d, n, h, o, seed=1, lead=lead)
    jat = JA.ExpertsAttrs(n, k, h, o, alpha, dispatch=dispatch)
    tat = A.ExpertsAttrs(n, k, h, o, alpha, dispatch=dispatch)
    assert repr(jat).replace("JActiMode", "") == repr(tat)
    jy, jaux, jg = _jax_experts(jat, x, gl, w1, w2, cot)
    ty, taux, tg = _torch_experts(tat, x, gl, w1, w2, cot)
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux, jaux, atol=TOL, rtol=TOL)
    for a, b, nm in zip(tg, jg, ("x", "gate", "w1", "w2")):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=nm)


def _dropped(slot_of_flat, t, k, n, cap):
    """{(row, choice)} whose slot went to the cut-off row n * cap."""
    return {(f % t, f // t) for f in np.flatnonzero(
        np.asarray(slot_of_flat) == n * cap)}


@pytest.mark.parametrize("alpha", [8.0, 1.25, 0.5])
def test_sort_plan_drops_the_pairs_jax_drops(alpha):
    """The sort plan of 256 rows, 8 experts top-2 on a skewed gate (at
    Mixtral's alpha 1.25 some pairs must drop; at 8.0 every expert could
    take every pair): the same buffer row for
    every (row, choice) as jax_ops._sorted_dispatch, the same kept count
    per expert, and the same dropped pairs as the dense one-hot mask."""
    t, n, k = 256, 8, 2
    rs = np.random.RandomState(4)
    logits = rs.randn(t, n) + np.linspace(0.0, 2.0, n)  # skewed to e7
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    _, topi = lax.top_k(probs, k)
    topi = np.array(topi, np.int32)
    cap = A.ExpertsAttrs(n, k, 32, 16, alpha).capacity(t)
    j_slot, j_kept = jax_ops._sorted_dispatch(jnp.asarray(topi), t, n, cap)
    t_slot, t_kept = torch_ops.sorted_dispatch(torch.from_numpy(topi), n,
                                               cap)
    np.testing.assert_array_equal(t_slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(t_kept.numpy(), np.asarray(j_kept))
    dropped = _dropped(t_slot.numpy(), t, k, n, cap)
    disp = torch_ops.dispatch_mask(torch.from_numpy(topi), n, cap)
    kept_dense = disp.sum(dim=(2, 3)).numpy()            # (t, k) 0 or 1
    assert dropped == {(r, c) for r, c in zip(*np.nonzero(kept_dense == 0))}
    if alpha < 8.0:
        assert dropped  # capacity binds: the drop path runs
    else:
        assert not dropped


def test_experts_bf16_forward_within_budget():
    """bf16 inputs and weights, sort dispatch at Mixtral's alpha 1.25 and
    SiLU, against the JAX lowering in bf16: the output within BF16_TOL
    of the largest value (the gates are chosen in fp32 from the same
    bf16 logits, so both route alike)."""
    t, d, n, k, h, o = 64, 32, 8, 2, 64, 32
    x, gl, w1, w2, _ = _moe_inputs(t, d, n, h, o, seed=2)
    jat = JA.ExpertsAttrs(n, k, h, o, 1.25, JActiMode.SILU)
    tat = A.ExpertsAttrs(n, k, h, o, 1.25, ActiMode.SILU)
    jy = np.asarray(jax_ops._experts(
        jat, [jnp.asarray(x, jnp.bfloat16), jnp.asarray(gl, jnp.bfloat16)],
        {"w1": jnp.asarray(w1, jnp.bfloat16),
         "w2": jnp.asarray(w2, jnp.bfloat16)},
        JCtx(training=False, rng=None, mesh=None))[0], np.float32)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, gl, w1, w2)]
    ty = torch_ops._experts(tat, bf[:2], {"w1": bf[2], "w2": bf[3]},
                            LowerCtx())[0]
    assert ty.dtype == torch.bfloat16
    err = np.abs(ty.float().numpy() - jy).max()
    assert err <= BF16_TOL * max(1.0, np.abs(jy).max()), err


def _aggregate_inputs(seed, b=12, k=2, n=4, d=5, cap=5):
    """AGGREGATE's inputs at a binding capacity: top-k of a softmax gate,
    expert outputs (cap, d) each, and a cotangent."""
    rs = np.random.RandomState(seed)
    gate = rs.rand(b, n).astype(np.float32) + 0.1
    gate = (gate / gate.sum(-1, keepdims=True)).astype(np.float32)
    topi = np.argsort(-gate, axis=1, kind="stable")[:, :k].astype(np.int32)
    topv = np.take_along_axis(gate, topi, axis=1)
    experts = [rs.randn(cap, d).astype(np.float32) for _ in range(n)]
    return gate, topi, topv, experts


@pytest.mark.parametrize("op", ["aggregate", "aggregate_spec"])
def test_aggregate_ops_match_jax_with_gate_gradient(op):
    """AGGREGATE (lambda_bal 0.04, training: its load-balance gradient
    reaches the full gate) and AGGREGATE_SPEC (per-slot rows) against
    the JAX lowerings: output and the gradients of the gate values, the
    full gate and every expert output, fp32 within TOL."""
    gate, topi, topv, experts = _aggregate_inputs(5)
    n = gate.shape[1]
    jop, top = {"aggregate": (jax_ops._aggregate, torch_ops._aggregate),
                "aggregate_spec": (jax_ops._aggregate_spec,
                                   torch_ops._aggregate_spec)}[op]
    jat = (JA.AggregateAttrs if op == "aggregate"
           else JA.AggregateSpecAttrs)(n, 0.04)
    tat = (A.AggregateAttrs if op == "aggregate"
           else A.AggregateSpecAttrs)(n, 0.04)
    out_rows = gate.shape[0] * (1 if op == "aggregate" else topi.shape[1])
    cot = np.random.RandomState(6).randn(out_rows, 5).astype(np.float32)

    def jf(tv, g, *ex):
        ctx = JCtx(training=True, rng=None, mesh=None)
        y = jop(jat, [tv, jnp.asarray(topi), jnp.asarray(topi), g]
                + list(ex), {}, ctx)[0]
        aux = ctx.state_updates.get("__aux_loss__", 0.0)
        return jnp.sum(y * cot) + aux, y

    (_, jy), jg = jax.value_and_grad(
        jf, argnums=tuple(range(2 + n)), has_aux=True)(
        jnp.asarray(topv), jnp.asarray(gate),
        *(jnp.asarray(e) for e in experts))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in [topv, gate] + experts]
    ctx = LowerCtx(training=True)
    ty = top(tat, [leaves[0], torch.from_numpy(topi),
                   torch.from_numpy(topi), leaves[1]] + leaves[2:], {},
             ctx)[0]
    total = (ty * torch.from_numpy(cot)).sum()
    if op == "aggregate":
        assert ctx.aux_loss is not None
        total = total + ctx.aux_loss
    else:
        assert ctx.aux_loss is None
    total.backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=TOL, rtol=TOL)
    for i, (leaf, g) in enumerate(zip(leaves, jg)):
        got = (leaf.grad if leaf.grad is not None
               else torch.zeros_like(leaf)).numpy()
        np.testing.assert_allclose(got, np.asarray(g), atol=TOL, rtol=TOL,
                                   err_msg=str(i))
    if op == "aggregate":  # the gate gradient is the load-balance term's
        assert np.abs(leaves[1].grad.numpy()).max() > 0


def test_group_by_matches_jax():
    """GROUP_BY at a binding capacity (alpha 0.75): every expert's (cap,
    d) buffer equals the JAX lowering's, and so does the gradient of x."""
    rs = np.random.RandomState(7)
    b, d, n, k = 12, 5, 4, 2
    x = rs.randn(b, d).astype(np.float32)
    assign = np.stack([rs.permutation(n)[:k] for _ in range(b)]).astype(
        np.int32)
    jat, tat = JA.GroupByAttrs(n, 0.75), A.GroupByAttrs(n, 0.75)
    cap = tat.capacity(b, k)
    cot = rs.randn(n, cap, d).astype(np.float32)

    def jf(x):
        outs = jax_ops._group_by(jat, [x, jnp.asarray(assign)], {}, JCtx())
        return jnp.sum(jnp.stack(outs) * cot), outs

    (_, jouts), jgx = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    touts = torch_ops._group_by(tat, [tx, torch.from_numpy(assign)], {},
                                LowerCtx())
    assert len(touts) == n and touts[0].shape == (cap, d)
    (torch.stack(touts) * torch.from_numpy(cot)).sum().backward()
    for a, b_ in zip(touts, jouts):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b_),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=TOL,
                               rtol=TOL)


_METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")


@pytest.mark.parametrize("builder", ["build_moe_classifier",
                                     "build_moe_spec_classifier"])
def test_moe_classifiers_train_like_jax(builder):
    """The composite MoE classifier (top_k -> group_by -> experts ->
    aggregate, lambda_bal 0.04) and the speculative head (AGGREGATE_SPEC,
    each label repeated per slot): the same PCG node names, then three
    SGD steps from the JAX weights give JAX's losses and accuracy counts
    and parameters within TOL."""
    b, d, classes = 8, 16, 5
    jff = JFFModel(JFFConfig(batch_size=b, seed=3, num_devices=1))
    getattr(jmixtral, builder)(jff, d, classes)
    jff.compile(optimizer=jopt.SGDOptimizer(lr=0.1),
                metrics=[getattr(JMetricsType, m) for m in _METRICS])
    tff = FFModel(FFConfig(batch_size=b, seed=3, device="cpu"))
    getattr(mixtral, builder)(tff, d, classes)
    assert ([n.name for n in tff.graph.topo_order()]
            == [n.name for n in jff.graph.topo_order()])
    tff.compile(optimizer=SGDOptimizer(lr=0.1),
                metrics=[getattr(MetricsType, m) for m in _METRICS],
                params=params_from_numpy(
                    *({k: {n: np.array(a) for n, a in w.items()}
                       for k, w in tree.items()} for tree in jff._params),
                    device="cpu"))
    want = 2 if builder == "build_moe_spec_classifier" else 1
    assert tff.executor.label_repeats == jff.executor.label_repeats == want
    rs = np.random.RandomState(8)
    jstep = jff.executor.train_step()
    jtr, jntr = jff._params
    jos = jff._opt_state
    ttr, tntr = tff._params
    tos = tff._opt_state
    for i in range(3):
        x = rs.randn(b, d).astype(np.float32)
        y = rs.randint(0, classes, b).astype(np.int32)
        jtr, jntr, jos, jm = jstep(jtr, jntr, jos, jax.random.key(i),
                                   jnp.asarray(y), jnp.asarray(x))
        ttr, tntr, tos, tm = tff.executor.train_step(
            ttr, tntr, tos, torch.from_numpy(y), torch.from_numpy(x))
        for key in ("loss", "accuracy_correct"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{key} of step {i}")
    got, _ = params_to_numpy(ttr, tntr)
    for k, w in jtr.items():
        for n, a in w.items():
            np.testing.assert_allclose(got[k][n], np.asarray(a), atol=TOL,
                                       rtol=TOL, err_msg=(k, n))
