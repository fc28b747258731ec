"""The port's shape ops (FLAT, RESHAPE, TRANSPOSE, REVERSE, CONCAT, SPLIT,
CAST), BATCH_MATMUL (with the seq_length truncation), GATHER, REDUCE_SUM,
MEAN and LSTM held to the JAX package's lowerings on the CPU, outputs
and gradients (jax.value_and_grad against autograd) in fp32 (within
TOL) and bf16 (within BF16_TOL of the largest value;
tests/torch_parity.py); and the registry: every op the JAX package
lowers has a PyTorch lowering."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

import flexflow_tpu.parallel.parallel_ops  # noqa: E402,F401
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import OpType as JOpType  # noqa: E402
from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.ops.registry import _LOWERINGS as J_LOWERINGS  # noqa: E402
from flexflow_tpu_torch.ffconst import DataType, OpType  # noqa: E402
from flexflow_tpu_torch.ops import attrs as A  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.ops.registry import get_lowering  # noqa: E402
from torch_parity import compare  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _cots(outs_shapes, seed=9):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in outs_shapes]


# (name, jax attrs, port attrs, input shapes, output shapes)
SHAPE_CASES = [
    ("flat", JA.FlatAttrs(), A.FlatAttrs(), [(2, 3, 4, 5)], [(2, 60)]),
    ("reshape", JA.ReshapeAttrs((6, 20)), A.ReshapeAttrs((6, 20)),
     [(2, 3, 4, 5)], [(6, 20)]),
    ("transpose", JA.TransposeAttrs((2, 0, 1)), A.TransposeAttrs((2, 0, 1)),
     [(2, 3, 4)], [(4, 2, 3)]),
    ("reverse", JA.ReverseAttrs(1), A.ReverseAttrs(1), [(2, 5, 3)],
     [(2, 5, 3)]),
    ("concat", JA.ConcatAttrs(1), A.ConcatAttrs(1),
     [(2, 3, 4), (2, 1, 4), (2, 2, 4)], [(2, 6, 4)]),
    ("split", JA.SplitAttrs((1, 4, 2), 1), A.SplitAttrs((1, 4, 2), 1),
     [(3, 7, 2)], [(3, 1, 2), (3, 4, 2), (3, 2, 2)]),
    ("cast", JA.CastAttrs(JDataType.BFLOAT16), A.CastAttrs(DataType.BFLOAT16),
     [(3, 5)], [(3, 5)]),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SHAPE_CASES, ids=[c[0] for c in SHAPE_CASES])
def test_shape_ops_match_jax(case, dtype):
    """Each shape op's outputs (SPLIT's list of three) and the gradient
    of every input; the attrs and the inferred shapes agree."""
    name, jat, tat, in_shapes, out_shapes = case
    assert repr(jat).replace("JDataType", "DataType") == repr(tat)
    ins = [_x(*s, seed=i) for i, s in enumerate(in_shapes)]
    lower = {"flat": "_flat", "reshape": "_reshape",
             "transpose": "_transpose", "reverse": "_reverse",
             "concat": "_concat", "split": "_split", "cast": "_cast"}[name]
    outs = compare(getattr(jax_ops, lower), getattr(torch_ops, lower), jat,
                   tat, ins, {}, _cots(out_shapes), dtype)
    assert [o.shape for o in outs] == out_shapes


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq_length", [None, 3])
def test_batch_matmul_matches_jax(seq_length, dtype):
    """(b, m, k) @ (b, k, n) summed in fp32 and rounded once; with
    FFConfig.seq_length a's dim 1 and b's dim 2 are cut to it."""
    a, b = _x(2, 5, 4, seed=1), _x(2, 4, 6, seed=2)
    jat, tat = JA.BatchMatmulAttrs(1, 2), A.BatchMatmulAttrs(1, 2)
    assert repr(jat) == repr(tat)
    n = seq_length or 5
    (y,) = compare(jax_ops._batch_matmul, torch_ops._batch_matmul, jat, tat,
                   [a, b], {}, _cots([(2, n, seq_length or 6)]), dtype,
                   seq_length=seq_length)
    assert y.shape == (2, n, seq_length or 6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_matches_jax(dtype):
    """take_along_axis along dim 1 with int32 indices (torch.gather wants
    int64): output and the gradient of x, repeated indices summed."""
    x = _x(3, 6, 4, seed=3)
    idx = np.random.RandomState(4).randint(0, 6, (3, 5, 4)).astype(np.int32)
    jat, tat = JA.GatherAttrs(1), A.GatherAttrs(1)
    compare(jax_ops._gather, torch_ops._gather, jat, tat, [x, idx], {},
            _cots([(3, 5, 4)]), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,kind,axes,keep", [
    ("reduce", "sum", (1,), False), ("reduce", "mean", (0, 2), True),
    ("mean", "mean", (2, 3), False), ("reduce", "sum", (-1,), True)])
def test_reductions_match_jax(op, kind, axes, keep, dtype):
    """REDUCE_SUM (kind sum or mean) and MEAN (ResNet's global pool over
    (2, 3)) with and without keepdims."""
    x = _x(2, 3, 4, 5, seed=5)
    jat, tat = JA.ReduceAttrs(kind, axes, keep), A.ReduceAttrs(kind, axes,
                                                               keep)
    out_shape = tuple(np.sum(x, axis=axes, keepdims=keep).shape)
    lower = "_reduce" if op == "reduce" else "_mean"
    compare(getattr(jax_ops, lower), getattr(torch_ops, lower), jat, tat,
            [x], {}, _cots([out_shape]), dtype)


def _lstm_params(d, h, bias, seed):
    rs = np.random.RandomState(seed)
    p = {"wx": (rs.randn(d, 4 * h) * 0.3).astype(np.float32),
         "wh": (rs.randn(h, 4 * h) * 0.3).astype(np.float32)}
    if bias:
        p["bias"] = (rs.randn(4 * h) * 0.2).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse,state,bias", [
    (False, False, True), (True, False, True), (False, True, True),
    (True, True, False)])
def test_lstm_matches_jax(reverse, state, bias, dtype):
    """One LSTM layer over 7 steps: forward, reversed, from an initial
    (h0, c0) and without bias; y, h_n and c_n, and the gradients of x,
    h0, c0, wx, wh and bias. bf16 keeps h in bf16 and c in fp32 at the
    reference's rounding points."""
    B, S, D, H = 3, 7, 5, 6
    x = _x(B, S, D, seed=6)
    ins = [x]
    if state:
        ins += [_x(B, H, seed=7) * 0.5, _x(B, H, seed=8) * 0.5]
    params = _lstm_params(D, H, bias, 10)
    jat, tat = JA.LSTMAttrs(H, bias, reverse), A.LSTMAttrs(H, bias, reverse)
    assert repr(jat) == repr(tat)
    y, hn, cn = compare(jax_ops._lstm, torch_ops._lstm, jat, tat, ins,
                        params, _cots([(B, S, H), (B, H), (B, H)]), dtype)
    # the final state is the last step's output (the first, reversed)
    np.testing.assert_array_equal(hn, y[:, 0 if reverse else -1])


def test_every_reference_lowering_has_a_port_lowering():
    """Enumerating OpType: every op the JAX package lowers (jax_ops and
    the parallel ops, PIPELINE and CACHE among them) has a PyTorch
    lowering in the port; the ops neither package lowers (FUSED, LOSS,
    METRICS) raise."""
    missing, refused = [], []
    for op in OpType:
        jop = JOpType(op.value)
        try:
            get_lowering(op)
        except NotImplementedError:
            refused.append(op)
            continue
        assert callable(get_lowering(op))
        if jop not in J_LOWERINGS:
            missing.append(op)
    assert sorted(o.value for o in refused) == sorted(
        o.value for o in OpType if JOpType(o.value) not in J_LOWERINGS)
    assert OpType.PIPELINE not in refused and OpType.CACHE not in refused
    assert not missing, missing
    assert {o.value for o in OpType} == {o.value for o in JOpType}
