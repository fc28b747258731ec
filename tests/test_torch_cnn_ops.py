"""The port's CONV2D, POOL2D and BATCH_NORM lowerings held to the JAX
package's on the CPU: the same numpy inputs through jax_ops and
torch_ops, the outputs and the gradients of every input and weight
(jax.value_and_grad against autograd), and BatchNorm's running
statistics, in fp32 (within TOL) and bf16 (within BF16_TOL of the
largest value; tests/torch_parity.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from flexflow_tpu.ffconst import ActiMode as JActiMode  # noqa: E402
from flexflow_tpu.ffconst import PoolType as JPoolType  # noqa: E402
from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu_torch.ffconst import ActiMode, PoolType  # noqa: E402
from flexflow_tpu_torch.ops import attrs as A  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.ops.registry import LowerCtx  # noqa: E402
from flexflow_tpu_torch.pcg.tensor import (  # noqa: E402
    ParallelTensorShape,
    TensorShape,
)
from torch_parity import compare  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


def _rs(seed):
    return np.random.RandomState(seed)


# (in channels, out channels, groups, stride, padding, bias, activation)
CONV_CASES = [
    (4, 6, 1, (1, 1), (1, 1), True, "RELU"),
    (4, 8, 2, (2, 1), (2, 0), True, "NONE"),    # grouped, per-side pads
    (6, 6, 3, (1, 2), (0, 1), False, "NONE"),   # ResNeXt-style, no bias
    (3, 4, 1, (2, 2), (3, 3), True, "SIGMOID"),  # a 7x7 stem
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv2d_matches_jax(case, dtype):
    """Groups, stride, padding per spatial dim, bias and the fused
    activation: output and the gradients of x, kernel and bias. bf16
    compares the output alone: the reference's bf16 convolution
    (preferred_element_type fp32) has no gradient in this JAX, whose
    transpose rule refuses the fp32 cotangent against the bf16 kernel."""
    cin, cout, groups, stride, pad, bias, act = case
    k = (7, 7) if pad == (3, 3) else (3, 3)
    rs = _rs(1)
    x = rs.randn(2, cin, 9, 8).astype(np.float32)
    params = {"kernel": (rs.randn(cout, cin // groups, *k) * 0.3)
              .astype(np.float32)}
    if bias:
        params["bias"] = rs.randn(cout).astype(np.float32)
    jat = JA.Conv2DAttrs(cout, k, stride, pad, groups, bias,
                         getattr(JActiMode, act))
    tat = A.Conv2DAttrs(cout, k, stride, pad, groups, bias,
                        getattr(ActiMode, act))
    assert repr(jat).replace("JActiMode", "") == repr(tat)
    out_shape = tuple(d.size for d in tat.infer(
        _shape(x.shape))[0].dims)
    cot = rs.randn(*out_shape).astype(np.float32)
    (y,) = compare(jax_ops._conv2d, torch_ops._conv2d, jat, tat, [x],
                   params, [cot], dtype, grad=dtype == torch.float32)
    assert y.shape == out_shape


def _shape(dims):
    return ParallelTensorShape.from_shape(TensorShape(tuple(dims)))


# (kernel, stride, padding, pool type, activation): AlexNet's and
# ResNet's max pools, Inception's padded average pool, a padding above
# half the kernel (which F.max_pool2d alone refuses)
POOL_CASES = [
    ((3, 3), (2, 2), (0, 0), "MAX", "NONE"),
    ((3, 3), (2, 2), (1, 1), "MAX", "RELU"),
    ((3, 3), (1, 1), (1, 1), "AVG", "NONE"),
    ((3, 2), (2, 1), (2, 1), "MAX", "NONE"),
    ((2, 2), (2, 2), (1, 2), "AVG", "TANH"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", POOL_CASES)
def test_pool2d_matches_jax(case, dtype):
    """Max pads with -inf, average divides by kh * kw with the padding
    counted: output and the gradient of x."""
    kernel, stride, pad, ptype, act = case
    rs = _rs(2)
    x = rs.randn(2, 3, 9, 10).astype(np.float32)
    jat = JA.Pool2DAttrs(kernel, stride, pad, getattr(JPoolType, ptype),
                         getattr(JActiMode, act))
    tat = A.Pool2DAttrs(kernel, stride, pad, getattr(PoolType, ptype),
                        getattr(ActiMode, act))
    assert (repr(jat).replace("JActiMode", "").replace("JPoolType", "")
            == repr(tat))
    out_shape = tuple(d.size for d in tat.infer(_shape(x.shape))[0].dims)
    cot = rs.randn(*out_shape).astype(np.float32)
    compare(jax_ops._pool2d, torch_ops._pool2d, jat, tat, [x], {}, [cot],
            dtype)


def _bn_params(rs, c):
    return {"scale": (1 + 0.2 * rs.randn(c)).astype(np.float32),
            "bias": (0.3 * rs.randn(c)).astype(np.float32),
            "running_mean": (0.5 * rs.randn(c)).astype(np.float32),
            "running_var": (1 + rs.rand(c)).astype(np.float32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_matches_jax(relu, training, dtype):
    """Training: batch mean and biased variance over (N, H, W), both
    running statistics moved with momentum 0.1 (the biased variance),
    and the gradients of x, scale and bias through the batch statistics;
    eval: the running statistics, which do not move."""
    rs = _rs(3)
    x = (2.0 + 1.5 * rs.randn(4, 5, 6, 7)).astype(np.float32)
    params = _bn_params(rs, 5)
    jat, tat = JA.BatchNormAttrs(relu), A.BatchNormAttrs(relu)
    assert repr(jat) == repr(tat)
    cot = rs.randn(*x.shape).astype(np.float32)
    trainable = {k: params[k] for k in ("scale", "bias")}
    stats = {k: params[k] for k in ("running_mean", "running_var")}

    def jlow(attrs, ins, ps, ctx):
        return jax_ops._batch_norm(attrs, ins, {**ps, **stats}, ctx)

    def tlow(attrs, ins, ps, ctx):
        out = torch_ops._batch_norm(
            attrs, ins, {**ps, **{k: torch.from_numpy(v)
                                  for k, v in stats.items()}}, ctx)
        if training:
            # the moved statistics are data, not part of the graph
            assert not any(v.requires_grad
                           for v in ctx.state_updates.values())
        return out

    compare(jlow, tlow, jat, tat, [x], trainable, [cot], dtype,
            training=training)
    if training:
        # the update itself, against the formula with the biased variance
        ctx = LowerCtx(training=True)
        torch_ops._batch_norm(tat, [torch.from_numpy(x)], {
            k: torch.from_numpy(v) for k, v in params.items()}, ctx)
        mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
        np.testing.assert_allclose(
            ctx.state_updates["running_var"].numpy(),
            0.9 * params["running_var"] + 0.1 * var, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            ctx.state_updates["running_mean"].numpy(),
            0.9 * params["running_mean"] + 0.1 * mean, rtol=1e-5, atol=1e-5)
