"""Each Llama-path lowering of the port held to its flexflow_tpu.ops.jax_ops
counterpart: the same numpy inputs and weights, fp32, on the CPU."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.ffconst import ActiMode as JActiMode  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import OpType as JOpType  # noqa: E402
from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.ops.registry import LowerCtx as JLowerCtx  # noqa: E402
from flexflow_tpu.ops.registry import get_lowering as jget  # noqa: E402
from flexflow_tpu_torch.ffconst import ActiMode, DataType, OpType  # noqa: E402
from flexflow_tpu_torch.ops import attrs as A  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.ops.registry import LowerCtx, get_lowering  # noqa: E402

# fp32, same inputs: differences are summation order and libm ulps only
TOL = 1e-5


def _run(op, jattrs, tattrs, inputs, params, jctx=None, tctx=None):
    jout = jget(getattr(JOpType, op.name))(
        jattrs, [jnp.asarray(x) for x in inputs],
        {k: jnp.asarray(v) for k, v in params.items()},
        jctx or JLowerCtx(training=False))
    tout = get_lowering(op)(
        tattrs, [torch.from_numpy(x) for x in inputs],
        {k: torch.from_numpy(v) for k, v in params.items()},
        tctx or LowerCtx())
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL)


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("use_bias,act", [(False, "none"), (True, "silu"),
                                          (True, "relu")])
def test_linear(use_bias, act):
    rs = np.random.RandomState(0)
    params = {"kernel": _rand(rs, 16, 24)}
    if use_bias:
        params["bias"] = _rand(rs, 24)
    _run(OpType.LINEAR,
         JA.LinearAttrs(24, use_bias, JActiMode(act)),
         A.LinearAttrs(24, use_bias, ActiMode(act)),
         [_rand(rs, 2, 5, 16)], params)


def test_embedding():
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 50, (2, 7)).astype(np.int32)
    _run(OpType.EMBEDDING,
         JA.EmbeddingAttrs(50, 12, dtype=JDataType.FLOAT),
         A.EmbeddingAttrs(50, 12, dtype=DataType.FLOAT),
         [ids], {"kernel": _rand(rs, 50, 12)})


@pytest.mark.parametrize("kind", ["add", "subtract", "multiply", "divide",
                                  "max", "min"])
def test_element_binary(kind):
    rs = np.random.RandomState(2)
    a, b = _rand(rs, 2, 3, 8), _rand(rs, 2, 3, 8)
    if kind == "divide":
        b = np.abs(b) + 0.5
    _run(OpType.ELEMENT_BINARY, JA.ElementBinaryAttrs(kind),
         A.ElementBinaryAttrs(kind), [a, b], {})


@pytest.mark.parametrize("kind,scalar", [
    ("silu", 0.0), ("relu", 0.0), ("gelu", 0.0), ("sigmoid", 0.0),
    ("tanh", 0.0), ("exp", 0.0), ("elu", 0.0), ("identity", 0.0),
    ("pow", 2.0), ("scalar_multiply", 1.5), ("scalar_add", -0.25)])
def test_element_unary(kind, scalar):
    rs = np.random.RandomState(3)
    _run(OpType.ELEMENT_UNARY, JA.ElementUnaryAttrs(kind, scalar),
         A.ElementUnaryAttrs(kind, scalar), [_rand(rs, 4, 9)], {})


def test_rms_norm():
    rs = np.random.RandomState(4)
    _run(OpType.RMS_NORM, JA.RMSNormAttrs(1e-5), A.RMSNormAttrs(1e-5),
         [_rand(rs, 2, 3, 32)], {"scale": _rand(rs, 32)})


def test_softmax():
    rs = np.random.RandomState(5)
    _run(OpType.SOFTMAX, JA.SoftmaxAttrs(-1), A.SoftmaxAttrs(-1),
         [3 * _rand(rs, 2, 3, 40)], {})


@pytest.mark.parametrize("offset", ["scalar", "per_row", "per_token"])
def test_apply_rope(offset):
    rs = np.random.RandomState(6)
    B, S = 3, 5
    x = _rand(rs, B, S, 4, 16)
    off = {"scalar": 17,
           "per_row": np.array([0, 9, 1500], np.int32),
           "per_token": rs.randint(0, 2000, (B, S)).astype(np.int32)}[offset]
    want = jax_ops.apply_rope(jnp.asarray(x), 500000.0,
                              pos_offset=jnp.asarray(off))
    got = torch_ops.apply_rope(torch.from_numpy(x), 500000.0,
                               pos_offset=torch.as_tensor(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_qkv_and_out_projections():
    rs = np.random.RandomState(7)
    x, wq, wo = _rand(rs, 2, 3, 32), _rand(rs, 32, 4, 8), _rand(rs, 4, 8, 32)
    np.testing.assert_allclose(
        torch_ops.qkv_project(torch.from_numpy(x), torch.from_numpy(wq),
                              torch.float32).numpy(),
        np.asarray(jax_ops.qkv_project(jnp.asarray(x), jnp.asarray(wq),
                                       jnp.float32)), atol=TOL, rtol=TOL)
    o = _rand(rs, 2, 3, 4, 8)
    np.testing.assert_allclose(
        torch_ops.attn_out_project(torch.from_numpy(o), torch.from_numpy(wo),
                                   torch.float32).numpy(),
        np.asarray(jax_ops.attn_out_project(jnp.asarray(o), jnp.asarray(wo),
                                            jnp.float32)), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4)])
def test_mha_paged_branch(heads, kv_heads):
    """The MULTIHEAD_ATTENTION lowering's paged branch: projections, rope,
    page write and ragged attention against jax_ops._mha's, with a decode
    row, a 3-row chunk and a pad entry. Output rows past q_len are
    discarded by every caller and differ by contract (the reference's
    gather fallback averages, the port writes zeros through wo)."""
    rs = np.random.RandomState(8)
    B, S, E, hd, P, N = 3, 4, 32, 8, 4, 10
    x = _rand(rs, B, S, E)
    params = {"wq": _rand(rs, E, heads, hd), "wk": _rand(rs, E, kv_heads, hd),
              "wv": _rand(rs, E, kv_heads, hd), "wo": _rand(rs, heads, hd, E)}
    kc, vc = _rand(rs, N, P, kv_heads, hd), _rand(rs, N, P, kv_heads, hd)
    pt = np.array([[4, 1, 0], [6, 8, 3], [0, 0, 0]], np.int32)
    pos = np.array([5, 2, 0], np.int32)
    qls = np.array([1, 3, 0], np.int32)
    deps = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    anc = np.tile(np.tril(np.ones((S, S), bool)), (B, 1, 1))
    jattrs = JA.MultiHeadAttentionAttrs(E, heads, kv_heads, causal=True,
                                        rope=True, rope_theta=10000.0)
    tattrs = A.MultiHeadAttentionAttrs(E, heads, kv_heads, causal=True,
                                       rope=True, rope_theta=10000.0)
    jctx = JLowerCtx(training=False,
                     kv_cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                     cache_position=jnp.asarray(pos),
                     page_tables=jnp.asarray(pt),
                     ragged_q_lens=jnp.asarray(qls),
                     ragged_depths=jnp.asarray(deps),
                     ragged_anc=jnp.asarray(anc))
    tctx = LowerCtx(kv_cache={"k": torch.from_numpy(kc.copy()),
                              "v": torch.from_numpy(vc.copy())},
                    cache_position=torch.from_numpy(pos),
                    page_tables=torch.from_numpy(pt),
                    ragged_q_lens=torch.from_numpy(qls),
                    ragged_depths=torch.from_numpy(deps),
                    ragged_anc=torch.from_numpy(anc))
    (jy,) = jax_ops._mha(jattrs, [jnp.asarray(x)] * 3,
                         {k: jnp.asarray(v) for k, v in params.items()}, jctx)
    (ty,) = torch_ops._mha(tattrs, [torch.from_numpy(x)] * 3,
                           {k: torch.from_numpy(v) for k, v in params.items()},
                           tctx)
    jy = np.asarray(jy)
    for b in range(B):
        n = int(qls[b])
        np.testing.assert_allclose(ty[b, :n].numpy(), jy[b, :n], atol=TOL,
                                   rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tctx.cache_updates[name].numpy()[1:],
            np.asarray(jctx.cache_updates[name])[1:], atol=TOL, rtol=TOL)


def test_mha_outside_the_paged_path_raises():
    attrs = A.MultiHeadAttentionAttrs(16, 2)
    x = torch.zeros(1, 2, 16)
    params = {"wq": torch.zeros(16, 2, 8), "wk": torch.zeros(16, 2, 8),
              "wv": torch.zeros(16, 2, 8), "wo": torch.zeros(2, 8, 16)}
    with pytest.raises(NotImplementedError):
        torch_ops._mha(attrs, [x] * 3, params, LowerCtx())
