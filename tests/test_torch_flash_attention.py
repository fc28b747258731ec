"""The port's flash attention held to the JAX package's Pallas flash
attention, run in interpret mode on the CPU: forward output, logsumexp and
the gradients of q, k and v on the same numpy inputs. At head dim 128 the
JAX side runs the flat-lane kernels K1 (`_fwd_bshd`) and K2 (`_bwd_bshd`)
themselves; at head dim 64 its padded head-major kernels. The port's CPU
path is the plain version (`flash_attention_reference`) with autograd
through its dense ops; the CUDA kernels are held to that plain version on
the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _fwd_bshd,
)
from flexflow_tpu.ops.pallas.flash_attention import (  # noqa: E402
    flash_attention as jflash_attention,
)
from flexflow_tpu.ops.registry import LowerCtx as JLowerCtx  # noqa: E402
from flexflow_tpu_torch.ops import attrs as A  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_reference,
    flash_delta,
    flash_dkv_reference,
    flash_dq_reference,
)
from flexflow_tpu_torch.ops.registry import LowerCtx  # noqa: E402

# the tolerances of tests/test_pallas_flash.py: fp32 forward 2e-5 (block
# order of the online softmax), gradients 5e-4 (recomputed from lse)
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def _inputs(S, H, Hkv, D, seed):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((1, S, H, D)).astype(np.float32)
    k = rs.standard_normal((1, S, Hkv, D)).astype(np.float32)
    v = rs.standard_normal((1, S, Hkv, D)).astype(np.float32)
    # a fixed upstream gradient: d(sum(out * w))/d out = w
    w = rs.standard_normal((1, S, H, D)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,S,Hkv", [
    (128, 128, 2),   # K1/K2 (flat-lane kernels), GQA
    (128, 256, 4),   # K1/K2, MHA
    (64, 128, 4),    # padded head-major kernels, MHA
    (64, 256, 2),    # padded head-major kernels, GQA
])
def test_flash_attention_matches_jax_pallas(D, S, Hkv, causal):
    H = 4
    scale = 1.0 / np.sqrt(D)
    q, k, v, w = _inputs(S, H, Hkv, D, seed=D + S + Hkv + causal)

    def jloss(q, k, v):
        out = jflash_attention(q, k, v, causal=causal, scale=scale,
                               interpret=True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = flash_attention(tq, tk, tv, causal=causal, scale=scale)
    (tout * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")

    _, lse = flash_attention_reference(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal, scale)
    if D % 128 == 0:
        # K1's own lse: (B, S, H * 128) lane-broadcast -> (B, H, S)
        _, jl = _fwd_bshd(
            jnp.asarray(q.reshape(1, S, H * D)),
            jnp.asarray(k.reshape(1, S, Hkv * D)),
            jnp.asarray(v.reshape(1, S, Hkv * D)), causal, scale, S, S,
            True, H, D)
        want = np.asarray(jl).reshape(1, S, H, 128)[..., 0].transpose(0, 2, 1)
    else:
        rep = H // Hkv
        logits = np.einsum("bshd,bthd->bhst", q,
                           np.repeat(k, rep, axis=2)) * scale
        if causal:
            logits = np.where(np.tril(np.ones((S, S), bool)), logits, -1e30)
        want = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)


def test_delta_prepass_matches_reference_einsum():
    rs = np.random.RandomState(3)
    do = rs.standard_normal((2, 8, 4, 16)).astype(np.float32)
    out = rs.standard_normal((2, 8, 4, 16)).astype(np.float32)
    want = np.asarray(jnp.einsum("bshd,bshd->bsh", jnp.asarray(do),
                                 jnp.asarray(out))).transpose(0, 2, 1)
    got = flash_delta(torch.from_numpy(do), torch.from_numpy(out))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_plain_versions_match_autograd(causal):
    """The dense plain versions of the dq and dk/dv kernels (what
    chip_smoke.py holds each K2 launch to) give the plain forward's
    autograd gradients."""
    q, k, v, w = _inputs(24, 4, 2, 16, seed=11)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash_attention_reference(tq, tk, tv, causal, 0.25)
    dout = torch.from_numpy(w)
    out.backward(dout)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            dout, lse.detach(), flash_delta(dout, out.detach()), causal,
            0.25)
    dq = flash_dq_reference(*args)
    dk, dv = flash_dkv_reference(*args)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_bf16_plain_version_rounds_like_the_reference():
    """bf16 inputs: the plain version keeps fp32 logits and rounds the
    probabilities to bf16 before the value product, as the reference's
    XLA attention does; output in bf16."""
    q, k, v, _ = _inputs(32, 4, 2, 64, seed=5)
    got = flash_attention(*(torch.from_numpy(a).bfloat16()
                            for a in (q, k, v)), causal=True, scale=0.125)
    want = jax_ops._dot_product_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), True, 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


def test_wrapper_refuses_devices_and_shapes_it_does_not_take():
    from flexflow_tpu_torch.ops.flash_attention import _check_kernel_args

    q = torch.zeros(1, 4, 2, 64)
    kv = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"),
                        causal=True, scale=0.1)
    with pytest.raises(ValueError, match="K4"):
        _check_kernel_args(torch.zeros(1, 4, 2, 96), torch.zeros(1, 4, 1, 96),
                           torch.zeros(1, 4, 1, 96))
    with pytest.raises(ValueError, match="bfloat16"):
        _check_kernel_args(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="multiple"):
        kv2 = torch.zeros(1, 4, 2, 64)
        _check_kernel_args(torch.zeros(1, 4, 3, 64), kv2, kv2)


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4)])
def test_mha_no_cache_branch_matches_jax(heads, kv_heads):
    """The MULTIHEAD_ATTENTION lowering without a cache (training, eval,
    predict): projections, rope and causal attention against
    jax_ops._mha's, forward and the gradient of every weight."""
    rs = np.random.RandomState(9)
    B, S, E, hd = 2, 12, 32, 8
    x = rs.standard_normal((B, S, E)).astype(np.float32)
    params = {n: rs.standard_normal(s).astype(np.float32) * 0.3 for n, s in
              (("wq", (E, heads, hd)), ("wk", (E, kv_heads, hd)),
               ("wv", (E, kv_heads, hd)), ("wo", (heads, hd, E)))}
    w = rs.standard_normal((B, S, E)).astype(np.float32)
    jattrs = JA.MultiHeadAttentionAttrs(E, heads, kv_heads, causal=True,
                                        rope=True, rope_theta=10000.0)
    tattrs = A.MultiHeadAttentionAttrs(E, heads, kv_heads, causal=True,
                                       rope=True, rope_theta=10000.0)

    def jloss(ps):
        (y,) = jax_ops._mha(jattrs, [jnp.asarray(x)] * 3, ps,
                            JLowerCtx(training=True))
        return jnp.sum(y * jnp.asarray(w)), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    (ty,) = torch_ops._mha(tattrs, [torch.from_numpy(x)] * 3, tp,
                           LowerCtx(training=True))
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
