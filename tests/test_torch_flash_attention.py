"""The port's flash attention held to the JAX package's Pallas flash
attention, run in interpret mode on the CPU: forward output, logsumexp and
the gradients of q, k and v on the same numpy inputs. At head dim 128 the
JAX side runs the flat-lane kernels K1 (`_fwd_bshd`) and K2 (`_bwd_bshd`)
themselves; at other head dims its padded head-major kernels K4 (`_fwd`,
`_bwd`). The port's CPU path at head dim 128 is the plain version
(`flash_attention_reference`) with autograd through its dense ops; at
other head dims it is the head-major route (repeat, transpose,
FlashAttentionHeadMajorFunction) over the plain versions of K4's three
contracts, which are also held to K4 called directly. The CUDA kernels
are held to these plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _bwd,
    _fwd,
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
    flash_bh_delta,
    flash_bh_dkv_reference,
    flash_bh_dq_reference,
    flash_bh_reference,
    flash_delta,
    flash_dkv_reference,
    flash_dq_reference,
    einsum_3xtf32,
    tf32_round,
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
    (48, 128, 2),    # head-major, GQA, the reference's own test's D
    (96, 256, 2),    # head-major, GQA, D of Phi-3-mini's width
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


def _flat_route_matches_jax(monkeypatch, D, causal, seed):
    """At head dim D (a multiple of 128) the reference runs its flat-lane
    K1/K2 (here interpreted), and the port routes D to the flat kernels
    too (their argument check takes it; on the CPU their plain version
    runs, never the head-major route). Forward and gradients agree; S 128,
    GQA 4 / 2."""
    from flexflow_tpu_torch.ops import flash_attention as fa

    S, H, Hkv = 128, 4, 2
    scale = 1.0 / np.sqrt(D)
    q, k, v, w = _inputs(S, H, Hkv, D, seed=seed)
    fa._check_kernel_args(*(torch.from_numpy(a) for a in (q, k, v)))
    calls = []
    real = fa.flash_attention_reference

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    monkeypatch.setattr(fa.FlashAttentionHeadMajorFunction, "apply",
                        lambda *a: pytest.fail("head-major route taken"))

    def jloss(q, k, v):
        out = jflash_attention(q, k, v, causal=causal, scale=scale,
                               interpret=True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = fa.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    (tout * torch.from_numpy(w)).sum().backward()
    assert calls == [(1, S, H, D)]
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_256_takes_the_flat_route_and_matches_jax(monkeypatch,
                                                           causal):
    """D 256 is a multiple of 128: the flat route on both sides."""
    _flat_route_matches_jax(monkeypatch, 256, causal, seed=23 + causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [384, 512])
def test_head_dims_384_and_512_take_the_flat_route_and_match_jax(
        monkeypatch, D, causal):
    """D 384 and 512: the reference's flat route takes every multiple of
    128 (flash_attention.py:618), and so does the port's, up to 512."""
    _flat_route_matches_jax(monkeypatch, D, causal, seed=D + causal)


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
    """K1/K2 refuse head dims other than 64 and the multiples of 128 up to
    512 (384 and 512 pass), K4 head dims above 256, and both other
    dtypes, devices and head counts, each naming the limit."""
    from flexflow_tpu_torch.ops.flash_attention import (
        _check_bh_args,
        _check_kernel_args,
    )

    q = torch.zeros(1, 4, 2, 64)
    kv = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"),
                        causal=True, scale=0.1)
    for D in (384, 512):
        _check_kernel_args(torch.zeros(1, 4, 2, D), torch.zeros(1, 4, 1, D),
                           torch.zeros(1, 4, 1, D))
    with pytest.raises(ValueError, match="up to 512"):
        _check_kernel_args(torch.zeros(1, 4, 2, 640),
                           torch.zeros(1, 4, 1, 640),
                           torch.zeros(1, 4, 1, 640))
    with pytest.raises(ValueError, match="bfloat16"):
        _check_kernel_args(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="multiple"):
        kv2 = torch.zeros(1, 4, 2, 64)
        _check_kernel_args(torch.zeros(1, 4, 3, 64), kv2, kv2)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 4, 3, 48), torch.zeros(1, 4, 2, 48),
                        torch.zeros(1, 4, 2, 48))
    bh = torch.zeros(2, 4, 264)
    with pytest.raises(ValueError, match="up to 256"):
        _check_bh_args(bh, bh, bh)
    with pytest.raises(ValueError, match="CUDA"):  # checked for the card
        _check_bh_args(*(torch.zeros(2, 4, 48),) * 3)


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


# ---------------------------------------------------------------------------
# K4: the head-major contracts against the reference's _fwd / _bwd


def _bh_inputs(BH, S, T, D, seed):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((BH, S, D)).astype(np.float32)
    k = rs.standard_normal((BH, T, D)).astype(np.float32)
    v = rs.standard_normal((BH, T, D)).astype(np.float32)
    do = rs.standard_normal((BH, S, D)).astype(np.float32)
    # a per-row shift: the lse a ring backward hands in is the final one,
    # not the block's own
    shift = rs.uniform(0.0, 1.0, (BH, S)).astype(np.float32)
    return q, k, v, do, shift


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,S,T", [(48, 128, 128), (64, 128, 256),
                                   (96, 256, 128)])
def test_head_major_plain_versions_match_jax_k4(D, S, T, causal):
    """flash_bh_reference's (out, lse), and flash_bh_dq_reference /
    flash_bh_dkv_reference from the forward's own lse and from a
    caller-given one (the ring contract), against the reference's K4
    `_fwd` and `_bwd` called directly in interpret mode, S != T
    included."""
    BH, scale = 3, 1.0 / np.sqrt(D)
    q, k, v, do, shift = _bh_inputs(BH, S, T, D, seed=D + S + causal)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = _fwd(jq, jk, jv, causal, scale, 128, 128, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_bh_reference(tq, tk, tv, causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=FWD_TOL, rtol=FWD_TOL)
    delta = flash_bh_delta(tdo, out)
    assert delta.shape == (BH, S) and delta.dtype == torch.float32
    for given in (lse, lse + torch.from_numpy(shift)):
        jl = jnp.broadcast_to(jnp.asarray(given.numpy())[..., None],
                              (BH, S, 128))
        jdq, jdk, jdv = _bwd(jq, jk, jv, jout, jl, jdo, causal, scale, 128,
                             128, True)
        args = (tq, tk, tv, tdo, given, delta, causal, scale)
        dq = flash_bh_dq_reference(*args)
        dk, dv = flash_bh_dkv_reference(*args)
        for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                                ("dv", dv, jdv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=name)


def test_head_major_plain_backward_matches_autograd():
    """With the forward's own lse, K4's two backward contracts give the
    plain forward's autograd gradients (S != T, causal)."""
    q, k, v, do, _ = _bh_inputs(2, 24, 40, 20, seed=6)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash_bh_reference(tq, tk, tv, True, 0.3)
    dout = torch.from_numpy(do)
    out.backward(dout)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            dout, lse.detach(), flash_bh_delta(dout, out.detach()), True, 0.3)
    dk, dv = flash_bh_dkv_reference(*args)
    for got, want in ((flash_bh_dq_reference(*args), tq.grad),
                      (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_tf32_round_is_round_to_nearest_ties_away():
    """tf32_round keeps 10 mantissa bits, rounding to nearest with ties
    away from zero (cvt.rna): 1 + 2^-11 (a tie) goes up to 1 + 2^-10, 1 +
    2^-12 down to 1, signs alike; hi + tf32(x - hi) is within 2^-22 of x."""
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      3 * 2 ** -11 + 1, 0.0])
    want = torch.tensor([1 + 2 ** -10, 1.0, -(1 + 2 ** -10),
                         1 + 2 ** -9, 0.0])
    assert torch.equal(tf32_round(x), want)
    rs = np.random.RandomState(0)
    y = torch.from_numpy(rs.standard_normal(4096).astype(np.float32))
    hi = tf32_round(y)
    assert torch.equal(tf32_round(hi), hi)
    err = (hi + tf32_round(y - hi) - y).abs()
    assert bool((err <= 2.0 ** -22 * y.abs()).all())


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_backward_matches_jax_k4(causal):
    """K4's fp32 dq and dk/dv as the card's 3xTF32 body computes them
    (einsum_3xtf32 through the plain backward) at GPT-2's head dim 64,
    from a caller-given lse, against the reference's `_bwd` in interpret
    mode within FLASH_TOLS[float32]: max |err| and the error norm, as
    chip_smoke's checks hold the card's kernel to the plain version. One
    tf32 product alone (operands rounded once) misses the same bounds."""
    import chip_smoke
    tol = chip_smoke.FLASH_TOLS[torch.float32][1]
    BH, S, D = 2, 256, 64
    scale = 1.0 / np.sqrt(D)
    q, k, v, do, shift = _bh_inputs(BH, S, S, D, seed=64 + causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_bh_reference(tq, tk, tv, causal, scale)
    lse = lse + torch.from_numpy(shift)
    delta = flash_bh_delta(tdo, out)
    jl = jnp.broadcast_to(jnp.asarray(lse.numpy())[..., None], (BH, S, 128))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    want = [torch.from_numpy(np.array(g)) for g in _bwd(
        jq, jk, jv, jnp.asarray(out.numpy()), jl, jdo, causal, scale, 128,
        128, True)]
    args = (tq, tk, tv, tdo, lse, delta, causal, scale)

    def one_tf32(eq, a, b):
        return torch.einsum(eq, tf32_round(a), tf32_round(b))

    for einsum, ok in ((einsum_3xtf32, True), (one_tf32, False)):
        got = [flash_bh_dq_reference(*args, einsum=einsum),
               *flash_bh_dkv_reference(*args, einsum=einsum)]
        verdicts = [chip_smoke._err_ok([(g, w)], tol)[1]
                    for g, w in zip(got, want)]
        if ok:
            assert all(verdicts), verdicts
        else:
            assert not all(verdicts), verdicts
