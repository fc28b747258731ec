"""Dropout in the port: the DROPOUT op and attention dropout (the dense
route a training step's attention takes at a rate above 0, as the
reference routes it). The masks come from torch generators, not
threefry, so they cannot match the reference's bit for bit; what is held
instead: rate 0 and eval are the no-dropout path (attention: the flash
path's plain version); under one shared mask both packages compute the
same function and gradients; the kept share is within a binomial bound
and kept values are scaled by 1 / keep; the same (fit stream, step,
node) gives the same mask and another gives another; and gradients
under remat="attention", which recomputes the forward, equal those
without remat."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.ops import attrs as JA  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    FFConfig,
    FFModel,
    LossType,
    SGDOptimizer,
)
from flexflow_tpu_torch.models.bert import BertConfig, build_bert  # noqa: E402
from flexflow_tpu_torch.ops import attrs as A  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_reference,
)
from flexflow_tpu_torch.ops.registry import LowerCtx, node_seed  # noqa: E402
from torch_parity import compare  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_rate_zero_and_eval_are_the_no_dropout_path():
    """DROPOUT passes its input through in eval at any rate and in
    training at rate 0. Attention at dropout 0.1 in eval, and at 0 in
    training, is the flash path (its plain version on the CPU), and the
    dense route does not run."""
    x = torch.from_numpy(_x(2, 3, 4))
    for attrs, training in ((A.DropoutAttrs(0.5), False),
                            (A.DropoutAttrs(0.0), True)):
        (y,) = torch_ops._dropout(attrs, [x], {},
                                  LowerCtx(training=training, rng_seed=1))
        assert y is x
    rs = np.random.RandomState(1)
    params = {n: torch.from_numpy((rs.randn(*s) * 0.3).astype(np.float32))
              for n, s in (("wq", (16, 2, 8)), ("wk", (16, 2, 8)),
                           ("wv", (16, 2, 8)), ("wo", (2, 8, 16)))}
    q = torch.from_numpy(_x(2, 5, 16, seed=2))
    before = torch_ops.DENSE_DROPOUT_ATTENTION.launches
    for causal in (False, True):
        qp = torch_ops.qkv_project(q, params["wq"], q.dtype)
        kp = torch_ops.qkv_project(q, params["wk"], q.dtype)
        vp = torch_ops.qkv_project(q, params["wv"], q.dtype)
        plain = flash_attention_reference(qp, kp, vp, causal, 8 ** -0.5)[0]
        want = torch_ops.attn_out_project(plain, params["wo"], q.dtype)
        for rate, training in ((0.1, False), (0.0, True)):
            attrs = A.MultiHeadAttentionAttrs(16, 2, causal=causal,
                                              dropout=rate)
            (y,) = torch_ops._mha(attrs, [q] * 3, params,
                                  LowerCtx(training=training, rng_seed=3))
            torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert torch_ops.DENSE_DROPOUT_ATTENTION.launches == before


def _shared_mask(monkeypatch, seed=11):
    """One Bernoulli mask for both packages: jax.random.bernoulli and the
    port's dropout_mask both return the same draw of `shape`."""
    masks = {}

    def draw(shape, keep):
        key = (tuple(shape), keep)
        if key not in masks:
            rs = np.random.RandomState(seed + len(masks))
            masks[key] = rs.rand(*shape) < keep
        return masks[key]

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda rng, p, shape: jnp.asarray(draw(shape, p)))
    monkeypatch.setattr(torch_ops, "dropout_mask",
                        lambda shape, keep, gen, device: torch.from_numpy(
                            draw(tuple(shape), keep)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_matches_jax_under_one_mask(monkeypatch, dtype):
    """Under one mask DROPOUT is the reference's where(mask, x / keep,
    0), forward and gradient."""
    _shared_mask(monkeypatch)
    x = _x(4, 6, 5, seed=4)
    jat, tat = JA.DropoutAttrs(0.3), A.DropoutAttrs(0.3)
    assert repr(jat) == repr(tat)
    compare(jax_ops._dropout, torch_ops._dropout, jat, tat, [x], {},
            [_x(4, 6, 5, seed=5)], dtype, training=True,
            rng=jax.random.key(0), rng_seed=7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_dense_dropout_attention_matches_jax_under_one_mask(
        monkeypatch, causal, dtype):
    """Under one mask the dense route is the reference's
    `_dot_product_attention` with dropout on the probabilities (q's
    dtype), GQA and S != T included: output and the gradients of q, k
    and v."""
    _shared_mask(monkeypatch)
    B, S, T, H, Hkv, D = 2, 5, 7, 4, 2, 8
    q, k, v = _x(B, S, H, D, seed=1), _x(B, T, Hkv, D, seed=2), _x(
        B, T, Hkv, D, seed=3)

    def jlow(attrs, ins, ps, ctx):
        return [jax_ops._dot_product_attention(
            *ins, causal, 0.35, dropout_rate=0.2, dropout_rng=ctx.rng)]

    def tlow(attrs, ins, ps, ctx):
        return [torch_ops.dense_dropout_attention(
            *ins, causal=causal, scale=0.35, rate=0.2,
            gen=ctx.generator(ins[0].device))]

    before = torch_ops.DENSE_DROPOUT_ATTENTION.launches
    compare(jlow, tlow, None, None, [q, k, v], {},
            [_x(B, S, H, D, seed=4)], dtype, training=True,
            rng=jax.random.key(0), rng_seed=7)
    assert torch_ops.DENSE_DROPOUT_ATTENTION.launches == before + 1


def test_kept_share_and_scale():
    """At rate 0.3 over 200 000 elements the kept share is within five
    binomial standard deviations of 0.7; every kept value is x / 0.7 in
    x's dtype, every other 0."""
    for dtype in DTYPES:
        x = torch.from_numpy(_x(400, 500, seed=6) + 3.0).to(dtype)
        (y,) = torch_ops._dropout(A.DropoutAttrs(0.3), [x], {},
                                  LowerCtx(training=True, rng_seed=12345))
        kept = y != 0
        n = x.numel()
        share = kept.float().mean().item()
        assert abs(share - 0.7) <= 5 * np.sqrt(0.7 * 0.3 / n), share
        torch.testing.assert_close(y[kept], (x / 0.7)[kept], rtol=0,
                                   atol=0)
        assert y.dtype == dtype


def _mask(stream, step, guid, shape=(64, 64)):
    ctx = LowerCtx(training=True, rng_seed=node_seed((stream, step), guid))
    (y,) = torch_ops._dropout(A.DropoutAttrs(0.5), [torch.ones(shape)], {},
                              ctx)
    return y != 0


def test_same_stream_step_and_node_give_the_same_mask():
    """A node's mask is a function of (fit stream, step, node guid)
    alone: drawn twice it is the same; another step, node or stream
    gives another."""
    base = _mask(1, 0, 5)
    assert torch.equal(base, _mask(1, 0, 5))
    for other in (_mask(1, 1, 5), _mask(1, 0, 6), _mask(2, 0, 5)):
        assert not torch.equal(base, other)
    assert len({node_seed((s, t), g) for s in range(3) for t in range(3)
                for g in range(3)}) == 27


def _bert(remat, seed=0):
    cfg = BertConfig(vocab_size=64, hidden=32, layers=2, heads=4,
                     intermediate=64, dropout=0.2)
    ff = FFModel(FFConfig(batch_size=2, seed=seed, device="cpu",
                          remat=remat))
    build_bert(ff, cfg, batch_size=2, seq_len=8)
    ff.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def test_remat_attention_recomputes_the_same_mask():
    """A two-layer BERT at attention dropout 0.2: the loss and every
    gradient under remat="attention" (the forward recomputed in backward
    by torch.utils.checkpoint, which restores only the global RNG state)
    equal those without remat at the same stream; the dense route runs
    once a layer without remat and twice with. Two fits from the same
    seed train to the same weights."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 64, (2, 8)).astype(np.int32))
    y = torch.from_numpy(rs.randint(0, 2, 2).astype(np.int32))
    res = {}
    for remat in ("none", "attention"):
        ff = _bert(remat)
        tr, ntr = ff._params
        before = torch_ops.DENSE_DROPOUT_ATTENTION.launches
        loss, _, grads = ff.executor.loss_and_grads(tr, ntr, y, x,
                                                    rng=(4, 2))
        res[remat] = (loss, grads,
                      torch_ops.DENSE_DROPOUT_ATTENTION.launches - before)
    assert res["none"][2] == 2 and res["attention"][2] == 4
    torch.testing.assert_close(res["none"][0], res["attention"][0], rtol=0,
                               atol=0)
    for nk, ws in res["none"][1].items():
        for wn, g in ws.items():
            torch.testing.assert_close(res["attention"][1][nk][wn], g,
                                       rtol=1e-6, atol=1e-7)
    # another stream draws other masks: another loss
    ff = _bert("none")
    other, _, _ = ff.executor.loss_and_grads(*ff._params, y, x, rng=(4, 3))
    assert other.item() != res["none"][0].item()
    fits = []
    for _ in range(2):
        ff = _bert("attention", seed=5)
        ff.fit(x.numpy(), y.numpy(), verbose=False)
        fits.append(ff._params[0])
    for nk, ws in fits[0].items():
        for wn, p in ws.items():
            assert torch.equal(p, fits[1][nk][wn]), (nk, wn)
