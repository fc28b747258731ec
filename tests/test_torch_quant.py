"""The port's int8 KV pages (flexflow_tpu_torch/paged/quant.py) and the
quantized and mixed-dtype ragged attention held to the JAX reference, on
the CPU.

Quantize-on-append is integer arithmetic on the same fp32 values in both
packages (torch.round and jnp.round both round half to even), so the int8
payload and the scales must be EXACTLY equal. The attention over the
pages differs by fp32 summation order only: 1e-5. The CUDA kernel itself
is held to the plain version by tests/test_torch_cuda.py (skipped without
a card) and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.paged import quant as jquant  # noqa: E402
from flexflow_tpu.paged.attention import (  # noqa: E402
    chain_descriptor as jax_chain_descriptor,
    ragged_paged_attention as jax_ragged_paged_attention,
)
from flexflow_tpu_torch.paged import quant  # noqa: E402
from flexflow_tpu_torch.paged.attention import (  # noqa: E402
    chain_descriptor,
    ragged_flash_attention,
    ragged_gather_attention,
    ragged_paged_attention,
)

# fp32 on the CPU, same inputs: the attention differs by summation order
TOL = 1e-5

# (rows, page, off, live) of successive appends into one (6, 4, 2, 8)
# pool: small rows into pages 1 and 2; larger rows growing into the
# occupied pages 1 and 2 (rescale of their rows); a dead row carrying 1e6
# beside a live one; four rows of one call into the same page 3 (and a
# second entry into it), so duplicate pages combine under max
_N, _P, _HKV, _D = 6, 4, 2, 8


def _appends():
    rs = np.random.RandomState(0)
    dead = np.sign(rs.standard_normal((1, 2, _HKV, _D))) * 1e6
    dead[:, 1] *= 1e-7  # the live row beside the dead one: |x| ~ 0.1
    return [
        (rs.standard_normal((2, 3, _HKV, _D)) * 0.1,
         [[1, 1, 1], [2, 2, 2]], [[0, 1, 2], [0, 1, 2]],
         [[1, 1, 1], [1, 1, 0]]),
        (rs.standard_normal((2, 2, _HKV, _D)) * 3.0,
         [[1, 3], [2, 0]], [[3, 0], [3, 1]], [[1, 1], [1, 0]]),
        (dead, [[0, 4]], [[2, 0]], [[0, 1]]),
        (rs.standard_normal((2, 4, _HKV, _D)) * [[[[0.5]]], [[[4.0]]]],
         [[3, 3, 3, 3], [3, 5, 5, 0]], [[0, 1, 2, 3], [1, 0, 1, 0]],
         [[1, 1, 1, 1], [1, 1, 1, 0]]),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_append_bytes_match_jax(dtype):
    """The three scatters (grow, rescale, write) give the reference's int8
    bytes and scales exactly, call after call, in place."""
    jpool = jnp.zeros((_N, _P, _HKV, _D), jnp.int8)
    jscales = jnp.zeros((_N, _HKV), jnp.float32)
    pool = torch.zeros((_N, _P, _HKV, _D), dtype=torch.int8)
    scales = torch.zeros((_N, _HKV))
    for x, page, off, live in _appends():
        x = x.astype(np.float32)
        page, off = np.asarray(page, np.int32), np.asarray(off, np.int32)
        live = np.asarray(live, bool)
        jpool, jscales = jquant.quantized_append(
            jpool, jscales, jnp.asarray(x, getattr(jnp, dtype)),
            jnp.asarray(page), jnp.asarray(off), jnp.asarray(live))
        got = quant.quantized_append(
            pool, scales, torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.from_numpy(page), torch.from_numpy(off),
            torch.from_numpy(live))
        assert got[0] is pool and got[1] is scales  # in place
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    # the dead 1e6 row inflated no scale; every real page was written
    assert float(scales.max()) < 1.0
    assert (scales[1:] > 0).all()
    np.testing.assert_array_equal(
        quant.dequantize_pages(pool[1:4], scales[1:4]).numpy(),
        np.asarray(jquant.dequantize_pages(jpool[1:4], jscales[1:4])))


def test_kv_dtype_table_matches_jax():
    assert quant.KV_DTYPES == jquant.KV_DTYPES
    assert (quant.QMAX, quant.SCALE_EPS, quant.SCALE_BYTES) == \
        (jquant.QMAX, jquant.SCALE_EPS, jquant.SCALE_BYTES)
    for name in list(quant.KV_DTYPES) + ["auto", None]:
        assert quant.kv_dtype_info(name) == jquant.kv_dtype_info(name)
        want = jquant.resolve_kv_dtype(name)
        got = quant.resolve_kv_dtype(name)
        assert (got is None) == (want is None)
        if got is not None:
            assert str(got) == f"torch.{want.name}"
            assert quant.is_quantized_dtype(got) == \
                jquant.is_quantized_dtype(want)
    with pytest.raises(ValueError, match="kv_dtype"):
        quant.resolve_kv_dtype("int7")


def _mixed_batch(pool: str):
    """tests/test_quantized_kv.py's mixed batch, in both packages: a
    4-row causal chunk per slot (prefix fill), then slot 0 decodes, slot
    1 runs a chunk and slot 2 a 3-node tree, over one pool of `pool`'s
    dtype ("int8" with its scales, or "bf16" under fp32 q). Returns
    (port, reference) outputs of the second call and the final pools."""
    B, S, H, Hkv, D, N, P = 3, 4, 2, 1, 8, 10, 4
    rs = np.random.RandomState(3)
    pt = np.asarray([[1 + 3 * b + j for j in range(3)] for b in range(B)],
                    np.int32)
    scale = 1.0 / np.sqrt(D)
    steps = [rs.standard_normal(s).astype(np.float32)
             for s in [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)] * 2]
    anc2 = np.zeros((B, S, S), bool)
    anc2[0, 0, 0] = True
    anc2[1] = np.tril(np.ones((S, S), bool))
    anc2[2, 0, 0] = True
    anc2[2, 1, [0, 1]] = True
    anc2[2, 2, [0, 2]] = True
    desc2 = (np.asarray([4, 4, 4], np.int32), np.asarray([1, 4, 3], np.int32),
             np.asarray([[0, 0, 0, 0], [0, 1, 2, 3], [0, 1, 1, 0]],
                        np.int32), anc2)
    quantized = pool == "int8"
    outs = []
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            t = torch.from_numpy
            dt = torch.int8 if quantized else torch.bfloat16
            bufs = [torch.zeros((N, P, Hkv, D), dtype=dt) for _ in "kv"]
            if quantized:
                bufs += [torch.zeros((N, Hkv)) for _ in "kv"]
            fn, chain = ragged_paged_attention, chain_descriptor
        else:
            t = jnp.asarray
            dt = jnp.int8 if quantized else jnp.bfloat16
            bufs = [jnp.zeros((N, P, Hkv, D), dt) for _ in "kv"]
            if quantized:
                bufs += [jnp.zeros((N, Hkv), jnp.float32) for _ in "kv"]
            fn, chain = jax_ragged_paged_attention, jax_chain_descriptor
        qlen, depths, anc = chain(B, S)
        descs = [(t(np.zeros((B,), np.int32)), qlen, depths, anc),
                 tuple(t(a) for a in desc2)]
        for i, (pos, ql, dep, an) in enumerate(descs):
            q, k, v = (t(a) for a in steps[3 * i:3 * i + 3])
            kw = dict(zip(("k_scales", "v_scales"), bufs[2:]))
            res = fn(q, k, v, bufs[0], bufs[1], t(pt), pos, ql, dep, an,
                     scale=scale, rope_theta=10000.0, **kw)
            out, bufs = res[0], list(res[1:])
        outs.append((np.asarray(out.float() if pkg == "torch" else
                                out.astype(jnp.float32)),
                     [np.asarray(b.float() if pkg == "torch"
                                 else b.astype(jnp.float32)) for b in bufs]))
    return outs, desc2[1]


@pytest.mark.parametrize("pool", ["int8", "bf16"])
@pytest.mark.parametrize("interpret", [False, True],
                         ids=["gather", "interpret-kernel"])
def test_mixed_ragged_batch_matches_jax(pool, interpret, monkeypatch):
    """rope + quantize-on-append (int8) or a bf16 storage cast under fp32
    q + attend, over the mixed decode/chunk/tree batch: the port's output
    rows agree with the reference's gather path and its Pallas kernel
    (interpret mode) within TOL, and the pools and scales are equal."""
    if interpret:
        monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    else:
        monkeypatch.delenv("FF_TPU_FLASH_INTERPRET", raising=False)
    ((got, got_bufs), (want, want_bufs)), q_lens = _mixed_batch(pool)
    for b, n in enumerate(q_lens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=TOL,
                                   rtol=TOL)
        assert not got[b, n:].any()  # the kernel's zero tail
    assert len(got_bufs) == (4 if pool == "int8" else 2)
    for g, w in zip(got_bufs, want_bufs):
        # every page but the garbage null page 0
        np.testing.assert_array_equal(g[1:], w[1:])


def test_quantized_plain_version_is_fp32_dequantized_attention():
    """The plain version's int8 contract: q upcast, pages dequantized to
    fp32, the whole attention in fp32 and only the output cast back to
    q's dtype; an fp pool of another dtype is cast to q's."""
    rs = np.random.RandomState(9)
    B, S, H, Hkv, D, N, P = 2, 3, 4, 2, 16, 6, 4
    x = torch.from_numpy(rs.standard_normal((N, P, Hkv, D))
                         .astype(np.float32))
    kq = torch.zeros((N, P, Hkv, D), dtype=torch.int8)
    ks = torch.zeros((N, Hkv))
    quant.quantized_append(kq, ks, x[None].reshape(1, -1, Hkv, D),
                           torch.arange(N).repeat_interleave(P)[None],
                           torch.arange(P).repeat(N)[None],
                           torch.ones(1, N * P, dtype=torch.bool))
    q = torch.from_numpy(rs.standard_normal((B, S, H, D))
                         .astype(np.float32)).bfloat16()
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    qls = torch.tensor([3, 1], dtype=torch.int32)
    anc = torch.tril(torch.ones(S, S, dtype=torch.bool)).expand(B, S, S)
    anc = anc.contiguous()
    got = ragged_flash_attention(q, kq, kq, pt, pos, qls, anc, scale=0.25,
                                 k_scales=ks, v_scales=ks)
    assert got.dtype == torch.bfloat16
    deq = quant.dequantize_pages(kq, ks)
    want = ragged_gather_attention(q.float(), deq, deq, pt, pos, qls, anc,
                                   scale=0.25).to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    got = ragged_flash_attention(q.float(), deq.bfloat16(), deq.bfloat16(),
                                 pt, pos, qls, anc, scale=0.25)
    want = ragged_gather_attention(q.float(), deq.bfloat16().float(),
                                   deq.bfloat16().float(), pt, pos, qls,
                                   anc, scale=0.25)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="int8"):  # no scales
        ragged_flash_attention(q, kq, kq, pt, pos, qls, anc, scale=0.25)
    with pytest.raises(ValueError, match="int8"):  # scales, fp pool
        ragged_flash_attention(q, deq, deq, pt, pos, qls, anc, scale=0.25,
                               k_scales=ks, v_scales=ks)
