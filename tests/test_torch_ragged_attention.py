"""The port's ragged paged attention held to the JAX reference.

On the CPU the kernel wrapper takes its plain PyTorch version; it must
agree with the reference's Pallas kernel (run in interpret mode) and its
gather fallback on the live rows of mixed batches — decode rows, prefill
chunks, token trees and padded entries in one launch — and write exact
zeros on rows at or past q_len, as the kernel does. The rope + page-write
+ attend step (ragged_paged_attention) is held to the reference's too,
pools included. The CUDA kernel itself is compared with the plain version
by tests/test_torch_cuda.py (skipped without a card) and chip_smoke.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu.paged.attention import (  # noqa: E402
    ragged_flash_attention as jax_ragged_flash_attention,
    ragged_gather_attention as jax_ragged_gather_attention,
    ragged_paged_attention as jax_ragged_paged_attention,
)
from flexflow_tpu_torch.paged.attention import (  # noqa: E402
    chain_descriptor,
    ragged_flash_attention,
    ragged_gather_attention,
    ragged_paged_attention,
)

# fp32 on the CPU: the reference kernel's own test tolerance
TOL = 2e-5


def _ancestor_masks(parents):
    """(T,) parent array -> (T, T) ancestor-or-self mask (node q may see
    node k's row when k lies on q's root path)."""
    T = len(parents)
    anc = np.zeros((T, T), bool)
    for j in range(T):
        anc[j, j] = True
        if parents[j] >= 0:
            anc[j] |= anc[parents[j]]
    return anc


def _ragged_entry(kind, S, rs):
    """(pos, q_len, anc) for one batch entry of a window-S launch."""
    anc = np.zeros((S, S), bool)
    if kind == "pad":
        return 0, 0, anc
    if kind == "decode":
        anc[0, 0] = True
        return int(rs.randint(1, 28)), 1, anc
    if kind == "chunk":
        n = int(rs.randint(2, S + 1))
        anc[:n, :n] = np.tril(np.ones((n, n), bool))
        return int(rs.randint(0, 24)), n, anc
    # tree: root + two branches sharing the root (a non-causal mask)
    n = min(S, 5)
    parents = np.full((S,), -1, np.int32)
    parents[:n] = np.array([-1, 0, 1, 0, 3], np.int32)[:n]
    anc[:] = _ancestor_masks(parents)
    return int(rs.randint(0, 24)), n, anc


def _case(H, Hkv, S, mix, D=32, P=8, N=24, MAXP=4):
    B = len(mix)
    rs = np.random.RandomState(1000 * S + len(mix))
    q = rs.standard_normal((B, S, H, D)).astype(np.float32)
    kc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    perm = rs.permutation(N - 1)[:B * MAXP] + 1  # distinct non-null pages
    pt = perm.reshape(B, MAXP).astype(np.int32)
    entries = [_ragged_entry(k, S, rs) for k in mix]
    pos = np.array([e[0] for e in entries], np.int32)
    q_lens = np.array([e[1] for e in entries], np.int32)
    anc = np.stack([e[2] for e in entries])
    return q, kc, vc, pt, pos, q_lens, anc, 1.0 / np.sqrt(D)


MIXES = [
    (8, 2, 1, ["decode", "decode", "decode"]),
    (8, 2, 4, ["chunk", "chunk"]),
    (8, 2, 4, ["decode", "chunk", "pad"]),
    (8, 2, 6, ["decode", "tree"]),
    (8, 2, 6, ["decode", "chunk", "tree", "pad"]),
    (4, 4, 6, ["decode", "chunk", "tree", "pad"]),  # MHA rep=1
]


@pytest.mark.parametrize("H,Hkv,S,mix", MIXES)
def test_plain_ragged_attention_matches_jax(H, Hkv, S, mix):
    q, kc, vc, pt, pos, q_lens, anc, scale = _case(H, Hkv, S, mix)
    jargs = [jnp.asarray(a) for a in (q, kc, vc, pt, pos, q_lens, anc)]
    targs = [torch.from_numpy(a) for a in (q, kc, vc, pt, pos, q_lens, anc)]
    want_kernel = np.asarray(jax_ragged_flash_attention(
        *jargs, scale=scale, interpret=True))
    want_gather = np.asarray(jax_ragged_gather_attention(*jargs,
                                                         scale=scale))
    got = ragged_flash_attention(*targs, scale=scale).numpy()
    got_plain = ragged_gather_attention(*targs, scale=scale).numpy()
    np.testing.assert_array_equal(got, got_plain)  # CPU -> plain version
    for b, kind in enumerate(mix):
        n = int(q_lens[b])
        np.testing.assert_allclose(got[b, :n], want_kernel[b, :n],
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"entry {b} {kind} vs kernel")
        np.testing.assert_allclose(got[b, :n], want_gather[b, :n],
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"entry {b} {kind} vs gather")
        # the kernel's contract: rows at or past q_len are exact zeros
        assert not got[b, n:].any(), f"entry {b} {kind} padded tail"
        assert not want_kernel[b, n:].any()


@pytest.mark.parametrize("H,Hkv", [(8, 2), (4, 4)])
def test_ragged_paged_attention_matches_jax(H, Hkv):
    """rope + page write + attend: a decode row, a 5-row chunk and a pad
    entry in one window-6 step over pools already holding a prefix. The
    output's live rows and the whole written pools match; the pad entry
    and rows past q_len only ever touch the null page 0."""
    B, S, D, P, N, MAXP = 3, 6, 16, 4, 12, 4
    rs = np.random.RandomState(11)
    q = rs.standard_normal((B, S, H, D)).astype(np.float32)
    k = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rs.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    vc = rs.standard_normal((N, P, Hkv, D)).astype(np.float32)
    pt = np.array([[3, 5, 0, 0], [7, 2, 9, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([6, 3, 0], np.int32)
    q_lens = np.array([1, 5, 0], np.int32)
    depths = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    anc = np.tile(np.tril(np.ones((S, S), bool)), (B, 1, 1))
    scale = 1.0 / np.sqrt(D)
    jout, jkc, jvc = jax_ragged_paged_attention(
        *[jnp.asarray(a) for a in (q, k, v, kc, vc, pt, pos, q_lens,
                                   depths, anc)],
        scale=scale, rope_theta=10000.0)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout, tkc2, tvc2 = ragged_paged_attention(
        *[torch.from_numpy(a) for a in (q, k, v)], tkc, tvc,
        *[torch.from_numpy(a) for a in (pt, pos, q_lens, depths, anc)],
        scale=scale, rope_theta=10000.0)
    assert tkc2 is tkc and tvc2 is tvc  # written in place
    jout = np.asarray(jout)
    for b in range(B):
        n = int(q_lens[b])
        np.testing.assert_allclose(tout[b, :n].numpy(), jout[b, :n],
                                   atol=TOL, rtol=TOL)
        assert not tout[b, n:].numpy().any()
    # every page but the garbage null page agrees
    np.testing.assert_allclose(tkc.numpy()[1:], np.asarray(jkc)[1:],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tvc.numpy()[1:], np.asarray(jvc)[1:],
                               atol=TOL, rtol=TOL)


def test_chain_descriptor_matches_jax():
    from flexflow_tpu.paged.attention import (
        chain_descriptor as jax_chain_descriptor,
    )

    for got, want in zip(chain_descriptor(3, 5), jax_chain_descriptor(3, 5)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_refuses_mixed_devices():
    q, kc, vc, pt, pos, q_lens, anc, scale = _case(8, 2, 4, ["chunk"])
    targs = [torch.from_numpy(a) for a in (q, kc, vc, pt, pos, q_lens, anc)]
    targs[0] = targs[0].to("meta")
    with pytest.raises(ValueError):
        ragged_flash_attention(*targs, scale=scale)

