"""The port's sequence-parallel ring attention held to the JAX reference on
the CPU: kernel K5's plain version against the reference's `_fwd_carry`
(Pallas, interpret mode), `ring_dot_product_attention` and its routes,
a tiny Llama built with `use_ring_attention` on a `{"seq": 4}` mesh
(predict, Adam steps through `fit`, the paged server's greedy tokens),
and what the slice does not port. The JAX legs set FF_TPU_FLASH_INTERPRET
through monkeypatch, so the reference runs its Pallas K5/K4 ring
(`ring_pallas_flash`) interpreted; its devices are the 8 CPU devices of
tests/conftest.py, the port's shards all live on its one CPU device.
Inputs are numpy arrays from a seed, weights carried across with
runtime.weights.params_from_numpy."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.ffconst import MetricsType as JMetricsType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.ops.pallas.flash_attention import _fwd_carry  # noqa: E402
from flexflow_tpu.parallel.ring import (  # noqa: E402
    ring_dot_product_attention as jring,
)
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    MetricsType,
    OpType,
)
from flexflow_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    build_llama,
    llama_pp_strategy,
)
from flexflow_tpu_torch.ops import flash_attention as fa  # noqa: E402
from flexflow_tpu_torch.ops import torch_ops  # noqa: E402
from flexflow_tpu_torch.parallel import ring  # noqa: E402
from flexflow_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from flexflow_tpu_torch.runtime.weights import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)

# the tolerances of tests/test_pallas_flash.py's ring tests: fp32 forward
# 2e-5 (block order of the online softmax), gradients 2e-4 (recomputed
# from the final lse)
FWD_TOL, GRAD_TOL = 2e-5, 2e-4
# a whole model's outputs and a whole training step (forward, backward,
# Adam): the fp32 bar of tests/test_align.py
TOL = 1e-4
LANES = 128
VOCAB = 512
_METRICS = ("ACCURACY", "SPARSE_CATEGORICAL_CROSSENTROPY")


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


def _count(monkeypatch, module, name, calls):
    """Wrap module.name so each call appends `name` to `calls`."""
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


# ---------------------------------------------------------------------------
# 1. K5's plain version against the reference's _fwd_carry


@pytest.mark.parametrize("D,S,T,causal,carried", [
    (8, 128, 128, True, False),
    (8, 128, 128, False, False),
    (64, 256, 256, True, True),
    (64, 128, 128, False, True),
    (8, 128, 256, False, True),    # S != T, full
    (64, 256, 128, False, False),  # S != T, full
    # the widths whose bf16 K5 runs the padded tensor-core tiles on the
    # card: 48 and 80, Phi-3-mini's 96 and OpenLLaMA-3B's 100
    (48, 128, 128, True, False),
    (80, 256, 256, False, True),
    (96, 256, 256, True, True),
    (96, 128, 128, False, False),
    (100, 256, 256, True, False),
    (100, 128, 128, False, True),
    (100, 128, 256, False, True),  # S != T, full
])
def test_fwd_carry_plain_version_matches_jax(D, S, T, causal, carried):
    """(m, l, acc) after one fold, fp32, from the initial statistics or
    from those of an earlier fold of another block (a carry in). The
    reference's m and l are broadcast over 128 lanes; the port's are
    (BH, S). The reference's kernel takes D as the caller gives it (its
    ring lane-pads D to 128 before the call); the port's takes it too."""
    BH, scale = 3, 1.0 / np.sqrt(D)
    rs = np.random.RandomState(D + S + T + causal + carried)
    q = rs.standard_normal((BH, S, D)).astype(np.float32)
    k, v = (rs.standard_normal((BH, T, D)).astype(np.float32)
            for _ in range(2))
    m = np.full((BH, S, LANES), -1e30, np.float32)
    l = np.zeros((BH, S, LANES), np.float32)
    acc = np.zeros((BH, S, D), np.float32)
    if carried:
        k0, v0 = (rs.standard_normal((BH, T, D)).astype(np.float32)
                  for _ in range(2))
        m, l, acc = (np.array(a) for a in _fwd_carry(
            *map(jnp.asarray, (q, k0, v0, m, l, acc)), False, scale, 128,
            128, True))
    jm, jl, jacc = _fwd_carry(*map(jnp.asarray, (q, k, v, m, l, acc)),
                              causal, scale, 128, 128, True)
    tm, tl, tacc = fa.flash_bh_fwd_carry(
        *map(torch.from_numpy, (q, k, v, m[..., 0].copy(), l[..., 0].copy(),
                                acc)), causal, scale)
    for name, got, want in (("m", tm, np.asarray(jm)[..., 0]),
                            ("l", tl, np.asarray(jl)[..., 0]),
                            ("acc", tacc, np.asarray(jacc))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL,
                                   rtol=FWD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# 2. ring_dot_product_attention, port against JAX


def _ring_inputs(B=2, S=512, H=2, Hkv=2, D=8, seed=0):
    """tests/test_pallas_flash.py's _ring_setup shapes, and a fixed
    upstream gradient w (d sum(out * w) / d out = w)."""
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, S, H, D)).astype(np.float32),
            rs.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rs.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rs.standard_normal((B, S, H, D)).astype(np.float32))


def _jax_ring(q, k, v, w, n, causal, grads):
    """The reference's ring on a (data 1, seq n) mesh of CPU devices:
    (out, (dq, dk, dv) or None)."""
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "seq"))

    def loss(q, k, v):
        with mesh:
            out = jring(q, k, v, mesh=mesh, causal=causal, scale=0.3)
        return jnp.sum(out * jnp.asarray(w)), out

    args = tuple(map(jnp.asarray, (q, k, v)))
    if not grads:
        return np.asarray(jax.jit(loss)(*args)[1]), None
    (_, out), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True))(*args)
    return np.asarray(out), [np.asarray(a) for a in g]


def _port_ring(q, k, v, w, n, causal, grads):
    mesh = make_mesh({"data": 1, "seq": n})
    ts = [torch.from_numpy(a).requires_grad_(grads) for a in (q, k, v)]
    out = ring.ring_dot_product_attention(*ts, mesh=mesh, causal=causal,
                                          scale=0.3)
    if not grads:
        return out.detach().numpy(), None
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_forward_matches_jax(monkeypatch, causal):
    """B 2, S 512, H 2, D 8 over 4 shards (s_loc 128): both sides take
    the flash ring (K5 in the port, the Pallas ring in JAX)."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    calls = []
    _count(monkeypatch, ring, "ring_flash_attention", calls)
    q, k, v, w = _ring_inputs()
    jout, _ = _jax_ring(q, k, v, w, 4, causal, grads=False)
    assert jax_ops.LAST_ATTENTION_KERNEL == "ring_pallas_flash"
    tout, _ = _port_ring(q, k, v, w, 4, causal, grads=False)
    assert calls == ["ring_flash_attention"]
    np.testing.assert_allclose(tout, jout, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 2)])
def test_ring_gradients_match_jax(monkeypatch, H, Hkv):
    """The forward and the gradients of q, k and v through the two-pass
    ring (causal, S 512 over 4 shards, s_loc 128: the flash ring on both
    sides): MHA, and GQA with kv unrepeated on the ring, dk and dv at the
    kv heads' shape."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    q, k, v, w = _ring_inputs(H=H, Hkv=Hkv, seed=H + Hkv)
    jout, jg = _jax_ring(q, k, v, w, 4, True, grads=True)
    assert jax_ops.LAST_ATTENTION_KERNEL == "ring_pallas_flash"
    tout, tg = _port_ring(q, k, v, w, 4, True, grads=True)
    np.testing.assert_allclose(tout, jout, atol=FWD_TOL, rtol=FWD_TOL)
    assert tg[1].shape == k.shape and tg[2].shape == v.shape
    for name, got, want in zip("qkv", tg, jg):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# 3. the routes


def test_untileable_local_sequence_takes_the_einsum_ring(monkeypatch):
    """S 64 over 4 shards (s_loc 16, not a multiple of 128): the reference
    takes its einsum online-softmax ring (the route the name states, and
    asserted below as the yardstick's); the port keeps one length rule
    for both attention routes (no length gate) and takes the K5 ring, and
    the two agree, forward and gradients. The port folds the 10 causal
    blocks through K5's plain version and runs K4's dq and dk/dv plain
    versions once per folded block."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    calls = []
    for name in ("ring_flash_attention", "fused_attention"):
        _count(monkeypatch, ring, name, calls)
    for name in ("flash_bh_fwd_carry_reference", "flash_bh_dq_reference",
                 "flash_bh_dkv_reference"):
        _count(monkeypatch, fa, name, calls)
    q, k, v, w = _ring_inputs(S=64, H=4, Hkv=2, seed=5)
    jout, jg = _jax_ring(q, k, v, w, 4, True, grads=True)
    assert jax_ops.LAST_ATTENTION_KERNEL == "ring_online_softmax"
    tout, tg = _port_ring(q, k, v, w, 4, True, grads=True)
    assert calls == (["ring_flash_attention"]
                     + ["flash_bh_fwd_carry_reference"] * 10
                     + ["flash_bh_dq_reference",
                        "flash_bh_dkv_reference"] * 10)
    np.testing.assert_allclose(tout, jout, atol=FWD_TOL, rtol=FWD_TOL)
    for name, got, want in zip("qkv", tg, jg):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ring_runs_the_k5_schedule(monkeypatch, causal):
    """Over 4 shards the flash ring folds 10 blocks causally (6 full, 4
    diagonal, 6 skipped) and 16 without causality, through K5's plain
    version on the CPU; its backward runs K4's dq and dk/dv plain
    versions once per folded block, and nothing else attends."""
    calls, modes = [], []
    real = fa.flash_bh_fwd_carry_reference

    def k5(q, k, v, m, l, acc, blk_causal, scale):
        modes.append(blk_causal)
        return real(q, k, v, m, l, acc, blk_causal, scale)

    monkeypatch.setattr(fa, "flash_bh_fwd_carry_reference", k5)
    for name in ("flash_bh_dq_reference", "flash_bh_dkv_reference",
                 "flash_attention_reference", "flash_bh_reference"):
        _count(monkeypatch, fa, name, calls)
    q, k, v, w = _ring_inputs(S=512, H=4, Hkv=2, seed=6)
    _port_ring(q, k, v, w, 4, causal, grads=True)
    folded = 10 if causal else 16
    assert len(modes) == folded
    assert sum(modes) == (4 if causal else 0)
    assert calls.count("flash_bh_dq_reference") == folded
    assert calls.count("flash_bh_dkv_reference") == folded
    assert len(calls) == 2 * folded


def test_seq_size_one_takes_plain_flash_attention(monkeypatch):
    """No seq axis, or one of size 1: plain attention (fused_attention,
    the flash kernels' route), as the reference."""
    calls = []
    for name in ("ring_flash_attention", "fused_attention"):
        _count(monkeypatch, ring, name, calls)
    q, k, v, _ = _ring_inputs(S=128, H=4, Hkv=2, seed=7)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    want = fa.flash_attention(*ts, causal=True, scale=0.3)
    for mesh in (None, make_mesh({"data": 1}),
                 make_mesh({"seq": 1})):
        out = ring.ring_dot_product_attention(*ts, mesh=mesh, causal=True,
                                              scale=0.3)
        torch.testing.assert_close(out, want, atol=0, rtol=0)
    assert calls == ["fused_attention"] * 3


# ---------------------------------------------------------------------------
# 4. a tiny Llama on a {"seq": 4} mesh


def _pair(seq, batch=2, mesh_shape=None, ring_attn=True, lr=1e-4,
          optimizer=True, cfg=None):
    """A tiny Llama (or one of LlamaConfig fields `cfg`) in each package
    (fp32) with the JAX model's initial weights carried to the port's;
    both compiled with Adam(lr)."""
    jcfg = JLlamaConfig(**cfg) if cfg else JLlamaConfig.tiny(VOCAB)
    tcfg = LlamaConfig(**cfg) if cfg else LlamaConfig.tiny(VOCAB)
    jff = JFFModel(JFFConfig(batch_size=batch, seed=3, mesh_shape=mesh_shape))
    jbuild_llama(jff, jcfg, batch_size=batch, seq_len=seq,
                 dtype=JDataType.FLOAT, use_ring_attention=ring_attn)
    tff = FFModel(FFConfig(batch_size=batch, seed=3, device="cpu",
                           mesh_shape=mesh_shape))
    build_llama(tff, tcfg, batch_size=batch, seq_len=seq,
                dtype=DataType.FLOAT, use_ring_attention=ring_attn)
    if optimizer:
        jff.compile(optimizer=jopt.AdamOptimizer(lr=lr),
                    loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                    metrics=[getattr(JMetricsType, m) for m in _METRICS])
        tff.compile(optimizer=AdamOptimizer(lr=lr),
                    metrics=[getattr(MetricsType, m) for m in _METRICS],
                    params=params_from_numpy(*map(_np_tree, jff._params),
                                             device="cpu"))
    else:
        jff.compile(loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        tff.compile(params=params_from_numpy(*map(_np_tree, jff._params),
                                             device="cpu"))
    return jff, tff


def _tokens(n, seq, seed):
    x = np.random.RandomState(seed).randint(0, VOCAB, (n, seq)).astype(
        np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def test_build_llama_ring_same_graph_in_both_packages():
    jff = JFFModel(JFFConfig(batch_size=1, seed=0))
    jbuild_llama(jff, JLlamaConfig.tiny(), batch_size=1, seq_len=16,
                 use_ring_attention=True)
    tff = FFModel(FFConfig(batch_size=1, seed=0, device="cpu"))
    build_llama(tff, LlamaConfig.tiny(), batch_size=1, seq_len=16,
                use_ring_attention=True)

    def describe(ff):
        return [(n.stable_key(), n.op_type.value, repr(n.attrs))
                for n in ff.graph.topo_order()]

    assert describe(jff) == describe(tff)
    assert jff.graph.structure_hash() == tff.graph.structure_hash()
    assert [n.op_type for n in tff.graph.topo_order()].count(
        OpType.RING_ATTENTION) == 2


def test_ring_llama_predict_matches_jax(monkeypatch):
    """predict at seq 512 (s_loc 128: the flash ring on both sides) and at
    seq 64 (s_loc 16: the reference's einsum ring, the port's K5 ring),
    the reference on its {"seq": 4} mesh of CPU devices, the port's
    shards on its CPU."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    for seq, kernel in ((512, "ring_pallas_flash"),
                        (64, "ring_online_softmax")):
        jff, tff = _pair(seq, mesh_shape={"seq": 4}, optimizer=False)
        assert tff.mesh.axes == {"seq": 4}
        x, _ = _tokens(2, seq, seed=seq)
        want = jff.predict(x)
        assert jax_ops.LAST_ATTENTION_KERNEL == kernel
        np.testing.assert_allclose(tff.predict(x), want, atol=TOL, rtol=TOL,
                                   err_msg=f"seq {seq}")


def test_ring_llama_adam_steps_through_fit_match_jax(monkeypatch):
    """Three Adam steps through fit (batch 2, seq 512, {"seq": 4}): the
    epoch's summed loss and every parameter afterwards within TOL. lr
    1e-4, as tests/test_torch_gpt2.py's Adam test gives the reason: Adam's
    first steps move a weight by about lr whatever its gradient."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    calls = []
    _count(monkeypatch, ring, "ring_flash_attention", calls)
    jff, tff = _pair(512, mesh_shape={"seq": 4})
    x, y = _tokens(6, 512, seed=1)
    jm = jff.fit(x, y, verbose=False)
    assert jax_ops.LAST_ATTENTION_KERNEL == "ring_pallas_flash"
    tm = tff.fit(x, y, verbose=False)
    # two layers, three steps, remat="attention" re-running each forward
    assert calls == ["ring_flash_attention"] * (2 * 3 * 2)
    assert tm.train_all == jm.train_all == 6
    np.testing.assert_allclose(tm.sparse_cce_loss, jm.sparse_cce_loss,
                               atol=TOL, rtol=TOL)
    got, _ = params_to_numpy(*tff._params)
    for k, w in jff._params[0].items():
        for n, a in w.items():
            assert got[k][n].dtype == np.float32  # fp32 masters
            np.testing.assert_allclose(got[k][n], np.asarray(a), atol=TOL,
                                       rtol=TOL, err_msg=(k, n))


# the head geometries of Phi-3-mini (dim 3072, 32 = 32 kv heads of 96)
# and OpenLLaMA-3B (dim 3200, 32 = 32 kv heads of 100) at a small size:
# 2 heads over 2 kv heads, hidden 512, 2 layers
WIDE_HEADS = {
    96: dict(vocab_size=VOCAB, dim=192, layers=2, heads=2, kv_heads=2,
             hidden=512, rope_theta=10000.0),
    100: dict(vocab_size=VOCAB, dim=200, layers=2, heads=2, kv_heads=2,
              hidden=512, rope_theta=10000.0),
}


@pytest.mark.parametrize("head_dim", sorted(WIDE_HEADS))
def test_ring_llama_at_wide_head_dims_matches_jax(monkeypatch, head_dim):
    """A ring Llama at head dim 96 (Phi-3-mini's) or 100 (OpenLLaMA-3B's)
    on {"seq": 4}, seq 512 (s_loc 128: the flash ring on both sides, the
    reference's lane-padding D to 128, the port's taking D as it is):
    predict, then three Adam steps through fit (batch 2, lr 1e-4), the
    epoch's summed loss and every parameter afterwards within TOL. Every
    K5 fold of the port runs at `head_dim`, 10 per ring call."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    rings, folds = [], []
    _count(monkeypatch, ring, "ring_flash_attention", rings)
    real = fa.flash_bh_fwd_carry_reference

    def k5(q, *args):
        folds.append(q.shape[-1])
        return real(q, *args)

    monkeypatch.setattr(fa, "flash_bh_fwd_carry_reference", k5)
    jff, tff = _pair(512, mesh_shape={"seq": 4}, cfg=WIDE_HEADS[head_dim])
    x, y = _tokens(6, 512, seed=head_dim)
    want = jff.predict(x[:2])
    assert jax_ops.LAST_ATTENTION_KERNEL == "ring_pallas_flash"
    np.testing.assert_allclose(tff.predict(x[:2]), want, atol=TOL, rtol=TOL)
    jm = jff.fit(x, y, verbose=False)
    tm = tff.fit(x, y, verbose=False)
    assert rings and folds == [head_dim] * (10 * len(rings))
    assert tm.train_all == jm.train_all == 6
    np.testing.assert_allclose(tm.sparse_cce_loss, jm.sparse_cce_loss,
                               atol=TOL, rtol=TOL)
    got, _ = params_to_numpy(*tff._params)
    for k, w in jff._params[0].items():
        for n, a in w.items():
            np.testing.assert_allclose(got[k][n], np.asarray(a), atol=TOL,
                                       rtol=TOL, err_msg=(k, n))


def test_ring_llama_without_a_mesh_equals_the_mha_llama():
    """With no mesh (seq size 1) a ring-built model is the MHA-built one
    on the same weights: predict and a training step, equal."""
    x, y = _tokens(2, 128, seed=2)
    out = []
    for use_ring in (False, True):
        ff = FFModel(FFConfig(batch_size=2, seed=4, device="cpu"))
        build_llama(ff, LlamaConfig.tiny(VOCAB), batch_size=2, seq_len=128,
                    dtype=DataType.FLOAT, use_ring_attention=use_ring)
        ff.compile(optimizer=AdamOptimizer(lr=1e-3))
        probs = ff.predict(x)
        ff.fit(x, y, verbose=False)
        out.append((probs, params_to_numpy(*ff._params)[0]))
    (pa, wa), (pb, wb) = out
    np.testing.assert_array_equal(pa, pb)
    assert wa.keys() == wb.keys()
    for k in wa:
        for n in wa[k]:
            np.testing.assert_array_equal(wa[k][n], wb[k][n])


# ---------------------------------------------------------------------------
# 5. the paged server on a ring-built model


def test_ring_llama_paged_server_greedy_tokens_match_jax(monkeypatch):
    """A ring-built tiny Llama on a {"seq": 4} mesh served paged (page 4,
    2 slots, 5 new tokens): the port's greedy tokens are the JAX paged
    server's and generate()'s, every step goes through the MHA paged
    branch, and the pool is clean after the drain."""
    jff, tff = _pair(32, batch=1, mesh_shape={"seq": 4}, optimizer=False)
    calls = []
    _count(monkeypatch, torch_ops, "_mha", calls)
    _count(monkeypatch, ring, "ring_attention_lowering", calls)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32)
               for n in (3, 9, 6)]
    want = [jff.generate(p[None, :], max_new_tokens=5)[0] for p in prompts]
    out = []
    for ff in (jff, tff):
        server = ff.serve_generation(slots=2, max_len=32, paged=True,
                                     page_size=4)
        try:
            out.append([f.result(timeout=120) for f in
                        [server.submit(p, max_new_tokens=5)
                         for p in prompts]])
        finally:
            server.stop()
    for w, j, t in zip(want, *out):
        np.testing.assert_array_equal(j, w)
        np.testing.assert_array_equal(t, w)
    server.pool.check_invariants(owners={})
    assert calls and set(calls) == {"_mha"}
    assert len(calls) == 2 * server.ragged_steps


# ---------------------------------------------------------------------------
# 6. what the slice does not port


def test_unported_parallelism_raises():
    """A mesh axis other than seq above 1, Ulysses and the pipeline
    strategy (GPipe stages over a `pipe` axis) raise NotImplementedError
    naming ROADMAP; nothing is ignored. The PIPELINE composite itself
    builds: its blocks run in turn on one device."""
    for shape in ({"model": 2}, {"data": 2, "seq": 2}, {"pipe": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            FFConfig(device="cpu", mesh_shape=shape)
    with pytest.raises(ValueError, match="positive"):
        FFConfig(device="cpu", mesh_shape={"seq": 0})
    ff = FFModel(FFConfig(batch_size=1, device="cpu",
                          mesh_shape={"data": 1, "seq": 2}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_llama(ff, LlamaConfig.tiny(), batch_size=1, seq_len=8,
                    use_ring_attention=True, seq_mode="ulysses")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama_pp_strategy(LlamaConfig.tiny())
    build_llama(ff, LlamaConfig.tiny(), batch_size=1, seq_len=8,
                use_pipeline=True)
    x = ff.create_tensor((1, 8, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ff.ulysses_attention(x, x, x, 16, 2)
    with pytest.raises(ValueError, match="split"):
        ring.ring_dot_product_attention(
            *(torch.zeros(1, 10, 2, 8),) * 3,
            mesh=make_mesh({"seq": 4}), causal=True, scale=0.1)
