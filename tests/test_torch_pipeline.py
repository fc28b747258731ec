"""The PIPELINE composite on one device, held to the JAX reference on the
CPU: build_llama(use_pipeline=True) in both packages, the JAX weights
carried over (runtime.weights.params_from_numpy), seeded numpy inputs.
The JAX side runs its `_pipeline` without a `pipe` axis (the lax.scan
over the layer stack) with its Pallas flash kernels interpreted
(FF_TPU_FLASH_INTERPRET=1 through monkeypatch): K4 at the tiny Llama's
head dim 16, K1/K2 at head dim 128. The port runs the blocks in turn,
the plain versions of the same kernels on CPU tensors."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu.ops import jax_ops  # noqa: E402
from flexflow_tpu.runtime import loss as jloss  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
    OpType,
)
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.runtime.weights import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)

# a forward, a gradient or a whole Adam step over a model in fp32: the
# fp32 bar of tests/test_align.py
TOL = 1e-4
SEQ = 128  # the reference's _pick_block tiles it: its flash path runs
VOCAB = 256
# head dim 16 (K4's route) and 128 (K1/K2's)
CONFIGS = {
    "d16": dict(vocab_size=VOCAB, dim=64, layers=2, heads=4, kv_heads=2,
                hidden=128, rope_theta=10000.0),
    "d128": dict(vocab_size=VOCAB, dim=256, layers=2, heads=2, kv_heads=1,
                 hidden=256, rope_theta=10000.0),
}


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


def _pair(kind="d16", batch=2, seq=SEQ, lr=None, n_microbatches=4):
    """The PIPELINE Llama in each package, fp32, the port's carrying the
    JAX model's initial weights; compiled with Adam(lr) when `lr`."""
    cfg = CONFIGS[kind]
    jff = JFFModel(JFFConfig(batch_size=batch, seed=5, num_devices=1,
                             remat="none"))
    jbuild_llama(jff, JLlamaConfig(**cfg), batch_size=batch, seq_len=seq,
                 dtype=JDataType.FLOAT, use_pipeline=True,
                 n_microbatches=n_microbatches)
    tff = FFModel(FFConfig(batch_size=batch, seed=5, device="cpu",
                           remat="none"))
    build_llama(tff, LlamaConfig(**cfg), batch_size=batch, seq_len=seq,
                dtype=DataType.FLOAT, use_pipeline=True,
                n_microbatches=n_microbatches)
    lt = JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
    if lr is None:
        jff.compile(loss_type=lt)
        tff.compile(params=params_from_numpy(*map(_np_tree, jff._params),
                                             device="cpu"))
    else:
        jff.compile(optimizer=jopt.AdamOptimizer(lr=lr), loss_type=lt)
        tff.compile(optimizer=AdamOptimizer(lr=lr),
                    params=params_from_numpy(*map(_np_tree, jff._params),
                                             device="cpu"))
    return jff, tff


def _tokens(n, seq, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, VOCAB, (n, seq)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def test_pipeline_graph_and_leaves_match_jax():
    """Same PCG (one PIPELINE node between the embedding and the final
    norm, attrs repr-equal, n_microbatches carried) and the same stacked
    leaves: shapes, dtypes, initializers ("ones" for the two norms)."""
    from flexflow_tpu.runtime.executor import Executor as JExecutor

    cfg = CONFIGS["d16"]
    jff = JFFModel(JFFConfig(batch_size=2, seed=0))
    jbuild_llama(jff, JLlamaConfig(**cfg), batch_size=2, seq_len=8,
                 use_pipeline=True, n_microbatches=2)
    tff = FFModel(FFConfig(batch_size=2, seed=0, device="cpu"))
    build_llama(tff, LlamaConfig(**cfg), batch_size=2, seq_len=8,
                use_pipeline=True, n_microbatches=2)

    def describe(ff):
        return [(n.stable_key(), n.op_type.value, repr(n.attrs),
                 [(tuple(d.size for d in o.dims), o.dtype.value)
                  for o in n.outputs])
                for n in ff.graph.topo_order()]

    assert describe(jff) == describe(tff)
    assert [n.op_type for n in tff.graph.topo_order()].count(
        OpType.PIPELINE) == 1
    jff.graph.infer_shapes()
    jspecs = JExecutor(jff.graph, None, loss_type=None, metrics=(),
                       optimizer=None).weight_specs()
    tspecs = tff.compile().executor.weight_specs()
    assert {k: {n: (s.shape.dims, s.shape.dtype.value, s.initializer,
                    s.trainable) for n, s in w.items()}
            for k, w in tspecs.items()} == \
        {k: {n: (s.shape.dims, s.shape.dtype.value, s.initializer,
                 s.trainable) for n, s in w.items()}
         for k, w in jspecs.items()}
    pipe = next(n for n in tff.graph.nodes if n.op_type == OpType.PIPELINE)
    jpipe = next(n for n in jff.graph.nodes if n.name == pipe.name)
    ins = tff.graph.input_shapes(pipe)
    assert pipe.attrs.flops(ins, pipe.outputs) == jpipe.attrs.flops(
        jff.graph.input_shapes(jpipe), jpipe.outputs)
    # the norms of a fresh draw are ones, stored fp32 (their use site)
    tr, _ = tff._params
    ln1 = tr[pipe.stable_key()]["ln1"]
    assert ln1.dtype == torch.float32 and bool((ln1 == 1).all())


@pytest.mark.parametrize("kind", ["d16", "d128"])
def test_pipeline_forward_matches_jax(monkeypatch, kind):
    """Forward logits (the sink softmax skipped) and predict, fp32, seq
    128: the JAX scan through its interpreted Pallas flash kernels."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    jff, tff = _pair(kind)
    x, _ = _tokens(2, SEQ, seed=0)
    jl = jff.executor.run_forward(*jff._params, [jnp.asarray(x)],
                                  training=False, rng=None,
                                  skip_sink_softmax=True)[0]
    assert jax_ops.LAST_ATTENTION_KERNEL == "pallas_flash"
    tl = tff.executor.run_forward(*tff._params, [torch.from_numpy(x)],
                                  skip_sink_softmax=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tff.predict(x), np.asarray(jff.predict(x)),
                               atol=TOL, rtol=TOL)


def test_pipeline_gradients_match_jax(monkeypatch):
    """The loss and the gradient of every stacked leaf (and of the
    embedding, final norm and head) of one batch, fp32, within TOL."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    jff, tff = _pair(lr=1e-4)
    x, y = _tokens(2, SEQ, seed=2)
    lt = JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
    jtr, jntr = jff._params

    def jloss_fn(tr):
        logits = jff.executor.run_forward(
            tr, jntr, [jnp.asarray(x)], training=True,
            rng=jax.random.key(0), skip_sink_softmax=True)[0]
        return jloss.compute_loss(lt, logits, jnp.asarray(y), False)

    jl, jg = jax.value_and_grad(jloss_fn)(jtr)
    ttr, tntr = tff._params
    tl, _, tg = tff.executor.loss_and_grads(ttr, tntr, torch.from_numpy(y),
                                            torch.from_numpy(x))
    np.testing.assert_allclose(float(tl), float(jl), atol=TOL, rtol=TOL)
    pipe = next(n for n in tff.graph.nodes if n.op_type == OpType.PIPELINE)
    assert set(tg[pipe.stable_key()]) == {"ln1", "wq", "wk", "wv", "wo",
                                          "ln2", "gate", "up", "down"}
    for k, w in jg.items():
        for n, a in w.items():
            np.testing.assert_allclose(tg[k][n].numpy(), np.asarray(a),
                                       atol=TOL, rtol=TOL, err_msg=(k, n))


def test_pipeline_adam_steps_match_jax(monkeypatch):
    """Three Adam steps (lr 1e-4, batch 2, seq 128): every step's loss and
    every parameter afterwards within TOL."""
    monkeypatch.setenv("FF_TPU_FLASH_INTERPRET", "1")
    jff, tff = _pair(lr=1e-4)
    x, y = _tokens(6, SEQ, seed=1)
    jstep = jff.executor.train_step()
    jtr, jntr = jff._params
    jos = jff._opt_state
    ttr, tntr = tff._params
    tos = tff._opt_state
    for i in range(3):
        bx, by = x[2 * i:2 * i + 2], y[2 * i:2 * i + 2]
        jtr, jntr, jos, jm = jstep(jtr, jntr, jos, jax.random.key(i),
                                   jnp.asarray(by), jnp.asarray(bx))
        ttr, tntr, tos, tm = tff.executor.train_step(
            ttr, tntr, tos, torch.from_numpy(by), torch.from_numpy(bx))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL,
                                   err_msg=f"loss of step {i}")
    got, _ = params_to_numpy(ttr, tntr)
    for k, w in jtr.items():
        for n, a in w.items():
            assert got[k][n].dtype == np.float32  # fp32 masters
            np.testing.assert_allclose(got[k][n], np.asarray(a), atol=TOL,
                                       rtol=TOL, err_msg=(k, n))


def test_pipeline_generate_through_the_stacked_cache_matches_jax():
    """Greedy generate through the layer-stacked dense cache ((L, b,
    max_len, Hkv, D) "k"/"v"): the JAX package's tokens, token for
    token, and the cache's shape."""
    jff, tff = _pair(batch=2, seq=8)
    rs = np.random.RandomState(3)
    prompts = rs.randint(0, VOCAB, (2, 6)).astype(np.int32)
    want = np.asarray(jff.generate(prompts, max_new_tokens=8))
    np.testing.assert_array_equal(tff.generate(prompts, 8), want)
    caches = tff.executor.init_kv_cache(2, 14)
    (bufs,) = caches.values()
    assert tuple(bufs["k"].shape) == (2, 2, 14, 2, 16)


def test_pipeline_paged_path_raises_the_reference_value_error():
    """Paged decode has no PIPELINE path in either package:
    can_paged_decode is False and the paged server raises the
    reference's ValueError; the dense server serves it, each request's
    greedy tokens those of the JAX package's generate."""
    jff, tff = _pair(batch=1, seq=8)
    assert not tff.executor.can_paged_decode()
    assert not jff.executor.can_paged_decode()
    with pytest.raises(ValueError) as je:
        jff.executor.paged_kv_cache_specs(4, 4)
    with pytest.raises(ValueError) as te:
        tff.serve_generation(paged=True, slots=1, max_len=16, page_size=4)
    assert str(te.value) == str(je.value)
    # the dense server's slots are the stacked cache's SECOND dim
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in (5, 3, 7)]
    server = tff.serve_generation(slots=2, max_len=16)
    try:
        futs = [server.submit(p, 4) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
    finally:
        server.stop()
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(
            g, np.asarray(jff.generate(p[None], max_new_tokens=4)[0]))


def test_pipeline_equals_the_unstacked_build_on_its_weights():
    """The composite is the unstacked builder's blocks: an unstacked
    Llama's per-layer leaves stacked on a leading layer dim give the same
    logits (fp32, both through the port), which is what the chip check
    of the PIPELINE training phase relies on."""
    cfg = LlamaConfig(**CONFIGS["d16"])
    flat = FFModel(FFConfig(batch_size=2, seed=9, device="cpu"))
    build_llama(flat, cfg, batch_size=2, seq_len=16, dtype=DataType.FLOAT)
    flat.compile()
    pipe = FFModel(FFConfig(batch_size=2, seed=9, device="cpu"))
    build_llama(pipe, cfg, batch_size=2, seq_len=16, dtype=DataType.FLOAT,
                use_pipeline=True)
    pipe.compile()
    ftr, _ = flat._params
    by_name = {n.name: n.stable_key() for n in flat.graph.nodes}
    pkeys = {n.name: n.stable_key() for n in pipe.graph.nodes}
    tr, ntr = pipe._params
    src = {"ln1": ("attn_norm", "scale"), "wq": ("attn", "wq"),
           "wk": ("attn", "wk"), "wv": ("attn", "wv"),
           "wo": ("attn", "wo"), "ln2": ("mlp_norm", "scale"),
           "gate": ("gate", "kernel"), "up": ("up", "kernel"),
           "down": ("down", "kernel")}
    stack = tr[pkeys["decoder_pipeline"]]
    for leaf, (node, w) in src.items():
        stack[leaf] = torch.stack([ftr[by_name[f"l{i}_{node}"]][w]
                                   for i in range(cfg.layers)])
    for name, w in (("tok_emb", "kernel"), ("final_norm", "scale"),
                    ("lm_head", "kernel")):
        tr[pkeys[name]][w] = ftr[by_name[name]][w]
    x, _ = _tokens(2, 16, seed=4)
    np.testing.assert_allclose(pipe.predict(x), flat.predict(x), atol=1e-6,
                               rtol=1e-6)
