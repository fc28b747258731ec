"""The activation cache, the initializer overrides and int8 weight storage
of the port, held to the JAX reference on the CPU: CACHE on one graph
trained in both packages, every initializer by name and by object (the
exact ones equal to the reference's, the random ones by their bounds or
moments: torch.Generator and jax.random draw different numbers from the
same seed), `_fans`, the layer methods' override keys, quantize_leaf bit
for bit, and init_params(weight_dtype=...)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import SGDOptimizer as JSGD  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.paged.quant import quantize_leaf as jquantize_leaf  # noqa: E402
from flexflow_tpu.runtime import initializer as jinit  # noqa: E402
from flexflow_tpu_torch import (  # noqa: E402
    DataType,
    FFConfig,
    FFModel,
    LossType,
    SGDOptimizer,
)
from flexflow_tpu_torch.paged.quant import QMAX, quantize_leaf  # noqa: E402
from flexflow_tpu_torch.runtime import initializer as tinit  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402

# fp32 on the CPU, same weights, a few SGD steps: summation order only
TOL = 1e-5
# a sample moment of N uniform or normal draws against its exact value:
# 6 standard errors for N = 256 * 512 (a false failure ~1e-9 per check)
N_DRAW = (256, 512)
SIGMAS = 6.0


# ---------------------------------------------------------------------------
# CACHE


def _cache_pair():
    """x (16, 8) -> cache "acts" (score: 1 - mean |old - new|) -> dense 4
    -> softmax in both packages, SGD lr 0.01, the port carrying the JAX
    weights."""

    def score(old, new):
        return float(1.0 - np.abs(old - new).mean())

    jff = JFFModel(JFFConfig(batch_size=16, num_devices=1))
    x = jff.create_tensor((16, 8), name="x")
    jff.softmax(jff.dense(jff.cache(x, score_func=score, name="acts"), 4,
                          name="d0"), name="sm")
    jff.compile(optimizer=JSGD(lr=0.01),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = FFModel(FFConfig(batch_size=16, device="cpu"))
    x = tff.create_tensor((16, 8), name="x")
    tff.softmax(tff.dense(tff.cache(x, score_func=score, name="acts"), 4,
                          name="d0"), name="sm")
    tff.compile(optimizer=SGDOptimizer(lr=0.01),
                loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                params=params_from_numpy(
                    *({k: {n: np.asarray(a) for n, a in w.items()}
                       for k, w in t.items()} for t in jff._params),
                    device="cpu"))
    return jff, tff


def test_cache_trains_writes_inference_reads_and_scores_as_jax():
    """A training step writes the batch into the non-trainable buffer and
    passes it on; predict returns the buffer whatever it is given; the
    host score runs on (previous snapshot, current buffer), 1.0 first;
    the default score is the cosine similarity. Each against JAX."""
    jff, tff = _cache_pair()
    rs = np.random.RandomState(0)
    xs = rs.randn(32, 8).astype(np.float32)
    ys = rs.randint(0, 4, 32).astype(np.int32)
    (key,) = [n.stable_key() for n in tff.graph.nodes if n.name == "acts"]
    assert tff._params[1][key]["cached"].abs().sum() == 0  # zeros
    for ff in (jff, tff):
        ff.fit(xs, ys, epochs=1, verbose=False)
    got = tff.get_weight("acts", "cached")
    np.testing.assert_array_equal(got, xs[16:])  # the last batch
    np.testing.assert_array_equal(
        got, np.asarray(jff._params[1][key]["cached"]))
    assert "cached" not in tff._params[0].get(key, {})  # not trainable
    # predict reads the buffer: any input gives the cached batch's rows
    other = rs.randn(16, 8).astype(np.float32)
    want = np.asarray(jff.predict(other))
    np.testing.assert_allclose(tff.predict(other), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tff.predict(xs[:16]), want, atol=TOL,
                               rtol=TOL)
    assert tff.cache_score("acts") == jff.cache_score("acts") == 1.0
    for ff in (jff, tff):
        ff.fit(xs, ys, epochs=1, verbose=False)
    same = tff.cache_score("acts")
    assert same == pytest.approx(jff.cache_score("acts"), abs=TOL)
    assert same == 1.0  # the same last batch
    for ff in (jff, tff):
        ff.fit(xs * 100.0, ys, epochs=1, verbose=False)
    shifted = tff.cache_score("acts")
    assert shifted == pytest.approx(jff.cache_score("acts"), rel=TOL)
    assert shifted < 0.5
    # the default score (no score_func): cosine similarity, as JAX's
    jff._cache_scores.clear()
    tff._cache_scores.clear()
    for ff in (jff, tff):
        ff.fit(xs, ys, epochs=1, verbose=False)
    assert tff.cache_score("acts") == pytest.approx(
        jff.cache_score("acts"), rel=TOL)


# ---------------------------------------------------------------------------
# initializers


def _draw(ini, shape, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return ini(gen, shape, torch.float32, "cpu").numpy()


@pytest.mark.parametrize("name", ["zeros", "ones"])
def test_exact_initializers_by_name_equal_jax(name):
    shape = (3, 5)
    got = _draw(tinit.resolve(name), shape)
    want = np.asarray(jinit.resolve(name)(jax.random.key(0), shape,
                                          jnp.float32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["zero", "constant", "array"])
def test_exact_initializer_objects_equal_jax(case):
    """ZeroInitializer, ConstantInitializer and ArrayInitializer give the
    reference's values exactly; an Array of the wrong shape raises, as
    the reference's does."""
    arr = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    t, j = {"zero": (tinit.ZeroInitializer(), jinit.ZeroInitializer()),
            "constant": (tinit.ConstantInitializer(0.25),
                         jinit.ConstantInitializer(0.25)),
            "array": (tinit.ArrayInitializer(arr),
                      jinit.ArrayInitializer(arr))}[case]
    assert tinit.resolve(t) is t
    np.testing.assert_array_equal(
        _draw(t, (4, 6)), np.asarray(j(jax.random.key(0), (4, 6),
                                       jnp.float32)))
    if case == "array":
        with pytest.raises(ValueError, match="shape"):
            _draw(t, (6, 4))


def _uniform_ok(a, lo, hi):
    """Inside [lo, hi], reaching near both ends, mean and variance those
    of U(lo, hi) within SIGMAS standard errors."""
    n = a.size
    w = hi - lo
    assert a.min() >= lo and a.max() <= hi
    assert a.min() < lo + 1e-3 * w and a.max() > hi - 1e-3 * w
    assert abs(a.mean() - (lo + hi) / 2) < SIGMAS * w / np.sqrt(12 * n)
    var = w * w / 12
    # the sample variance's standard error: sqrt((mu4 - var^2) / n)
    assert abs(a.var() - var) < SIGMAS * np.sqrt((w ** 4 / 80 - var ** 2)
                                                 / n)


@pytest.mark.parametrize("case", ["glorot", "uniform", "normal"])
def test_random_initializers_match_jax_in_distribution(case):
    """Glorot (by name and by object), Uniform and Normal: the port's draw
    and the reference's each hold the declared bounds or moments within
    SIGMAS standard errors; the port's draw is the same for the same
    seed and another for another."""
    shape = N_DRAW
    key = jax.random.key(3)
    if case == "glorot":
        lim = (6.0 / sum(shape)) ** 0.5
        for t, j in ((tinit.resolve("glorot_uniform"),
                      jinit.resolve("glorot_uniform")),
                     (tinit.GlorotUniformInitializer(seed=4),
                      jinit.GlorotUniformInitializer(seed=4))):
            _uniform_ok(_draw(t, shape), -lim, lim)
            _uniform_ok(np.asarray(j(key, shape, jnp.float32)), -lim, lim)
        t = tinit.GlorotUniformInitializer()
    elif case == "uniform":
        for t, j, (lo, hi) in (
                (tinit.resolve("uniform"), jinit.resolve("uniform"),
                 (-0.05, 0.05)),
                (tinit.UniformInitializer(-0.3, 0.7),
                 jinit.UniformInitializer(-0.3, 0.7), (-0.3, 0.7))):
            _uniform_ok(_draw(t, shape), lo, hi)
            _uniform_ok(np.asarray(j(key, shape, jnp.float32)), lo, hi)
    else:
        n = np.prod(shape)
        for t, j, (mu, sd) in (
                (tinit.resolve("normal"), jinit.resolve("normal"),
                 (0.0, 0.02)),
                (tinit.NormInitializer(0.5, 2.0),
                 jinit.NormInitializer(0.5, 2.0), (0.5, 2.0))):
            for a in (_draw(t, shape),
                      np.asarray(j(key, shape, jnp.float32))):
                assert abs(a.mean() - mu) < SIGMAS * sd / np.sqrt(n)
                # the sample std of a normal: standard error sd / sqrt(2n)
                assert abs(a.std() - sd) < SIGMAS * sd / np.sqrt(2 * n)
    np.testing.assert_array_equal(_draw(t, (8, 8), seed=5),
                                  _draw(t, (8, 8), seed=5))
    assert not np.array_equal(_draw(t, (8, 8), seed=5),
                              _draw(t, (8, 8), seed=6))


@pytest.mark.parametrize("shape", [(8, 16), (32, 3, 5, 5), (2, 64, 128),
                                   (4, 64, 8, 16), (5,)])
def test_fans_match_jax(shape):
    """2-D (in, out), conv OIHW, and stacked PIPELINE leaves (3-D (L, in,
    out), 4-D (L, E, H, D)), read conv-style as the reference reads them;
    a 1-D leaf is drawn as zeros by Glorot in both."""
    if len(shape) >= 2:
        assert tinit._fans(shape) == jinit._fans(shape)
    else:
        np.testing.assert_array_equal(
            _draw(tinit.GlorotUniformInitializer(), shape),
            np.asarray(jinit.GlorotUniformInitializer()(
                jax.random.key(0), shape, jnp.float32)))


def _build_with_overrides(ff, I, dt):
    """One graph touching every layer method that takes an initializer:
    create_weight, dense (kernel and bias), conv2d, embedding and
    multihead_attention (its four projections)."""
    w = ff.create_weight((6, 8), dt, initializer=I.ArrayInitializer(
        np.arange(48, dtype=np.float32).reshape(6, 8)), name="table")
    ids = ff.create_tensor((2, 6), getattr(type(dt), "INT32"), name="ids")
    e = ff.embedding(ids, 6, 8, dtype=dt,
                     kernel_initializer=I.ConstantInitializer(0.5),
                     name="emb")
    h = ff.add(e, w, name="add")
    a = ff.multihead_attention(h, h, h, 8, 2,
                               kernel_initializer=I.UniformInitializer(
                                   -0.1, 0.1), name="attn")
    d = ff.dense(a, 8, kernel_initializer=I.NormInitializer(0.0, 0.5),
                 bias_initializer=I.ConstantInitializer(0.125),
                 name="dense")
    img = ff.create_tensor((2, 3, 8, 8), dt, name="img")
    c = ff.conv2d(img, 4, 3, 3, kernel_initializer=I.ZeroInitializer(),
                  bias_initializer=I.ConstantInitializer(-1.0), name="conv")
    g = ff.dense(ff.flat(c, name="flat"), 48, name="plain")
    ff.add(d, ff.reshape(g, (2, 6, 8), name="rs"), name="out")


def test_layer_method_override_keys_match_jax():
    """Every layer method records its overrides under the reference's
    node keys and weight names (mha's one kernel_initializer on wq, wk,
    wv and wo); compile draws the overridden leaves from them (the exact
    ones equal the reference's) and the others from their defaults."""
    jff = JFFModel(JFFConfig(batch_size=2, num_devices=1))
    _build_with_overrides(jff, jinit, JDataType.FLOAT)
    tff = FFModel(FFConfig(batch_size=2, device="cpu"))
    _build_with_overrides(tff, tinit, DataType.FLOAT)

    def keys(ff):
        return {k: {n: type(v).__name__ for n, v in w.items()}
                for k, w in ff._init_overrides.items()}

    assert keys(tff) == keys(jff)
    assert keys(tff)[next(n.stable_key() for n in tff.graph.nodes
                          if n.name == "attn")] == {
        n: "UniformInitializer" for n in ("wq", "wk", "wv", "wo")}
    tr, _ = tff.compile()._params
    jtr, _ = jff.compile()._params
    k = {n.name: n.stable_key() for n in tff.graph.nodes}
    for name, w in (("table", "weight"), ("emb", "kernel"),
                    ("dense", "bias"), ("conv", "kernel"),
                    ("conv", "bias")):
        np.testing.assert_array_equal(tr[k[name]][w].numpy(),
                                      np.asarray(jtr[k[name]][w]))
    for w in ("wq", "wk", "wv", "wo"):
        a = tr[k["attn"]][w].numpy()
        assert a.min() >= -0.1 and a.max() <= 0.1
    assert tr[k["dense"]]["kernel"].std() > 0.3  # N(0, 0.5), not glorot
    lim = (6.0 / (144 + 48)) ** 0.5
    assert tr[k["plain"]]["kernel"].abs().max() <= lim  # default glorot
    np.testing.assert_array_equal(
        tff.get_weight("table", "weight"),
        np.arange(48, dtype=np.float32).reshape(6, 8))
    # the same per-leaf generator: the executor's draw with the recorded
    # overrides is compile()'s
    again, _ = tff.executor.init_params(tff.config.seed, tff._init_overrides)
    for nk, ws in tr.items():
        for wn, leaf in ws.items():
            assert torch.equal(again[nk][wn], leaf), (nk, wn)


# ---------------------------------------------------------------------------
# int8 weight storage


def _quant_arrays():
    rs = np.random.RandomState(7)
    step = np.float32(3.0) / np.float32(QMAX)
    halfway = (np.arange(-20, 21, dtype=np.float32) + 0.5) * step
    return [rs.randn(64, 33).astype(np.float32),
            (1e-3 * rs.randn(5, 7, 9)).astype(np.float32),
            (300 * rs.rand(17)).astype(np.float32),
            np.zeros((4, 4), np.float32),
            np.concatenate([halfway, [np.float32(3.0)]]),
            np.array([-2.5, 0.0, 1e-30, 2.5], np.float32)]


@pytest.mark.parametrize("i", range(6))
def test_quantize_leaf_is_bit_exact_against_jax(i):
    a = _quant_arrays()[i]
    got = quantize_leaf(torch.from_numpy(a))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jquantize_leaf(jnp.asarray(a)), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert len(np.unique(want)) <= 255


def _lm():
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

    ff = FFModel(FFConfig(batch_size=1, device="cpu"))
    build_llama(ff, LlamaConfig.tiny(), batch_size=1, seq_len=8,
                dtype=DataType.FLOAT)
    return ff.compile()


@pytest.mark.parametrize("name,want", [
    ("fp32", torch.float32), ("float32", torch.float32),
    ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
    ("fp16", torch.float16), ("float16", torch.float16),
    ("fp8", torch.float8_e4m3fn), ("float8_e4m3fn", torch.float8_e4m3fn),
    ("int8", torch.bfloat16)])
def test_init_params_weight_dtype_casts_every_leaf(name, want):
    """Every leaf is drawn as without weight_dtype, then cast: a float
    name is a plain cast of the fp32 draw; "int8" is quantize_leaf of it,
    bit for bit the JAX function's, at most 255 values a leaf."""
    ex = _lm().executor
    ref, rntr = ex.init_params(0, weight_dtype="fp32")
    tr, ntr = ex.init_params(0, weight_dtype=name)
    for tree, rtree in ((tr, ref), (ntr, rntr)):
        for nk, ws in tree.items():
            for wn, leaf in ws.items():
                assert leaf.dtype == want, (nk, wn, leaf.dtype)
                full = rtree[nk][wn]
                if name == "int8":
                    jq = np.asarray(jquantize_leaf(jnp.asarray(full.numpy())),
                                    np.float32)
                    np.testing.assert_array_equal(leaf.float().numpy(), jq)
                    assert len(np.unique(jq)) <= 255
                else:
                    assert torch.equal(leaf, full.to(want))


def test_init_params_refuses_an_unknown_weight_dtype():
    ex = _lm().executor
    with pytest.raises(ValueError, match="weight_dtype"):
        ex.init_params(0, weight_dtype="int4")
