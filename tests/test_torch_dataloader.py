"""The port's data loaders and recompilation against the JAX package's:
the same batches in the same order for a seed (in-memory and native file
loaders, shuffled or not), fit(dataloaders=...) training to the JAX
fit's weights, and RecompileState firing and rebuilding as the
reference's does.

Tolerance: batches are compared exactly; weights after the same steps
from the same start within fp32's 1e-4 (summation order only)."""

import dataclasses

import numpy as np
import pytest
import torch

from flexflow_tpu import native as jnative
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.runtime import dataloader as jdl
from flexflow_tpu.runtime.recompile import RecompileState as JRecompile
from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.runtime import dataloader as dl
from flexflow_tpu_torch.runtime.recompile import RecompileState
from flexflow_tpu_torch.runtime.weights import params_to_numpy

from torch_parity import model_pair

TOL = 1e-4
BATCH = 16


class _Cfg:
    """The loaders read only config.batch_size from their model."""

    class config:
        batch_size = BATCH


def data(n=128, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(4, 10) * 3
    y = rs.randint(0, 4, n)
    return ((centers[y] + rs.randn(n, 10)).astype(np.float32),
            y.astype(np.int32))


def epochs_of(loader, n=3):
    out = []
    for _ in range(n):
        loader.reset()
        out.append([loader.next_batch() for _ in range(loader.num_batches)])
        with pytest.raises(StopIteration):
            loader.next_batch()
    return out


def assert_same_epochs(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for bg, bw in zip(eg, ew):
            assert bg.dtype == bw.dtype
            np.testing.assert_array_equal(bg, bw)


@pytest.mark.parametrize("shuffle", [False, True])
def test_single_loader_matches_reference(shuffle):
    x, _ = data()
    got = epochs_of(dl.SingleDataLoader(_Cfg, None, x, shuffle=shuffle,
                                        seed=5))
    want = epochs_of(jdl.SingleDataLoader(_Cfg, None, x, shuffle=shuffle,
                                          seed=5))
    assert_same_epochs(got, want)
    if shuffle:
        assert not np.array_equal(got[0][0], got[1][0])


@pytest.mark.parametrize("shuffle", [False, True])
def test_file_loader_matches_reference(tmp_path, shuffle):
    """The native worker built from the port's csrc/ffloader.cc gives the
    JAX package's batches, in its order, epoch after epoch (its own
    generator's shuffles), for a 2-D float and a 1-D int file."""
    if not jnative.loader_available():
        pytest.skip("the JAX package's native loader did not build")
    x, y = data()
    for name, arr in (("x.npy", x), ("y.npy", y)):
        path = str(tmp_path / name)
        np.save(path, arr)
        got = epochs_of(dl.FileDataLoader(_Cfg, None, path, shuffle=shuffle,
                                          seed=3))
        want = epochs_of(jdl.FileDataLoader(_Cfg, None, path,
                                            shuffle=shuffle, seed=3))
        assert_same_epochs(got, want)
        if not shuffle:
            np.testing.assert_array_equal(np.concatenate(got[0]), arr)


def test_file_loader_resizes_and_closes(tmp_path):
    x, _ = data()
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    ld = dl.FileDataLoader(_Cfg, None, path)
    assert (ld.num_samples, ld.num_batches) == (128, 8)
    ld.reset()
    ld.next_batch()
    ld.batch_size = 32  # the worker is reconfigured at the next batch
    np.testing.assert_array_equal(ld.next_batch(), x[:32])
    ld.close()
    ld.close()


def test_prefetch_loader_on_the_cpu_yields_the_batches():
    x, y = data(64)
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    t = ff.create_tensor((BATCH, 10), DataType.FLOAT, name="input")
    ff.softmax(ff.dense(t, 4, name="d"))
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    loaders = [ff.create_data_loader(t, x), ff.create_data_loader(None, y)]
    pf = dl.PrefetchLoader(ff, loaders)
    assert len(pf) == 4
    got = list(pf)
    assert len(got) == 4
    for i, (bx, by) in enumerate(got):
        assert isinstance(bx, torch.Tensor) and bx.device.type == "cpu"
        np.testing.assert_array_equal(bx.numpy(), x[i * 16:(i + 1) * 16])
        np.testing.assert_array_equal(by.numpy(), y[i * 16:(i + 1) * 16])


def _dense_pair(monkeypatch, lr=0.1):
    def build(ff, act):
        x = ff.create_tensor((BATCH, 10), name="input")
        t = ff.dense(x, 32, act.RELU, name="d0")
        ff.softmax(ff.dense(t, 4, name="d1"), name="softmax")

    return model_pair(monkeypatch, lambda f: build(f, JActiMode),
                      lambda f: build(f, ActiMode), BATCH,
                      LossType.SPARSE_CATEGORICAL_CROSSENTROPY, lr=lr)


def assert_same_weights(jff, tff):
    got, _ = params_to_numpy(*tff._params)
    for k, w in jff._params[0].items():
        for n, a in w.items():
            np.testing.assert_allclose(got[k][n], np.asarray(a), atol=TOL,
                                       rtol=TOL, err_msg=f"{k}/{n}")


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_fit_dataloaders_matches_jax(monkeypatch, tmp_path, kind):
    """fit(dataloaders=...) over shuffled loaders (two epochs, an explicit
    batch_size overriding the loaders') ends at the JAX fit's weights and
    sample count."""
    if kind == "file" and not jnative.loader_available():
        pytest.skip("the JAX package's native loader did not build")
    jff, tff = _dense_pair(monkeypatch)
    x, y = data()
    if kind == "file":
        np.save(tmp_path / "x.npy", x)
        np.save(tmp_path / "y.npy", y)
        x, y = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")

    def loaders(ff):
        return [ff.create_data_loader(None, x, batch_size=8, shuffle=True,
                                      seed=11),
                ff.create_data_loader(None, y, batch_size=8, shuffle=True,
                                      seed=11)]

    jm = jff.fit(dataloaders=loaders(jff), epochs=2, batch_size=BATCH,
                 verbose=False)
    tm = tff.fit(dataloaders=loaders(tff), epochs=2, batch_size=BATCH,
                 verbose=False)
    assert tm.train_all == jm.train_all == 128
    assert tff._step_count == jff._step_count == 16
    np.testing.assert_allclose(tm.sparse_cce_loss, jm.sparse_cce_loss,
                               rtol=TOL)
    assert_same_weights(jff, tff)


def test_recompile_on_condition(monkeypatch):
    """The JAX package's test_recompile_on_condition on the port, beside
    the JAX run: the trigger fires once, the alter turns d0's activation
    to GELU, the model is rebuilt (a new executor) and the next steps run
    the altered graph: the same weights as the JAX run within 1e-4."""
    jff, tff = _dense_pair(monkeypatch)
    x, y = data(64)

    def states(ff, cls, act):
        def trigger(st):
            return st.recompilations == 0 and ff._step_count >= 2

        def alter(st):
            for n in ff.graph.nodes:
                if n.name == "d0":
                    n.attrs = dataclasses.replace(n.attrs,
                                                  activation=act.GELU)

        return cls(trigger, alter, ff)

    jst = states(jff, JRecompile, JActiMode)
    st = states(tff, RecompileState, ActiMode)
    before = tff.executor
    jff.fit(x, y, epochs=2, verbose=False, recompile_state=jst)
    tff.fit(x, y, epochs=2, verbose=False, recompile_state=st)
    assert st.recompilations == jst.recompilations == 1
    assert tff.executor is not before
    d0 = next(n for n in tff.graph.nodes if n.name == "d0")
    assert d0.attrs.activation == ActiMode.GELU
    assert set(st.last_metrics) >= {"loss"}
    assert_same_weights(jff, tff)


def test_cache_score_and_recompile_swap(monkeypatch):
    """The JAX package's test_cache_score_and_recompile_swap on the port:
    a CACHE op's score stays high on the same distribution and drops on a
    shifted one, and the degraded score drives a recompile in fit."""
    from flexflow_tpu_torch import SGDOptimizer

    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    x = ff.create_tensor((BATCH, 8), name="x")
    c = ff.cache(x, score_func=lambda old, new: float(
        1.0 - np.abs(old - new).mean()), name="acts")
    ff.softmax(ff.dense(c, 4, name="d0"), name="sm")
    ff.compile(optimizer=SGDOptimizer(lr=0.01),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    rs = np.random.RandomState(0)
    xs = rs.randn(32, 8).astype(np.float32)
    ys = rs.randint(0, 4, 32).astype(np.int32)
    ff.fit(xs, ys, epochs=1, verbose=False)
    assert ff.cache_score("acts") == 1.0  # the first call only snapshots
    ff.fit(xs, ys, epochs=1, verbose=False)
    assert ff.cache_score("acts") > 0.5
    ff.fit(xs * 100.0, ys, epochs=1, verbose=False)
    assert ff.cache_score("acts") < 0.5
    fired = []
    st = RecompileState(
        lambda s: not fired and ff.cache_score("acts") < 10.0,
        lambda s: fired.append(True), ff)
    ff.fit(xs, ys, epochs=1, verbose=False, recompile_state=st)
    assert st.recompilations == 1 and fired
