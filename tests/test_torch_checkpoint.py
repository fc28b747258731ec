"""The port's checkpoints against the JAX package's: one npz format, read
and written by both (bf16 leaves included), periodic saves from fit,
builder-free restore, exact resume, and the refusals.

Tolerances: the same weights in both packages give predictions within
fp32's 1e-4 (summation order only); a restore within one package, and a
resume against the uninterrupted run, are bit-exact."""

import json
import os

import numpy as np
import pytest
import torch

from flexflow_tpu import AdamOptimizer as JAdam
from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import LossType as JLossType
from flexflow_tpu import MetricsType as JMetricsType
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.pcg import serialize as jser
from flexflow_tpu.runtime import checkpoint as jckpt
from flexflow_tpu_torch import (
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
    MetricsType,
    SGDOptimizer,
)
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.pcg.serialize import graph_from_json, graph_to_json
from flexflow_tpu_torch.runtime import checkpoint as ckpt

TOL = 1e-4
BATCH = 16


def data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(4, 10) * 3
    y = rs.randint(0, 4, n)
    return ((centers[y] + rs.randn(n, 10)).astype(np.float32),
            y.astype(np.int32))


def port_model(seed=0, state_dtype="float32", width=32, **cfg):
    ff = FFModel(FFConfig(batch_size=BATCH, seed=seed, device="cpu", **cfg))
    x = ff.create_tensor((BATCH, 10), DataType.FLOAT, name="input")
    t = ff.dense(x, width, ActiMode.RELU, name="d0")
    ff.softmax(ff.dense(t, 4, name="d1"), name="softmax")
    ff.compile(optimizer=AdamOptimizer(lr=0.01, state_dtype=state_dtype),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY])
    return ff


def jax_model(seed=0, state_dtype="float32"):
    ff = JFFModel(JFFConfig(batch_size=BATCH, seed=seed, num_devices=1))
    x = ff.create_tensor((BATCH, 10), JDataType.FLOAT, name="input")
    t = ff.dense(x, 32, JActiMode.RELU, name="d0")
    ff.softmax(ff.dense(t, 4, name="d1"), name="softmax")
    ff.compile(optimizer=JAdam(lr=0.01, state_dtype=state_dtype),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[JMetricsType.ACCURACY])
    return ff


def leaves(ff):
    """Every leaf of the port's state as fp32 numpy (the step as an
    int)."""
    tr, ntr = ff._params
    flat = ckpt._flatten({"trainable": tr, "nontrainable": ntr,
                          "opt_state": ff._opt_state or {}})
    return {k: (v if isinstance(v, int) else v.detach().float().numpy())
            for k, v in flat.items()}


def unsharded(payload: str) -> dict:
    d = json.loads(payload)
    for n in d["nodes"]:
        n["sharding"] = None
    return d


def assert_same_state(a, b):
    la, lb = leaves(a), leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=repr(k))
    assert a._step_count == b._step_count


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_port(tmp_path, state_dtype):
    """A checkpoint the JAX package wrote (bf16 Adam moments as its raw
    |V2 records included) restores into the port: equal weights, moments
    bit for bit, step count, predictions within 1e-4, and one more epoch
    on each side still within 1e-4."""
    x, y = data()
    jff = jax_model(state_dtype=state_dtype)
    jff.fit(x, y, epochs=2, verbose=False)
    path = str(tmp_path / "ck")
    jckpt.save_checkpoint(path, jff)
    if state_dtype == "bfloat16":
        with np.load(os.path.join(path, "arrays.npz")) as z:
            assert z["opt_state\x1fm\x1fd0_1001\x1fkernel"].dtype == "V2"
    ff = port_model(seed=7, state_dtype=state_dtype)
    meta = ckpt.restore_checkpoint(path, ff)
    assert meta["step_count"] == ff._step_count == 8
    assert ff._opt_state["step"] == 8
    for k, w in jff._params[0].items():
        for n, a in w.items():
            np.testing.assert_array_equal(ff.get_weight(k.rsplit("_", 1)[0],
                                                        n), np.asarray(a))
    jm = np.asarray(jff._opt_state["m"]["d0_1001"]["kernel"]
                    .astype("float32"))
    assert ff._opt_state["m"]["d0_1001"]["kernel"].dtype == getattr(
        torch, state_dtype)
    np.testing.assert_array_equal(
        ff._opt_state["m"]["d0_1001"]["kernel"].float().numpy(), jm)
    np.testing.assert_allclose(ff.predict(x), jff.predict(x), atol=TOL,
                               rtol=TOL)
    jff.fit(x, y, epochs=1, verbose=False)
    ff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(ff.predict(x), jff.predict(x), atol=TOL,
                               rtol=TOL)


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A checkpoint the port wrote restores into the JAX package, by
    restore_checkpoint into its own build and by its builder-free
    restore_model from the port's pcg.json: predictions within 1e-4."""
    x, y = data()
    ff = port_model()
    ff.fit(x, y, epochs=2, verbose=False)
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, ff, extra={"note": "port"})
    jff = jax_model(seed=9)
    meta = jckpt.restore_checkpoint(path, jff)
    assert meta["extra"] == {"note": "port"} and jff._step_count == 8
    np.testing.assert_allclose(np.asarray(jff.predict(x)), ff.predict(x),
                               atol=TOL, rtol=TOL)
    jff2 = jckpt.restore_model(path)
    # the JAX compile gives its input node the default data-parallel
    # sharding of its 8 CPU devices
    assert unsharded(jser.graph_to_json(jff2.graph)) == unsharded(
        graph_to_json(ff.graph))
    np.testing.assert_allclose(np.asarray(jff2.predict(x)), ff.predict(x),
                               atol=TOL, rtol=TOL)


def test_restore_model_from_jax_checkpoint_alone(tmp_path):
    """restore_model rebuilds the JAX package's model from its checkpoint
    alone (no builder code): the same graph, predictions within 1e-4,
    and one more epoch of training matching the JAX model's."""
    x, y = data()
    jff = jax_model()
    jff.fit(x, y, epochs=2, verbose=False)
    path = str(tmp_path / "ck")
    jckpt.save_checkpoint(path, jff)
    ff = ckpt.restore_model(path, device="cpu")
    assert json.loads(graph_to_json(ff.graph)) == json.loads(
        jser.graph_to_json(jff.graph))
    assert ff.restored_meta["step_count"] == ff._step_count == 8
    assert ff._optimizer == AdamOptimizer(lr=0.01)
    assert ff._metrics == [MetricsType.ACCURACY]
    np.testing.assert_allclose(ff.predict(x), np.asarray(jff.predict(x)),
                               atol=TOL, rtol=TOL)
    jff.fit(x, y, epochs=1, verbose=False)
    ff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(ff.predict(x), np.asarray(jff.predict(x)),
                               atol=TOL, rtol=TOL)
    cfg = FFConfig(batch_size=BATCH, device="cpu", seed=5)
    assert ckpt.restore_model(path, config=cfg).config is cfg


def test_periodic_save_and_restore_latest(tmp_path):
    """fit with checkpoint_every writes step_N directories and an atomic
    latest.json; restore_latest into a built model and
    restore_latest_model without one both give the writer's state bit
    for bit (the JAX package's test_periodic_checkpoint_and_restore_latest
    on the port)."""
    x, y = data()
    ff1 = port_model(checkpoint_dir=str(tmp_path), checkpoint_every=4)
    ff1.fit(x, y, epochs=2, verbose=False)  # 8 steps: saves at 4 and 8
    assert sorted(os.listdir(tmp_path)) == ["latest.json", "step_4",
                                            "step_8"]
    with open(tmp_path / "latest.json") as f:
        assert json.load(f) == {"name": "step_8", "step": 8}
    ff2 = port_model(seed=7)
    ckpt.restore_latest(str(tmp_path), ff2)
    assert_same_state(ff1, ff2)
    ff3 = ckpt.restore_latest_model(str(tmp_path), device="cpu")
    assert_same_state(ff1, ff3)
    np.testing.assert_array_equal(ff3.predict(x), ff1.predict(x))


def test_resume_equals_uninterrupted_run(tmp_path):
    """Sixteen steps from file loaders with a checkpoint every eight;
    restore_model(step_8) trained on steps 9-16 ends bit for bit where
    the uninterrupted run did (weights, moments, step)."""
    x, y = data(256)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    np.save(tmp_path / "x2.npy", x[128:])
    np.save(tmp_path / "y2.npy", y[128:])
    ckdir = tmp_path / "ck"
    ff1 = port_model(checkpoint_dir=str(ckdir), checkpoint_every=8)
    ff1.fit(dataloaders=[ff1.create_data_loader(None, str(tmp_path / n))
                         for n in ("x.npy", "y.npy")], verbose=False)
    assert ff1._step_count == 16
    ff2 = ckpt.restore_model(str(ckdir / "step_8"), device="cpu")
    assert ff2._step_count == 8
    ff2.fit(dataloaders=[ff2.create_data_loader(None, str(tmp_path / n))
                         for n in ("x2.npy", "y2.npy")], verbose=False)
    assert_same_state(ff1, ff2)


def test_bf16_moments_round_trip(tmp_path):
    """bf16 Adam moments are written as raw 2-byte records, as the JAX
    package writes them, and come back through an int16 view bit for
    bit (no float cast)."""
    x, y = data()
    ff1 = port_model(state_dtype="bfloat16")
    ff1.fit(x, y, epochs=1, verbose=False)
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, ff1)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        m = z["opt_state\x1fm\x1fd0_1001\x1fkernel"]
        assert m.dtype == np.dtype("V2") and m.shape == (10, 32)
        assert z["opt_state\x1fstep"].dtype == np.int32
        assert z["opt_state\x1fstep"].shape == ()
    ff2 = port_model(seed=3, state_dtype="bfloat16")
    ckpt.restore_checkpoint(path, ff2)
    want = ff1._opt_state["v"]["d1_1002"]["kernel"]
    got = ff2._opt_state["v"]["d1_1002"]["kernel"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert_same_state(ff1, ff2)


def test_restore_refusals(tmp_path):
    """A leaf of another shape raises ValueError, a missing leaf
    KeyError, a missing meta.json FileNotFoundError; the orbax backend
    and a checkpoint with an orbax state/ directory raise and name queue
    1 item 12."""
    ff = port_model()
    path = str(tmp_path / "ck")
    ckpt.save_checkpoint(path, ff)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(path, port_model(width=64))
    wider = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    x = wider.create_tensor((BATCH, 10), DataType.FLOAT, name="input")
    t = wider.dense(x, 32, ActiMode.RELU, name="d0")
    t = wider.dense(t, 32, name="extra")
    wider.softmax(wider.dense(t, 4, name="d1"), name="softmax")
    wider.compile(optimizer=SGDOptimizer(),
                  loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    with pytest.raises(KeyError, match="missing parameter"):
        ckpt.restore_checkpoint(path, wider)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "nothing"), ff)
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        ckpt.save_checkpoint(str(tmp_path / "o"), ff, backend="orbax")
    os.makedirs(os.path.join(path, "state"))
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        ckpt.restore_checkpoint(path, ff)


def test_pcg_json_is_the_reference_format():
    """The same builder calls give the same pcg.json in both packages (a
    tiny Llama: attention, RMSNorm, SwiGLU, enums, shapes); each package
    reads the other's, keeping guids, edges and the structure hash; a
    node's sharding (a search's ShardingView) crosses in both directions."""
    from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig
    from flexflow_tpu.models.llama import build_llama as jbuild_llama
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

    jff = JFFModel(JFFConfig(batch_size=2, num_devices=1))
    jbuild_llama(jff, JLlamaConfig.tiny(), batch_size=2, seq_len=8)
    jff.graph.infer_shapes()
    ff = FFModel(FFConfig(batch_size=2, device="cpu"))
    build_llama(ff, LlamaConfig.tiny(), batch_size=2, seq_len=8)
    ff.graph.infer_shapes()
    payload = graph_to_json(ff.graph)
    assert json.loads(payload) == json.loads(jser.graph_to_json(jff.graph))
    back = graph_from_json(jser.graph_to_json(jff.graph))
    assert back.structure_hash() == ff.graph.structure_hash()
    assert [n.guid for n in back.topo_order()] == [
        n.guid for n in ff.graph.topo_order()]
    assert jser.graph_from_json(payload).structure_hash() == \
        jff.graph.structure_hash()
    d = json.loads(payload)
    d["nodes"][0]["sharding"] = {"outputs": [[["data"], []]],
                                 "weights": {}}
    sharded = graph_from_json(json.dumps(d))
    jsharded = jser.graph_from_json(json.dumps(d))
    assert sharded.structure_hash() != ff.graph.structure_hash()
    assert json.loads(graph_to_json(sharded)) == json.loads(
        jser.graph_to_json(jsharded)) == d
