"""The port's frontends against the JAX package's and against the models
they import: HuggingFace Llama and GPT-2 (frontends/hf.py), torch.fx
modules with the LSTM, RMSNorm, getitem and flatten rules and the text IR
(frontends/torch_fx.py), the Keras-style API with its callbacks
(frontends/keras/), and keras JSON (frontends/keras_exp.py).

Tolerances: fp32 outputs within 1e-4 (summation order only) of torch's
and of the JAX package's; the bf16 HF import (the builders' default for
Llama) within analysis/num_budgets.py's hf-import-parity-atol / -rtol of
the JAX import, as the JAX package's test_hf_import holds its own."""

import json
import warnings

import numpy as np
import pytest
import torch
import torch.nn as nn

from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import LossType as JLossType
from flexflow_tpu.frontends import hf as jhf
from flexflow_tpu.frontends import keras as jkeras
from flexflow_tpu.frontends import torch_fx as jfx
from flexflow_tpu.frontends.keras_exp import KerasExpModel as JKerasExp
from flexflow_tpu_torch import (
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
    OpType,
)
from flexflow_tpu_torch.analysis.num_budgets import tolerance
from flexflow_tpu_torch.frontends import hf, keras, torch_fx
from flexflow_tpu_torch.frontends.hf_standin import gpt2_standin
from flexflow_tpu_torch.frontends.keras_exp import KerasExpModel

TOL = 1e-4
BATCH, SEQ = 4, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runner's workers share the cores, and
    torch's thread pool oversubscribes them (small models' many small ops
    run many times slower with six workers of eight threads each)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# HuggingFace


def _tiny_hf_llama(seed=0):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attention_dropout=0.0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _port_import(hf_model, dtype=None):
    ff = FFModel(FFConfig(batch_size=BATCH, device="cpu"))
    hf.import_hf_causal_lm(hf_model, ff, batch_size=BATCH, seq_len=SEQ,
                           dtype=dtype)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the documented untied-head warn
        n = hf.copy_hf_weights(hf_model, ff)
    return ff, n


def _jax_import(hf_model):
    from flexflow_tpu import AdamOptimizer as JAdam

    ff = JFFModel(JFFConfig(batch_size=BATCH, num_devices=1))
    jhf.import_hf_causal_lm(hf_model, ff, batch_size=BATCH, seq_len=SEQ)
    ff.compile(optimizer=JAdam(lr=1e-3),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jhf.copy_hf_weights(hf_model, ff)
    return ff


def _ids(vocab=128, n=BATCH, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (n, SEQ)).astype(
        np.int32)


def _hf_probs(hf_model, ids):
    with torch.no_grad():
        return torch.softmax(hf_model(input_ids=torch.tensor(
            ids, dtype=torch.long)).logits, -1).numpy()


def test_hf_llama_matches_transformers_and_the_jax_import():
    """A transformers LlamaForCausalLM: the fp32 import's next-token
    distribution within 1e-4 of transformers'; the default (bf16) import
    within the hf-import budgets of the JAX package's import, argmax
    agreeing on 90% of positions; 3 + 9 per layer weights copied."""
    model = _tiny_hf_llama()
    ids = _ids()
    ff32, n = _port_import(model, DataType.FLOAT)
    assert n == 3 + 2 * 9
    assert_close(ff32.predict(ids), _hf_probs(model, ids))
    ff, _ = _port_import(model)
    got, want = ff.predict(ids), np.asarray(_jax_import(model).predict(ids),
                                            np.float32)
    np.testing.assert_allclose(got, want,
                               atol=tolerance("hf-import-parity-atol"),
                               rtol=tolerance("hf-import-parity-rtol"))
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.9


def test_hf_gpt2_matches_transformers_and_the_jax_import():
    """A transformers GPT2LMHeadModel (pre-LN, learned positions, fused
    c_attn split, tanh GELU, tied head): within 1e-4 of transformers' and
    of the JAX import's distribution; 5 + 16 per block weights copied;
    the first greedy token equals transformers'."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    ff, n = _port_import(model)
    assert n == 5 + 2 * 16
    ids = _ids()
    got = ff.predict(ids)
    assert_close(got, _hf_probs(model, ids))
    assert_close(got, _jax_import(model).predict(ids))
    out = ff.generate(ids[:, :8], max_new_tokens=4)
    with torch.no_grad():
        nxt = model(input_ids=torch.tensor(ids[:, :8], dtype=torch.long)
                    ).logits[:, -1].argmax(-1).numpy()
    np.testing.assert_array_equal(out[:, 0], nxt)


def test_hf_standin_imports_like_the_model_it_stands_for():
    """The stand-in GPT-2 (HF attribute names, no transformers) imports
    through the same path: the JAX package's importer gives the same
    distribution from it (1e-4)."""
    model = gpt2_standin(vocab_size=96, n_positions=SEQ, n_embd=32,
                         n_layer=2, n_head=2, seed=3)
    ff, n = _port_import(model)
    assert n == 5 + 2 * 16
    ids = _ids(96)
    assert_close(ff.predict(ids), _jax_import(model).predict(ids))


def test_hf_guards():
    """The reference's refusals: exact-erf GELU, layer-scaled attention,
    a sequence past the position table, a non-silu Llama; and the
    untied-head warning of a tied checkpoint."""
    def gpt2(**kw):
        return gpt2_standin(vocab_size=32, n_positions=16, n_embd=16,
                            n_layer=1, n_head=2, **kw)

    ff = FFModel(FFConfig(batch_size=2, device="cpu"))
    with pytest.raises(ValueError, match="activation"):
        hf.import_hf_causal_lm(gpt2(activation_function="gelu"), ff,
                               seq_len=8)
    m = gpt2()
    m.config.scale_attn_by_inverse_layer_idx = True
    with pytest.raises(ValueError, match="scale_attn_by_inverse_layer_idx"):
        hf.import_hf_causal_lm(m, ff, seq_len=8)
    with pytest.raises(ValueError, match="n_positions=16"):
        hf.import_hf_causal_lm(gpt2(), ff, seq_len=32)
    llama_cfg = type("C", (), dict(
        vocab_size=32, hidden_size=16, num_attention_heads=2,
        intermediate_size=32, num_hidden_layers=1, hidden_act="gelu"))
    with pytest.raises(ValueError, match="hidden_act"):
        hf.hf_to_llama_config(llama_cfg)
    ff = FFModel(FFConfig(batch_size=2, device="cpu"))
    m = gpt2()
    hf.import_hf_causal_lm(m, ff, batch_size=2, seq_len=8)
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    with pytest.warns(UserWarning, match="tie_word_embeddings"):
        hf.copy_hf_weights(m, ff)


# ---------------------------------------------------------------------------
# torch.fx


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.relu = nn.ReLU()
        self.pool = nn.MaxPool2d(2)
        self.flatten = nn.Flatten()
        self.fc1 = nn.Linear(8 * 8 * 8, 32)
        self.fc2 = nn.Linear(32, 10)

    def forward(self, x):
        x = self.pool(self.relu(self.conv1(x)))
        x = self.flatten(x)
        x = torch.relu(self.fc1(x))
        return self.fc2(x)


class BiLSTMClassifier(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(12, 16, num_layers=2, batch_first=True,
                            bidirectional=True)
        self.head = nn.Linear(32, 5)

    def forward(self, x):
        y, _ = self.lstm(x)
        return self.head(y[:, -1])


class ResidualMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 16)
        self.ln = nn.LayerNorm(16)
        self.fc2 = nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(self.ln(x + torch.relu(self.fc1(x))))


class SharedBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.shared = nn.Linear(12, 12)

    def forward(self, x):
        return self.shared(torch.relu(self.shared(x)))


class RMSNormed(nn.Module):
    """A module whose RMSNorm must stay one RMS_NORM op."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 32, bias=False)
        self.norm = nn.RMSNorm(32, eps=1e-6)
        self.head = nn.Linear(32, 4, bias=False)
        with torch.no_grad():
            self.norm.weight.mul_(1.7)

    def forward(self, x):
        return self.head(self.norm(self.fc(x)))


_FX_CASES = {
    "cnn": (SmallCNN, (4, 3, 16, 16), 0),
    "bilstm": (BiLSTMClassifier, (4, 9, 12), 2),
    "residual_layernorm": (ResidualMLP, (8, 16), 1),
    "shared_module": (SharedBlock, (4, 12), 2),
    "rmsnorm": (RMSNormed, (8, 16), 4),
}


def _fx_pair(name):
    cls, shape, seed = _FX_CASES[name]
    torch.manual_seed(seed)
    module = cls().eval()
    ff = FFModel(FFConfig(batch_size=shape[0], device="cpu"))
    pm = torch_fx.PyTorchModel(module)
    (out,) = pm.torch_to_ff(ff, [ff.create_tensor(shape, DataType.FLOAT)])
    ff.softmax(out)
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    pm.copy_weights(ff)
    jff = JFFModel(JFFConfig(batch_size=shape[0], num_devices=1))
    jpm = jfx.PyTorchModel(module)
    (jout,) = jpm.torch_to_ff(jff, [jff.create_tensor(shape)])
    jff.softmax(jout)
    jff.compile(loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    jpm.copy_weights(jff)
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return module, ff, jff, x


@pytest.mark.parametrize("name", sorted(_FX_CASES))
def test_torch_fx_import_matches_torch_and_jax(name):
    """Each module traced, replayed and its weights copied: predictions
    within 1e-4 of the torch module's softmax and of the JAX package's
    import of the same module (the LSTM expanded per layer and
    direction, `y[:, -1]` a split, nn.RMSNorm one RMS_NORM op, a module
    called twice filling both layers)."""
    module, ff, jff, x = _fx_pair(name)
    with torch.no_grad():
        want = torch.softmax(module(torch.from_numpy(x)), -1).numpy()
    got = ff.predict(x)
    assert_close(got, want)
    assert_close(got, jff.predict(x))
    if name == "rmsnorm":
        assert [n.op_type for n in ff.graph.nodes].count(
            OpType.RMS_NORM) == 1


class FlattenDims(nn.Module):
    def forward(self, x):
        return x.flatten(2)


class PaddedAvgPool(nn.Module):
    def __init__(self):
        super().__init__()
        self.pool = nn.AvgPool2d(3, stride=1, padding=1)

    def forward(self, x):
        return self.pool(x)


def test_torch_fx_flatten_and_pool_shapes():
    for module, shape, want in ((FlattenDims(), (2, 3, 4, 5), (2, 3, 20)),
                                (PaddedAvgPool(), (2, 3, 8, 8),
                                 (2, 3, 8, 8))):
        ff = FFModel(FFConfig(batch_size=2, device="cpu"))
        (out,) = torch_fx.PyTorchModel(module).torch_to_ff(
            ff, [ff.create_tensor(shape)])
        assert out.shape == want


def _summary(graph):
    return [(n.name, n.op_type.name, repr(n.attrs).replace(
        "flexflow_tpu_torch", "flexflow_tpu")) for n in graph.topo_order()]


@pytest.mark.parametrize("name", ["cnn", "bilstm", "rmsnorm"])
def test_text_ir_round_trip_between_packages(tmp_path, name):
    """The text IR the JAX package writes rebuilds in the port (and the
    port's in the JAX package) the same graph the other side rebuilds:
    node names, op types and attrs, and the output shape."""
    cls, shape, _ = _FX_CASES[name]
    module = cls()
    jpath, path = str(tmp_path / "j.ff"), str(tmp_path / "p.ff")
    jfx.PyTorchModel(module).torch_to_file(jpath)
    torch_fx.PyTorchModel(module).torch_to_file(path)
    assert open(jpath).read() == open(path).read()
    ff = FFModel(FFConfig(batch_size=shape[0], device="cpu"))
    (out,) = torch_fx.file_to_ff(jpath, ff, [ff.create_tensor(shape)])
    jff = JFFModel(JFFConfig(batch_size=shape[0], num_devices=1))
    (jout,) = jfx.file_to_ff(path, jff, [jff.create_tensor(shape)])
    assert out.shape == tuple(jout.shape)
    ff.graph.infer_shapes()
    jff.graph.infer_shapes()
    assert _summary(ff.graph) == _summary(jff.graph)


# ---------------------------------------------------------------------------
# keras


def _carry_weights(jm, km):
    """The JAX keras model's drawn weights into the port's (the same
    builder calls give the same leaf keys)."""
    tr, _ = km.ffmodel._params
    for k, w in jm.ffmodel._params[0].items():
        for n, a in w.items():
            tr[k][n].copy_(torch.from_numpy(np.array(a)))


def _sequential(mod, cfg, opt="sgd"):
    m = mod.Sequential(config=cfg)
    m.add_input((20,))
    m.add(mod.Dense(32, activation="relu"))
    m.add(mod.Dense(4))
    m.add(mod.Activation("softmax"))
    m.compile(optimizer=opt, loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return m


def _blobs(n=128, dim=20, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(4, dim) * 3
    y = rs.randint(0, 4, n)
    return ((centers[y] + rs.randn(n, dim)).astype(np.float32),
            y.astype(np.int32))


def test_keras_sequential_matches_jax():
    """Sequential (Dense-relu, Dense, softmax) with SGD: the port's
    History losses and accuracies over three epochs within 1e-4 of the
    JAX package's from the same weights; evaluate and summary."""
    x, y = _blobs()
    jm = _sequential(jkeras, JFFConfig(batch_size=32, num_devices=1))
    km = _sequential(keras, FFConfig(batch_size=32, device="cpu"))
    _carry_weights(jm, km)
    jh = jm.fit(x, y, epochs=3, verbose=False)
    kh = km.fit(x, y, epochs=3, verbose=False)
    assert_close(kh.history["loss"], jh.history["loss"])
    assert_close(kh.history["accuracy"], jh.history["accuracy"])
    pm = km.evaluate(x, y, verbose=False)
    assert pm.train_correct / pm.train_all > 0.9
    assert "dense" in km.summary().lower()


def test_keras_functional_matches_jax():
    """Two inputs, two Dense branches, Concatenate, softmax head, Adam:
    History losses within 1e-4 of the JAX package's, and predict."""
    def build(mod, cfg):
        a = mod.Input((8,), name="a")
        b = mod.Input((8,), name="b")
        da = mod.Dense(16, activation="relu")(a)
        db = mod.Dense(16, activation="relu")(b)
        merged = mod.Concatenate(axis=1)(da, db)
        out = mod.Activation("softmax")(mod.Dense(3)(merged))
        m = mod.Model(inputs=[a, b], outputs=out, config=cfg)
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        return m

    rs = np.random.RandomState(0)
    xa = rs.randn(64, 8).astype(np.float32)
    xb = rs.randn(64, 8).astype(np.float32)
    y = rs.randint(0, 3, 64).astype(np.int32)
    jm = build(jkeras, JFFConfig(batch_size=16, num_devices=1))
    km = build(keras, FFConfig(batch_size=16, device="cpu"))
    _carry_weights(jm, km)
    jh = jm.fit([xa, xb], y, epochs=2, verbose=False)
    kh = km.fit([xa, xb], y, epochs=2, verbose=False)
    assert_close(kh.history["loss"], jh.history["loss"])
    assert_close(km.predict([xa, xb]), jm.predict([xa, xb]))


def test_keras_callbacks_match_jax(tmp_path):
    """LearningRateScheduler, EarlyStopping, History and ModelCheckpoint
    through both packages' keras fit on the synthetic mnist: the same
    learning rates seen, the same losses within 1e-4, no early stop, a
    checkpoint written by the port restoring into the JAX model."""
    from flexflow_tpu.frontends.keras import callbacks as jcb
    from flexflow_tpu.runtime.checkpoint import restore_checkpoint

    from flexflow_tpu_torch.frontends.keras import callbacks as cb

    (xtr, ytr), _ = keras.datasets.mnist.load_data(n_train=256, n_test=32)
    (jx, jy), _ = jkeras.datasets.mnist.load_data(n_train=256, n_test=32)
    np.testing.assert_array_equal(xtr, jx)
    x = (xtr.reshape(256, 784) / 255.0).astype(np.float32)
    y = ytr.astype(np.int32)

    def build(mod, cfg):
        m = mod.Sequential(config=cfg)
        m.add_input((784,))
        m.add(mod.Dense(32, activation="relu"))
        m.add(mod.Dense(10))
        m.add(mod.Activation("softmax"))
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        return m

    jm = build(jkeras, JFFConfig(batch_size=64, num_devices=1))
    km = build(keras, FFConfig(batch_size=64, device="cpu"))
    _carry_weights(jm, km)
    runs = {}
    for label, m, cbs in (("jax", jm, jcb), ("port", km, cb)):
        lrs = []
        sched = cbs.LearningRateScheduler(
            lambda e, lr, lrs=lrs: lrs.append(lr) or 0.05 * (0.9 ** e))
        es = cbs.EarlyStopping(monitor="accuracy", mode="max", patience=10)
        extra = [cbs.ModelCheckpoint(str(tmp_path / "ck_{epoch}"),
                                     save_freq=3)] if label == "port" else []
        hist = m.fit(x, y, epochs=3, verbose=False,
                     callbacks=[sched, es] + extra)
        runs[label] = (m, hist, lrs, es)
    (jm, jh, jlrs, _), (km, kh, klrs, kes) = runs["jax"], runs["port"]
    assert_close(klrs, jlrs)
    assert len(kh.history["loss"]) == 3 and not kes.stop_training
    assert_close(kh.history["loss"], jh.history["loss"])
    restore_checkpoint(str(tmp_path / "ck_2"), jm.ffmodel)
    assert_close(jm.predict(x), km.predict(x))


def test_keras_early_stopping_halts():
    x, y = _blobs(128, 16, seed=1)
    y = (y % 2).astype(np.int32)
    m = keras.Sequential(config=FFConfig(batch_size=32, device="cpu"))
    m.add_input((16,))
    m.add(keras.Dense(4))
    m.add(keras.Activation("softmax"))
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    es = keras.callbacks.EarlyStopping(monitor="loss", patience=0,
                                       min_delta=10.0)
    hist = m.fit(x, y, epochs=10, verbose=False, callbacks=[es])
    assert len(hist.history["loss"]) < 10 and es.stop_training


def test_keras_optimizers_and_refusals():
    adam = keras.optimizers.Adam(learning_rate=0.01, beta_1=0.8)
    assert adam == AdamOptimizer(lr=0.01, beta1=0.8, epsilon=1e-7)
    sgd = keras.optimizers.SGD(learning_rate=0.1, momentum=0.9,
                               nesterov=True)
    assert sgd.momentum == 0.9 and sgd.nesterov
    m = keras.Sequential(config=FFConfig(batch_size=8, device="cpu"))
    m.add_input((6,))
    m.add(keras.Dense(3, activation="sofmax"))
    with pytest.raises(ValueError):
        m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")


_KERAS_JSON = {
    "class_name": "Functional",
    "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "in0",
             "config": {"name": "in0"}, "inbound_nodes": []},
            {"class_name": "Dense", "name": "fc",
             "config": {"name": "fc", "units": 8, "activation": "relu"},
             "inbound_nodes": [{"args": [{
                 "class_name": "__keras_tensor__",
                 "config": {"keras_history": ["in0", 0, 0]}}]}]},
            {"class_name": "LayerNormalization", "name": "ln",
             "config": {"name": "ln", "epsilon": 1e-3},
             "inbound_nodes": [{"args": [{
                 "class_name": "__keras_tensor__",
                 "config": {"keras_history": ["fc", 0, 0]}}]}]},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "units": 2,
                        "activation": "softmax"},
             "inbound_nodes": [{"args": [{
                 "class_name": "__keras_tensor__",
                 "config": {"keras_history": ["ln", 0, 0]}}]}]},
        ],
        "input_layers": ["in0", 0, 0],
        "output_layers": ["out", 0, 0],
    },
}


def test_keras_exp_from_json_without_tensorflow():
    """keras JSON alone (no tensorflow object) walks into the same graph
    as the JAX package's walk of it, and predicts the same (1e-4) from
    the same weights."""
    payload = json.dumps(_KERAS_JSON)
    ff = FFModel(FFConfig(batch_size=4, device="cpu"))
    (out,) = KerasExpModel(json_config=payload).to_ff(
        ff, [ff.create_tensor((4, 16), name="input")])
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    jff = JFFModel(JFFConfig(batch_size=4, num_devices=1))
    JKerasExp(json_config=payload).to_ff(
        jff, [jff.create_tensor((4, 16), name="input")])
    jff.compile(loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    assert _summary(ff.graph) == _summary(jff.graph)
    assert [n.op_type for n in ff.graph.nodes].count(OpType.LINEAR) == 2
    tr, _ = ff._params
    for k, w in jff._params[0].items():
        for n, a in w.items():
            tr[k][n].copy_(torch.from_numpy(np.array(a)))
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    assert_close(ff.predict(x), jff.predict(x))
    with pytest.raises(ValueError, match="to_json"):
        KerasExpModel()
