"""The port's model zoo against the JAX package's, builder by builder, on
the CPU: the same PCG node for node (names, stable keys, op types,
attrs, output shapes, weight specs) at the published sizes; then, at
tiny sizes and dropout 0, with the JAX model's weights carried over,
the same predictions and one SGD step at lr 1 (so every parameter moves
by its gradient) to the same loss and parameters, within TOL
(tests/torch_parity.py). The CNNs that hold BatchNorm are in
test_torch_zoo_cnn.py."""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import models as jmodels  # noqa: E402
from flexflow_tpu_torch import FFConfig, FFModel, LossType  # noqa: E402
from flexflow_tpu_torch import models as tmodels  # noqa: E402
from torch_parity import (  # noqa: E402
    check_forward_and_step,
    graph_summary,
    model_pair,
)

# builder name -> (args, kwargs) at the published sizes (graphs only)
PUBLISHED = {
    "build_mlp": ((784, [512, 512], 10), {"batch_size": 64}),
    "build_alexnet": ((), {"batch_size": 64}),
    "build_alexnet_cifar10": ((), {"batch_size": 64}),
    "build_resnet50": ((), {"batch_size": 64}),
    "build_resnext50": ((), {"batch_size": 64}),
    "build_inception_v3": ((), {"batch_size": 64}),
    "build_candle_uno": ((), {"batch_size": 64}),
    "build_bert": (("BertConfig()",), {"batch_size": 32, "seq_len": 512}),
    "build_transformer_encoder": (("TransformerConfig()",),
                                  {"batch_size": 16, "seq_len": 256}),
    "build_transformer_encoder_decoder": (
        ("TransformerConfig()",), {"batch_size": 16, "src_len": 256,
                                   "tgt_len": 200}),
    "build_nmt": (("NMTConfig()",), {"batch_size": 64}),
    "build_dlrm": ((), {"batch_size": 2048}),
    "build_xdl": ((), {"batch_size": 256}),
}


MODULES = {"build_mlp": "mlp", "build_alexnet": "alexnet",
           "build_alexnet_cifar10": "alexnet", "build_resnet50": "resnet",
           "build_resnext50": "resnext", "build_inception_v3": "inception",
           "build_candle_uno": "candle_uno", "build_bert": "bert",
           "build_transformer_encoder": "transformer",
           "build_transformer_encoder_decoder": "transformer",
           "build_nmt": "nmt", "build_dlrm": "dlrm", "build_xdl": "xdl"}


def _builder(pkg, builder):
    """The builder from its module (the reference's package exports all
    but build_alexnet_cifar10)."""
    return getattr(importlib.import_module(
        f"{pkg.__name__}.{MODULES[builder]}"), builder)


def _resolve(pkg, args):
    return [getattr(pkg, a[:-2])() if isinstance(a, str) else a
            for a in args]


@pytest.mark.parametrize("builder", sorted(PUBLISHED))
def test_graph_matches_reference_at_published_sizes(builder):
    """Every builder of flexflow_tpu/models/ but the decoder LMs (their
    own tests): the port's builder makes the reference's PCG node for
    node at the published sizes."""
    args, kw = PUBLISHED[builder]
    jff = JFFModel(JFFConfig(batch_size=kw.get("batch_size", 8),
                             num_devices=1))
    _builder(jmodels, builder)(jff, *_resolve(jmodels, args), **kw)
    tff = FFModel(FFConfig(batch_size=kw.get("batch_size", 8),
                           device="cpu"))
    _builder(tmodels, builder)(tff, *_resolve(tmodels, args), **kw)
    assert graph_summary(tff.graph) == graph_summary(jff.graph)


def test_strategies_raise_naming_the_roadmap():
    """The strategies over the pipe and expert axes still raise, naming
    ROADMAP; those over data and model (one process per card) are the
    reference's views."""
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        tmodels.llama_pp_strategy(tmodels.LlamaConfig.tiny())
    with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
        tmodels.mixtral_ep_strategy(tmodels.MixtralConfig.tiny())
    from flexflow_tpu.models import bert as jbert
    from flexflow_tpu.models import nmt as jnmt
    from flexflow_tpu.parallel.sharding import view_to_json as jview
    from flexflow_tpu_torch.parallel.sharding import view_to_json

    for name, cfg, jmod in (
            ("bert_attribute_parallel_strategy", "BertConfig", jbert),
            ("nmt_dp_strategy", "NMTConfig", jnmt)):
        got = getattr(tmodels, name)(getattr(tmodels, cfg)())
        want = getattr(jmod, name)(getattr(jmod, cfg)())
        assert {k: view_to_json(v) for k, v in got.items()} == \
            {k: jview(v) for k, v in want.items()}


B = 2


def _ints(rs, hi, *shape):
    return rs.randint(0, hi, shape).astype(np.int32)


def _f(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


# name -> (builder, args for both packages (config names resolved per
# package), kwargs, loss, inputs(rs), labels(rs))
TINY = {
    "mlp": ("build_mlp", (16, [32, 24], 10), {},
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
            lambda rs: [_f(rs, B, 16)], lambda rs: _ints(rs, 10, B)),
    "alexnet_cifar10": (
        "build_alexnet_cifar10", (), {},
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        lambda rs: [_f(rs, B, 3, 32, 32)], lambda rs: _ints(rs, 10, B)),
    "candle_uno": (
        "build_candle_uno", (),
        {"feature_dims": {"gene": 8, "drug1": 12, "drug2": 12},
         "tower_dims": (16, 16), "head_dims": (24, 16)},
        LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        lambda rs: [_f(rs, B, 1), _f(rs, B, 8), _f(rs, B, 12),
                    _f(rs, B, 12)], lambda rs: _f(rs, B, 1)),
    "bert": ("build_bert", ("BertConfig",), {"seq_len": 8},
             LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
             lambda rs: [_ints(rs, 64, B, 8)], lambda rs: _ints(rs, 2, B)),
    "transformer_encoder": (
        "build_transformer_encoder", ("TransformerConfig",),
        {"seq_len": 8}, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        lambda rs: [_f(rs, B, 8, 32)], lambda rs: _f(rs, B, 8, 1)),
    "transformer_encoder_decoder": (
        "build_transformer_encoder_decoder", ("TransformerConfig",),
        {"src_len": 8, "tgt_len": 6}, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        lambda rs: [_f(rs, B, 8, 32), _f(rs, B, 6, 32)],
        lambda rs: _f(rs, B, 6, 1)),
    "nmt": ("build_nmt", ("NMTConfig",), {"src_len": 5, "tgt_len": 4},
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
            lambda rs: [_ints(rs, 96, B, 5), _ints(rs, 88, B, 4)],
            lambda rs: _ints(rs, 88, B, 4)),
    "dlrm": ("build_dlrm", (),
             {"num_sparse": 3, "vocab": 50, "embed_dim": 8, "dense_dim": 5,
              "bag_size": 2, "bot_mlp": (16, 8), "top_mlp": (16, 1)},
             LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
             lambda rs: [_f(rs, B, 5)] + [_ints(rs, 50, B, 2)
                                          for _ in range(3)],
             lambda rs: rs.rand(B, 1).astype(np.float32)),
    "xdl": ("build_xdl", (),
            {"num_sparse": 3, "vocab": 50, "embed_dim": 4, "dense_dim": 5,
             "mlp_dims": (16, 8, 1)},
            LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
            lambda rs: [_ints(rs, 50, B, 1) for _ in range(3)]
            + [_f(rs, B, 5)], lambda rs: rs.rand(B, 1).astype(np.float32)),
}

TINY_CONFIGS = {
    "BertConfig": dict(vocab_size=64, hidden=32, layers=2, heads=4,
                       intermediate=64, dropout=0.0),
    "TransformerConfig": "tiny",
    "NMTConfig": "tiny",
}


def _tiny_args(pkg, args):
    out = []
    for a in args:
        if isinstance(a, str):
            cls = getattr(pkg, a)
            spec = TINY_CONFIGS[a]
            out.append(cls.tiny() if spec == "tiny" else cls(**spec))
        else:
            out.append(a)
    return out


def builders(name):
    builder, args, kw, *_ = TINY[name]

    def make(pkg):
        return lambda ff: _builder(pkg, builder)(
            ff, *_tiny_args(pkg, args), batch_size=B, **kw)

    return make(jmodels), make(tmodels)


@pytest.mark.parametrize("name", sorted(TINY))
def test_forward_and_train_step_match_reference(monkeypatch, name):
    """Tiny widths, dropout 0, the JAX model's weights carried over: the
    same predictions, then one SGD step at lr 1 to the same loss and the
    same parameters."""
    *_, loss, inputs, labels = TINY[name]
    jff, tff = model_pair(monkeypatch, *builders(name), B, loss)
    rs = np.random.RandomState(1)
    check_forward_and_step(jff, tff, inputs(rs), labels(rs))
