"""flexflow_tpu_torch stands alone: it imports neither jax nor flexflow_tpu
(nor transformers: the HF importer duck-types its models), and it never
drifts to the CPU when a card was asked for."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "flexflow_tpu_torch"

_GUARDED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in REFUSED:
                raise ImportError(f"refused import of {name}")
            return None

    REFUSED = ("jax", "jaxlib", "flexflow_tpu", "transformers")
    for mod in [m for m in sys.modules if m.split(".")[0] in REFUSED]:
        del sys.modules[mod]
    sys.meta_path.insert(0, Refuse())
    import flexflow_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        flexflow_tpu_torch.__path__, "flexflow_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    assert not bad, bad
    print(len(names), "modules")
    print(" ".join(names))
""")

# the modules of the ring slice, each imported under the guard
_RING_MODULES = ("flexflow_tpu_torch.parallel.mesh",
                 "flexflow_tpu_torch.parallel.comm_spec",
                 "flexflow_tpu_torch.parallel.ring",
                 "flexflow_tpu_torch.ops.ring_flash")
# the host tier, disaggregation, the span tracer and ledger, and the
# numerics budget catalog
_SERVE_OBS_MODULES = ("flexflow_tpu_torch.disagg",
                      "flexflow_tpu_torch.disagg.host_tier",
                      "flexflow_tpu_torch.disagg.router",
                      "flexflow_tpu_torch.disagg.workers",
                      "flexflow_tpu_torch.obs.trace",
                      "flexflow_tpu_torch.obs.ledger",
                      "flexflow_tpu_torch.analysis",
                      "flexflow_tpu_torch.analysis.num_budgets")
# checkpoints, data loaders, recompilation, serialization, the native
# loader, the frontends, the CLI driver and the examples
_FRONTEND_RUNTIME_MODULES = (
    "flexflow_tpu_torch.__main__",
    "flexflow_tpu_torch.native",
    "flexflow_tpu_torch.pcg.serialize",
    "flexflow_tpu_torch.runtime.checkpoint",
    "flexflow_tpu_torch.runtime.dataloader",
    "flexflow_tpu_torch.runtime.recompile",
    "flexflow_tpu_torch.frontends",
    "flexflow_tpu_torch.frontends.hf",
    "flexflow_tpu_torch.frontends.hf_standin",
    "flexflow_tpu_torch.frontends.torch_fx",
    "flexflow_tpu_torch.frontends.keras",
    "flexflow_tpu_torch.frontends.keras.callbacks",
    "flexflow_tpu_torch.frontends.keras.datasets",
    "flexflow_tpu_torch.frontends.keras.layers",
    "flexflow_tpu_torch.frontends.keras.models",
    "flexflow_tpu_torch.frontends.keras.optimizers",
    "flexflow_tpu_torch.frontends.keras_exp",
    "flexflow_tpu_torch.examples",
) + tuple(f"flexflow_tpu_torch.examples.{n}" for n in (
    "alexnet_cifar10", "bert_attribute_parallel", "candle_uno",
    "dlrm_train", "hf_finetune", "inception_v3", "llama_train",
    "mixtral_moe", "mnist_mlp", "nmt_seq2seq", "resnet_torch_import",
    "transformer"))
# the strategy search and what it reads: sharding views, parallel ops,
# graph algorithms, the consistency checks
_SEARCH_MODULES = ("flexflow_tpu_torch.parallel.sharding",
                   "flexflow_tpu_torch.parallel.parallel_ops",
                   "flexflow_tpu_torch.pcg.algorithms",
                   "flexflow_tpu_torch.analysis.consistency") + tuple(
    f"flexflow_tpu_torch.search.{n}" for n in (
        "api", "cost_model", "dp", "eventsim", "machine_model", "mcmc",
        "measured", "space", "substitution", "table", "xfer_engine"))
# the serving-strategy search, its simulator and calibration, the
# autopilot, and the two command-line tools
_SERVESEARCH_MODULES = (
    "flexflow_tpu_torch.serving_autopilot",
    "flexflow_tpu_torch.search.servesearch",
    "flexflow_tpu_torch.search.ticksim",
    "flexflow_tpu_torch.search.traffic",
    "flexflow_tpu_torch.obs.calibrate",
    "flexflow_tpu_torch.tools",
    "flexflow_tpu_torch.tools.fftrace",
    "flexflow_tpu_torch.tools.servesearch")
# one process per card: the process group, the process mesh and its
# collectives, the ops on their shards
_DISTRIBUTED_MODULES = ("flexflow_tpu_torch.runtime.distributed",
                        "flexflow_tpu_torch.parallel.spmd",
                        "flexflow_tpu_torch.parallel.shard_rules")
# the speculative-decoding package
_SPEC_MODULES = ("flexflow_tpu_torch.spec",
                 "flexflow_tpu_torch.spec.config",
                 "flexflow_tpu_torch.spec.drafter",
                 "flexflow_tpu_torch.spec.fixtures",
                 "flexflow_tpu_torch.spec.server",
                 "flexflow_tpu_torch.spec.tree")


def test_port_and_chip_smoke_import_without_jax_or_reference():
    """Every port module and chip_smoke import with jax, flexflow_tpu and
    transformers refused by a meta-path hook, in a fresh interpreter
    (frontends.hf and the strategy search among them)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _GUARDED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.splitlines()[:2]
    # models.gpt2, the K4/K5 wrappers' module and the ring's among them
    assert int(count.split()[0]) >= 21
    assert set(_RING_MODULES) <= set(names.split())
    assert set(_SPEC_MODULES) <= set(names.split())
    assert set(_SERVE_OBS_MODULES) <= set(names.split())
    assert set(_FRONTEND_RUNTIME_MODULES) <= set(names.split())
    assert set(_SEARCH_MODULES) <= set(names.split())
    assert set(_SERVESEARCH_MODULES) <= set(names.split())
    assert set(_DISTRIBUTED_MODULES) <= set(names.split())


def test_no_reference_import_statements_in_port_sources():
    """No import statement anywhere in the port (lazy ones included) or in
    chip_smoke.py names jax or flexflow_tpu."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "flexflow_tpu"), (f, n)


def test_native_loader_builds_from_the_port_source_at_first_use(
        monkeypatch, tmp_path):
    """The loader library is compiled from csrc/ffloader.cc into
    _build/ at first use, never at import, with no switch to skip it; a
    failed compile raises with g++'s output instead of returning None."""
    from flexflow_tpu_torch import native

    assert native.LOADER_SOURCE == PORT / "csrc" / "ffloader.cc"
    assert native.loader_library_path().parent == PORT / "_build"
    src = (PORT / "native" / "__init__.py").read_text()
    assert "environ" not in src
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++")
    monkeypatch.setattr(native, "LOADER_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_loader()


def test_default_device_raises_without_cuda(monkeypatch):
    """With no card visible, the default ("cuda") entry points raise
    instead of running on the CPU."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ff = FFModel(FFConfig(batch_size=1))
    assert ff.config.device == "cuda"
    build_llama(ff, LlamaConfig.tiny(), batch_size=1, seq_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        ff.compile()
    with pytest.raises(RuntimeError):
        ff.serve_generation(paged=True)  # not compiled: nothing to serve


def test_gpt2_default_device_raises_without_cuda(monkeypatch):
    """The GPT-2 path too: with no card visible, compile() on the default
    device raises; nothing falls back to the CPU."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ff = FFModel(FFConfig(batch_size=1))
    build_gpt2(ff, GPT2Config.tiny(), batch_size=1, seq_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        ff.compile()


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line when no
    card is visible (as on this CPU-only run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible; chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_training_entry_points_raise():
    """What the training slice does not port raises, naming ROADMAP: the
    orbax checkpoint backend (item 12). Ported and no longer refused:
    periodic checkpoints (FFConfig.checkpoint_dir / checkpoint_every),
    fit(dataloaders=...), fit(recompile_state=...), initializer
    overrides (the override draws the leaf) and attention dropout in
    training (the dense route): fit trains through each."""
    import tempfile

    from flexflow_tpu_torch import FFConfig, FFModel, LossType
    from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama
    from flexflow_tpu_torch.ops import torch_ops
    from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint
    from flexflow_tpu_torch.runtime.recompile import RecompileState

    ff = FFModel(FFConfig(batch_size=1, device="cpu"))
    x = ff.create_tensor((1, 4, 16))
    d = ff.dense(x, 16, kernel_initializer="zeros", name="zeroed")
    ff.multihead_attention(d, d, d, 16, 2, dropout=0.1)
    ff.compile(loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert not ff.get_weight("zeroed").any()
    before = torch_ops.DENSE_DROPOUT_ATTENTION.launches
    m = ff.fit(np.ones((1, 4, 16), np.float32),
               np.zeros((1, 4, 16), np.float32), verbose=False)
    assert torch_ops.DENSE_DROPOUT_ATTENTION.launches > before
    assert m.train_all == 1
    with tempfile.TemporaryDirectory() as ckdir:
        ff = FFModel(FFConfig(batch_size=1, device="cpu",
                              checkpoint_dir=ckdir, checkpoint_every=2))
        build_llama(ff, LlamaConfig.tiny(), batch_size=1, seq_len=4)
        ff.compile()
        ids = np.zeros((2, 4), np.int32)
        st = RecompileState(lambda s: s.recompilations == 0,
                            lambda s: None, ff)
        ff.fit(dataloaders=[ff.create_data_loader(None, ids),
                            ff.create_data_loader(None, ids)],
               recompile_state=st, verbose=False)
        assert st.recompilations == 1
        assert sorted(os.listdir(ckdir)) == ["latest.json", "step_2"]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            save_checkpoint(os.path.join(ckdir, "o"), ff, backend="orbax")
