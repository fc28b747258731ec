"""flexflow_tpu_torch stands alone: it imports neither jax nor flexflow_tpu,
and it never drifts to the CPU when a card was asked for."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "flexflow_tpu_torch"

_GUARDED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flexflow_tpu"):
                raise ImportError(f"refused import of {name}")
            return None

    for mod in [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flexflow_tpu")]:
        del sys.modules[mod]
    sys.meta_path.insert(0, Refuse())
    import flexflow_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        flexflow_tpu_torch.__path__, "flexflow_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flexflow_tpu")]
    assert not bad, bad
    print(len(names), "modules")
""")


def test_port_and_chip_smoke_import_without_jax_or_reference():
    """Every port module and chip_smoke import with jax and flexflow_tpu
    refused by a meta-path hook, in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _GUARDED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 15


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
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ff.fit()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ff.compile(optimizer=object())
