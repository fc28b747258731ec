"""Every example script of the port (flexflow_tpu_torch/examples/, one per
examples/python/*.py) and the CLI driver, run in this process on
`--device cpu` at small batches: each trains an epoch and reports its
samples; the driver parses the reference's flags (the search's among
them), hands them to the script and refuses what the port does not run
(a mesh over several cards: queue 1 item 12)."""

import importlib
import pathlib
import sys

import pytest
import torch

import flexflow_tpu_torch
from flexflow_tpu_torch import __main__ as driver

EXAMPLES = pathlib.Path(flexflow_tpu_torch.__file__).parent / "examples"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test runner's workers share the cores, and
    torch's thread pool oversubscribes them (the examples' many small ops
    ran ~20x slower with six workers of eight threads each)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_CASES = [
    ("mnist_mlp", ("-b", "64")),
    ("alexnet_cifar10", ("-b", "4")),
    ("bert_attribute_parallel", ("-b", "2")),
    ("candle_uno", ("-b", "16")),
    ("dlrm_train", ("-b", "128")),
    ("inception_v3", ("-b", "2")),
    ("llama_train", ("-b", "1")),
    ("llama_train", ("-b", "1", "--pipeline")),
    ("mixtral_moe", ("-b", "1")),
    ("nmt_seq2seq", ("-b", "8")),
    ("resnet_torch_import", ("-b", "8")),
    ("hf_finetune", ("-b", "2")),
    ("transformer", ("-b", "4")),
    ("transformer", ("-b", "4", "--enc-dec")),
]


def test_every_reference_example_has_a_port():
    ref = sorted(p.stem for p in (EXAMPLES.parents[1] / "examples"
                                  / "python").glob("*.py"))
    port = sorted(p.stem for p in EXAMPLES.glob("*.py")
                  if p.stem != "__init__")
    assert port == ref
    assert sorted({c for c, _ in _CASES}) == port


@pytest.mark.parametrize("script,flags", _CASES,
                         ids=[" ".join((c,) + f[2:]) for c, f in _CASES])
def test_example_runs_on_the_cpu(script, flags, capsys):
    mod = importlib.import_module(f"flexflow_tpu_torch.examples.{script}")
    pm = mod.main([*flags, "-e", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch 0: samples=" in out
    assert pm.train_all > 0


def test_cli_driver_runs_a_script(capsys, monkeypatch):
    """`python -m flexflow_tpu_torch --device cpu SCRIPT flags`: the flags
    reach the script as its argv and the driver's config."""
    monkeypatch.setattr(sys, "argv", sys.argv[:])
    monkeypatch.setattr(flexflow_tpu_torch, "_driver_config", None)
    assert flexflow_tpu_torch.get_driver_config().device == "cuda"
    rc = driver.main(["--device", "cpu", str(EXAMPLES / "mnist_mlp.py"),
                      "-b", "64", "-e", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "epoch 0: samples=4096" in out and "eval: samples=1024" in out
    cfg = flexflow_tpu_torch.get_driver_config()
    assert (cfg.device, cfg.batch_size, cfg.epochs) == ("cpu", 64, 1)
    assert driver.main(["--help"]) == 0


@pytest.mark.parametrize("flags,item", [
    (("--mesh", "data=2,data_sub=2"), 12),
    (("--mesh", "data=2,expert=2"), 12),
    (("--mesh", "pipe=2"), 12),
])
def test_cli_driver_refuses_by_item(flags, item, monkeypatch):
    monkeypatch.setattr(sys, "argv", sys.argv[:])
    monkeypatch.setattr(flexflow_tpu_torch, "_driver_config", None)
    with pytest.raises(NotImplementedError,
                       match=rf"queue 1 item {item}\)"):
        driver.main(["--device", "cpu", str(EXAMPLES / "mnist_mlp.py"),
                     *flags])


@pytest.mark.parametrize("flags", [("--mesh", "data=2,model=4"),
                                   ("--devices", "8"),
                                   ("--mesh", "seq=2,model=2")])
def test_cli_driver_refuses_more_cards_than_processes(flags, monkeypatch):
    """A mesh or device count above the world size (one process here)
    raises ValueError naming both: each card runs its own process
    (torchrun; `seq` beside `model` spans processes too)."""
    monkeypatch.setattr(sys, "argv", sys.argv[:])
    monkeypatch.setattr(flexflow_tpu_torch, "_driver_config", None)
    with pytest.raises(ValueError, match="world size is 1"):
        driver.main(["--device", "cpu", str(EXAMPLES / "mnist_mlp.py"),
                     *flags])
