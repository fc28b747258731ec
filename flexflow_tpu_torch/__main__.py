"""CLI driver: `python -m flexflow_tpu_torch [--device cpu] SCRIPT [flags]`
(counterpart of flexflow_tpu/__main__.py).

Parses the reference's flags (FFConfig.from_args: -b, -e, --seed,
--checkpoint-dir, --checkpoint-every, ...) into the default FFConfig,
which a script reads through `flexflow_tpu_torch.get_driver_config()`,
and runs SCRIPT as __main__ with those flags as its argv. `--device`
before SCRIPT is passed on to it (the card unless "cpu" is asked for).
The search flags (--budget, --alpha, --validate-top-k, --import /
--export, --compgraph, --machine-model-file, ...) reach compile() through
the config. Under torchrun (`torchrun --nproc-per-node N -m
flexflow_tpu_torch SCRIPT --mesh data=D,seq=S,model=M`, D x S x M = N,
any of them left out at 1) each process joins the process group first
(runtime.distributed.initialize: NCCL on the card LOCAL_RANK names, gloo
with --device cpu), so the script's model spans the N processes; a
--mesh or --devices that is not the world size raises before the script
runs.
"""

from __future__ import annotations

import runpy
import sys

from flexflow_tpu_torch.config import FFConfig

USAGE = ("usage: python -m flexflow_tpu_torch [--device cpu] SCRIPT [flags]\n"
         "flags: -b/--batch-size -e/--epochs --seed --checkpoint-dir D "
         "--checkpoint-every N --device cuda|cpu --profiling --budget N "
         "--import F --export F ...")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if argv[:1] == ["--device"]:
        if len(argv) < 2:
            raise ValueError("flag '--device' requires a value")
        device = argv[1]
        del argv[:2]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print(USAGE)
        return 0
    script, rest = argv[0], argv[1:]
    if device is not None and "--device" not in rest:
        rest += ["--device", device]
    # kept on the package (not this module: under `python -m` this file
    # runs as __main__, and a script importing flexflow_tpu_torch.__main__
    # would get a second instance)
    import os

    import flexflow_tpu_torch

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from flexflow_tpu_torch.runtime import distributed

        distributed.initialize(device=device or "cuda")
    flexflow_tpu_torch._driver_config = FFConfig.from_args(rest)
    sys.argv = [script] + rest
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
