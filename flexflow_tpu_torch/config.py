"""Runtime configuration (counterpart of flexflow_tpu/config.py).

Every field of the reference's FFConfig, with its name and default, and
its argv parser `from_args`. A field is either ported (it does on one
device what the reference does there) or refused: set away from its
default it raises NotImplementedError naming the ROADMAP.md queue 1 item
that ports it (`REFUSED`), so no setting is silently ignored. The port
adds one field, `device`: every entry point runs on the card ("cuda")
unless the caller asks for "cpu", and a CUDA request on a machine
without a card raises instead of drifting to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from flexflow_tpu_torch.ffconst import CompMode, DataType, ParamSyncType
from flexflow_tpu_torch.parallel.mesh import check_axes

REMAT_MODES = ("none", "attention", "hidden")
# transfer_guard levels -> torch.cuda.set_sync_debug_mode's: the guard
# surfaces host<->device transfers in fit's step loop, as jax's does
TRANSFER_GUARDS = {"allow": "default", "log": "warn", "log_explicit": "warn",
                   "disallow": "error", "disallow_explicit": "error"}

# the reference's fields the port refuses away from their defaults, and
# the ROADMAP.md queue 1 item that ports each: strategy search and its
# fusion pass (11), periodic checkpoints (10)
_SEARCH = 11
REFUSED = {
    "search_budget": _SEARCH, "search_alpha": _SEARCH,
    "only_data_parallel": _SEARCH, "enable_parameter_parallel": _SEARCH,
    "enable_attribute_parallel": _SEARCH, "enable_submesh": _SEARCH,
    "memory_search": _SEARCH, "search_num_devices": _SEARCH,
    "machine_model_file": _SEARCH, "measure_costs": _SEARCH,
    "validate_top_k": _SEARCH, "measure_cache_file": _SEARCH,
    "use_simulator": _SEARCH, "import_strategy_file": _SEARCH,
    "export_strategy_file": _SEARCH,
    "export_strategy_computation_graph_file": _SEARCH,
    "include_costs_dot_graph": _SEARCH, "perform_fusion": _SEARCH,
    "checkpoint_dir": 10, "checkpoint_every": 10,
}


@dataclasses.dataclass
class FFConfig:
    # ---- training loop ----
    batch_size: int = 64
    epochs: int = 1
    seed: int = 42
    # iteration-config truncation (the reference's FFIterationConfig),
    # handed to every lowering as LowerCtx.seq_length; only BATCH_MATMUL
    # reads it in the reference
    seq_length: Optional[int] = None

    # ---- devices / mesh ----
    # None, 0 or 1: the one card; more raises (queue 1 item 12)
    num_devices: Optional[int] = None
    # explicit mesh shape, {axis name: size}; None is {"data": 1}. Only
    # "seq" may exceed 1: ring attention cuts the sequence into that many
    # shards on the one device; any other axis above 1 raises (ROADMAP.md,
    # queue 1 item 12)
    mesh_shape: Optional[Dict[str, int]] = None

    # ---- numerics ----
    # carried, as the reference carries it (nothing there reads it)
    compute_dtype: DataType = DataType.FLOAT
    # PSUM or SHARDED: on one device both keep the whole optimizer state
    param_sync: ParamSyncType = ParamSyncType.PSUM

    # ---- strategy search: refused away from the defaults (REFUSED) ----
    search_budget: int = 0
    search_alpha: float = 1.05
    only_data_parallel: bool = False
    enable_parameter_parallel: bool = True
    enable_attribute_parallel: bool = True
    enable_submesh: bool = False
    memory_search: bool = False
    search_num_devices: Optional[int] = None
    machine_model_file: Optional[str] = None
    measure_costs: bool = False
    validate_top_k: int = 0
    measure_cache_file: Optional[str] = None
    use_simulator: bool = True
    import_strategy_file: Optional[str] = None
    export_strategy_file: Optional[str] = None
    export_strategy_computation_graph_file: Optional[str] = None
    include_costs_dot_graph: bool = False

    # ---- periodic checkpoints: refused (REFUSED) ----
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0

    # ---- execution ----
    # the reference prints the timed strategy playoff under it; the port
    # has no search, so it prints nothing more
    profiling: bool = False
    # fit runs under torch.profiler (CPU and, on the card, CUDA
    # activities) and writes a Chrome trace into this directory
    profiler_trace_dir: Optional[str] = None
    # "log" | "disallow" (TRANSFER_GUARDS): fit's step loop runs under
    # torch.cuda.set_sync_debug_mode("warn" | "error"), so a host sync in
    # a step warns or raises; the epoch's one read back is exempt
    transfer_guard: Optional[str] = None
    # rematerialization in training: "attention" recomputes each
    # attention lowering in backward (torch.utils.checkpoint) instead of
    # saving its intermediates; "hidden" instead recomputes the MLP
    # hidden activations (SwiGLU gate/up/silu/mul diamonds, expanding
    # Linear+activation chains, each with its contracting Linear:
    # Executor.remat_groups); "none" saves everything
    remat: str = "attention"
    perform_fusion: bool = False
    comp_mode: CompMode = CompMode.TRAINING
    # False: a train step leaves the trees it was given intact (the
    # reference's undonated jit); True updates them in place
    donate_buffers: bool = True

    # "cuda" (the default), "cuda:N", or "cpu" — never chosen implicitly
    device: str = "cuda"

    _devices: Optional[List] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        defaults = FFConfig.__dataclass_fields__
        for name, item in REFUSED.items():
            value = getattr(self, name)
            if value != defaults[name].default:
                raise NotImplementedError(
                    f"FFConfig.{name}={value!r} is not ported yet "
                    f"(ROADMAP.md, queue 1 item {item})")
        if self.num_devices is not None and self.num_devices > 1:
            raise NotImplementedError(
                f"FFConfig.num_devices={self.num_devices}: the port runs on "
                "one card; several are not ported yet (ROADMAP.md, queue 1 "
                "item 12)")
        if self.mesh_shape is not None:
            check_axes(self.mesh_shape)
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{self.remat!r}")
        if self.transfer_guard is not None \
                and self.transfer_guard not in TRANSFER_GUARDS:
            raise ValueError(f"transfer_guard must be one of "
                             f"{tuple(TRANSFER_GUARDS)}, got "
                             f"{self.transfer_guard!r}")
        self.compute_dtype = DataType(self.compute_dtype)
        self.param_sync = ParamSyncType(self.param_sync)
        self.comp_mode = CompMode(self.comp_mode)

    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    @property
    def devices(self) -> List[torch.device]:
        if self._devices is None:
            self._devices = [self.torch_device()]
        return self._devices

    @property
    def workers_per_node(self) -> int:
        return len(self.devices)

    @classmethod
    def from_args(cls, argv: Sequence[str]) -> "FFConfig":
        """Parse the reference's command-line flags (its model.cc:3556-3719
        names) into the same fields; a refused field raises as it does
        when passed to FFConfig. Unknown flags are ignored, as the
        reference passes them on to Legion. `--device` is the port's
        own."""
        kw = {}
        args = list(argv)
        i = 0

        def take() -> str:
            nonlocal i
            i += 1
            if i >= len(args):
                raise ValueError(f"flag {args[i - 1]!r} requires a value")
            return args[i]

        valued = {
            "-b": ("batch_size", int), "--batch-size": ("batch_size", int),
            "-e": ("epochs", int), "--epochs": ("epochs", int),
            "--seed": ("seed", int),
            "--checkpoint-dir": ("checkpoint_dir", str),
            "--checkpoint-every": ("checkpoint_every", int),
            "--devices": ("num_devices", int),
            "-ll:gpu": ("num_devices", int), "-ll:tpu": ("num_devices", int),
            "--budget": ("search_budget", int),
            "--search-budget": ("search_budget", int),
            "--validate-top-k": ("validate_top_k", int),
            "--alpha": ("search_alpha", float),
            "--search-alpha": ("search_alpha", float),
            "--profiler-trace": ("profiler_trace_dir", str),
            "--transfer-guard": ("transfer_guard", str),
            "--search-num-devices": ("search_num_devices", int),
            "--machine-model-file": ("machine_model_file", str),
            "--import-strategy": ("import_strategy_file", str),
            "--import": ("import_strategy_file", str),
            "--export-strategy": ("export_strategy_file", str),
            "--export": ("export_strategy_file", str),
            "--compgraph": ("export_strategy_computation_graph_file", str),
            "--device": ("device", str),
        }
        switches = {
            "--only-data-parallel": ("only_data_parallel", True),
            "--search": ("only_data_parallel", False),
            "--enable-parameter-parallel": ("enable_parameter_parallel",
                                            True),
            "--enable-attribute-parallel": ("enable_attribute_parallel",
                                            True),
            "--enable-submesh": ("enable_submesh", True),
            "--simulator": ("use_simulator", True),
            "--no-simulator": ("use_simulator", False),
            "--memory-search": ("memory_search", True),
            "--include-costs-dot-graph": ("include_costs_dot_graph", True),
            "--profiling": ("profiling", True),
            "--fusion": ("perform_fusion", True),
            "--inference": ("comp_mode", CompMode.INFERENCE),
        }
        while i < len(args):
            a = args[i]
            if a in valued:
                name, conv = valued[a]
                kw[name] = conv(take())
            elif a in switches:
                name, value = switches[a]
                kw[name] = value
            elif a == "--mesh":
                # e.g. --mesh data=1,seq=4
                kw["mesh_shape"] = {
                    k: int(v)
                    for k, v in (p.split("=") for p in take().split(","))}
            i += 1
        return cls(**kw)


def resolve_device(device) -> torch.device:
    """The torch.device for `device`, refusing a CUDA device when no card
    is visible (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
