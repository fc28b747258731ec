"""Runtime configuration (counterpart of flexflow_tpu/config.py).

Every field of the reference's FFConfig, with its name and default, and
its argv parser `from_args`. Every field is ported: it does on one device
what the reference does there. A field the port could not honour would
be listed in `REFUSED` with the ROADMAP.md queue 1 item that ports it and
raise NotImplementedError away from its default, so no setting is
silently ignored; none is listed now. Several cards run one process
each (torchrun, runtime/distributed.py): `num_devices` is the world size
and a mesh's `data` x `model` must equal it; the `pipe`, `expert` and
`data_sub` axes raise (item 12). The port adds
one field, `device`: every entry point runs on the card ("cuda") unless
the caller asks for "cpu", and a CUDA request on a machine without a
card raises instead of drifting to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from flexflow_tpu_torch.ffconst import CompMode, DataType, ParamSyncType
from flexflow_tpu_torch.parallel.mesh import check_axes, check_world

REMAT_MODES = ("none", "attention", "hidden")
# transfer_guard levels -> torch.cuda.set_sync_debug_mode's: the guard
# surfaces host<->device transfers in fit's step loop, as jax's does
TRANSFER_GUARDS = {"allow": "default", "log": "warn", "log_explicit": "warn",
                   "disallow": "error", "disallow_explicit": "error"}

# the reference's fields the port refuses away from their defaults, each
# with the ROADMAP.md queue 1 item that ports it: none
REFUSED: Dict[str, int] = {}


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
    # the cards, one process each: above 1 it must be the world size of
    # the process group (runtime/distributed.initialize)
    num_devices: Optional[int] = None
    # explicit mesh shape, {axis name: size}; None is {"data": world
    # size}. "data" and "model" span the processes (their product is the
    # world size); "seq" cuts ring attention's sequence inside one
    # process; "pipe", "expert" and "data_sub" above 1 raise (ROADMAP.md,
    # queue 1 item 12)
    mesh_shape: Optional[Dict[str, int]] = None

    # ---- numerics ----
    # carried, as the reference carries it (nothing there reads it)
    compute_dtype: DataType = DataType.FLOAT
    # PSUM or SHARDED: SHARDED is ZeRO-1 over the data axis (the Adam
    # state cut over `data`, gradients reduce-scattered, new parameters
    # all-gathered); with data 1 both keep the whole optimizer state
    param_sync: ParamSyncType = ParamSyncType.PSUM

    # ---- strategy search (search/api.py): budget <= 5 runs MCMC over
    # views on the fixed graph, > 5 the Unity substitution search; the
    # machine priced is config.machine_model_file's, else H100s as many
    # as the mesh has positions (search_num_devices extends the data axis);
    # measure_costs times op shards on `device`; validate_top_k > 1 times
    # the top candidates' real train steps on `device` and keeps the
    # fastest ----
    search_budget: int = 0
    search_alpha: float = 1.05
    only_data_parallel: bool = False
    enable_parameter_parallel: bool = True
    enable_attribute_parallel: bool = True
    # splits a data axis of 4 or more into data x data_sub (submesh
    # placement), which raises: `data_sub` is not ported yet (queue 1 item
    # 12); a smaller data axis does not split, as in the reference
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

    # ---- periodic checkpoints ----
    # fit writes checkpoint_dir/step_N (runtime/checkpoint.periodic_save)
    # after every checkpoint_every-th step when both are set
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0

    # ---- execution ----
    # prints the search's measured knobs, its modeled best and the timed
    # strategy playoff, as the reference does
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
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            if self.num_devices != world:
                raise ValueError(
                    f"FFConfig.num_devices={self.num_devices} but the world "
                    f"size is {world}: one process runs each card (torchrun "
                    f"--nproc-per-node {self.num_devices}, then "
                    "runtime.distributed.initialize())")
        if self.mesh_shape is not None:
            check_axes(self.mesh_shape)
            check_world(self.mesh_shape)
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
