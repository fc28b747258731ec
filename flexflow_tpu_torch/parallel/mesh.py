"""The device mesh (counterpart of flexflow_tpu/parallel/mesh.py).

The reference lays a `jax.sharding.Mesh` of named axes over its devices.
The port runs one process per card (torch.distributed, launched by
torchrun). `process_axes` is the one rule for which axes span the
processes:

  - a world of 1 (no process group, or one rank): the `data` and
    `model` axes above 1 would need other processes (check_world
    refuses them), and `seq` stays inside the process: its positions
    are the shards of the one-card ring (parallel/ring.py), which the
    process holds and rotates as block references;
  - a world above 1: every axis above 1 among `data`, `seq` and `model`
    is a process axis, and the product of their sizes is the world
    size (parallel/spmd.py holds their process groups, the ring's hop
    and the collectives).

The canonical order puts `model` fastest over the ranks and `seq`
next. `pipe`, `expert` and `data_sub` are ROADMAP.md, queue 1 item 12.

Canonical axis names used across the framework:
  data     — batch (data parallel)
  model    — hidden/heads (tensor parallel)
  seq      — sequence (context parallelism / ring attention)
  expert   — MoE expert parallel
  pipe     — pipeline stages
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

AXIS_ORDER = ("pipe", "data", "data_sub", "expert", "seq", "model")
# the axes whose positions may be processes (one per card), in
# canonical order
PROCESS_AXES = ("data", "seq", "model")
# what each axis not yet ported waits for
_UNPORTED = {
    "pipe": "the `pipe` axis (GPipe stages across cards)",
    "expert": "the `expert` axis (expert parallelism across cards)",
    "data_sub": "the `data_sub` axis (submesh placement)",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, every position on the config's one
    device."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def axes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def check_axes(axes: Dict[str, int]):
    """Refuse sizes below 1 and the axes not ported yet above 1; never
    ignore one."""
    for name, size in axes.items():
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"mesh axis {name!r} must have a positive int "
                             f"size, got {size!r}")
        if size > 1 and name not in PROCESS_AXES:
            part = _UNPORTED.get(name, f"mesh axis {name!r}")
            raise NotImplementedError(
                f"mesh axis {name!r} of size {size}: {part} is not ported "
                "yet (ROADMAP.md, queue 1 item 12)")


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_axes(axes: Dict[str, int], world: Optional[int] = None
                 ) -> Tuple[str, ...]:
    """The axes of `axes` whose positions are processes, in canonical
    order, for a world of `world` processes (the process group's, 1
    without one): on a world of 1 `data` and `model` above 1 (which
    check_world then refuses) and never `seq`, the one-card ring's axis;
    on a world above 1 every axis above 1 among `data`, `seq` and
    `model`."""
    world = _world() if world is None else world
    names = PROCESS_AXES if world > 1 else ("data", "model")
    return tuple(n for n in names if axes.get(n, 1) > 1)


def process_count(axes: Dict[str, int], world: Optional[int] = None) -> int:
    """The processes a mesh spans: the product of its process axes."""
    n = 1
    for name in process_axes(axes, world):
        n *= axes[name]
    return n


def check_world(axes: Dict[str, int]):
    """The product of the process axes must be the world size (1 without
    a process group): a ValueError names both."""
    world = _world()
    n = process_count(axes, world)
    if n != world:
        raise ValueError(
            f"mesh {dict(axes)} spans {n} processes (data x seq x model on "
            "a world above 1, data x model on one) but the "
            f"world size is {world}: launch one process per card, e.g. "
            f"torchrun --nproc-per-node {n}, and call "
            "flexflow_tpu_torch.runtime.distributed.initialize()")


def canonical_axes(axes: Dict[str, int]) -> Dict[str, int]:
    """`axes` in the canonical axis order (unknown names after the known
    ones, in their given order): the order of a mesh's devices, which the
    search's machine models read to tell which groups leave a node."""
    names = [n for n in AXIS_ORDER if n in axes]
    names += [n for n in axes if n not in names]
    return {n: axes[n] for n in names}


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """A Mesh with the canonical axis order. Size-1 axes are kept, as the
    reference keeps them."""
    check_axes(axes)
    check_world(axes)
    ordered = canonical_axes(axes)
    return Mesh(tuple(ordered), tuple(ordered.values()))


def mesh_axis_size(mesh: Optional[Mesh], name: str) -> int:
    """The size of axis `name`, 1 without a mesh or without that axis
    (flexflow_tpu/parallel/ring.py:27)."""
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.axes[name]
