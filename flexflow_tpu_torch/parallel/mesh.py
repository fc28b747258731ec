"""The device mesh (counterpart of flexflow_tpu/parallel/mesh.py).

The reference lays a `jax.sharding.Mesh` of named axes over its devices.
The port runs on one device: its `Mesh` names the axes and their sizes,
and every position of every axis lives on that device. Only the `seq`
axis may exceed 1: its positions are the shards of ring attention
(parallel/ring.py), which one process holds and rotates as block
references. One process per card (`torch.distributed`) and the data and
model axes are ROADMAP.md, queue 1 item 12.

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
# the axes a one-device mesh can hold above size 1
SINGLE_DEVICE_AXES = ("seq",)


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
    """Refuse sizes below 1 and any axis but `seq` above 1: the port holds
    no other axis yet, and never ignores one."""
    for name, size in axes.items():
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"mesh axis {name!r} must have a positive int "
                             f"size, got {size!r}")
        if size > 1 and name not in SINGLE_DEVICE_AXES:
            raise NotImplementedError(
                f"mesh axis {name!r} of size {size}: only 'seq' may exceed "
                "1 on one device; data, model, expert and pipeline axes "
                "across cards are not ported yet (ROADMAP.md, queue 1 item "
                "12)")


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """A Mesh with the canonical axis order (unknown names after the
    known ones, in their given order). Size-1 axes are kept, as the
    reference keeps them."""
    check_axes(axes)
    names = [n for n in AXIS_ORDER if n in axes]
    names += [n for n in axes if n not in names]
    return Mesh(tuple(names), tuple(axes[n] for n in names))


def mesh_axis_size(mesh: Optional[Mesh], name: str) -> int:
    """The size of axis `name`, 1 without a mesh or without that axis
    (flexflow_tpu/parallel/ring.py:27)."""
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.axes[name]
