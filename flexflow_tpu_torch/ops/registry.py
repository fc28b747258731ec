"""Lowering registry: OpType -> PyTorch lowering function (counterpart of
flexflow_tpu/ops/registry.py).

A lowering has signature `fn(attrs, inputs, params, ctx) -> list[Tensor]`
where `params` is the op's weight dict and `ctx` a LowerCtx. The executor
calls them eagerly, node by node, in topological order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from flexflow_tpu_torch.ffconst import OpType


@dataclasses.dataclass
class LowerCtx:
    """Per-call lowering context. Where the JAX package carries a device
    mesh, the port carries the device the step runs on."""

    device: Optional[torch.device] = None
    training: bool = False
    node_guid: int = 0
    # paged KV cache: kv_cache is THIS attention node's {"k", "v"} pool,
    # (num_pages, page_size, Hkv, D); page_tables maps each batch entry's
    # cache rows onto pool pages ((B, max_pages) int32); cache_position is
    # the (B,) write head
    kv_cache: Optional[dict] = None
    cache_position: Optional[torch.Tensor] = None
    page_tables: Optional[torch.Tensor] = None
    # the ragged work descriptor (paged/attention.py): (B,) live query
    # rows, (B, S) rope depths relative to cache_position, and the
    # (B, S, S) bool window visibility
    ragged_q_lens: Optional[torch.Tensor] = None
    ragged_depths: Optional[torch.Tensor] = None
    ragged_anc: Optional[torch.Tensor] = None
    cache_updates: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)


_LOWERINGS: Dict[OpType, Callable] = {}


def register_lowering(op_type: OpType):
    def deco(fn):
        _LOWERINGS[op_type] = fn
        return fn

    return deco


def get_lowering(op_type: OpType) -> Callable:
    # importing the op library populates the registry on first use
    from flexflow_tpu_torch.ops import torch_ops  # noqa: F401

    if op_type not in _LOWERINGS:
        raise NotImplementedError(
            f"no PyTorch lowering for {op_type} yet (ROADMAP.md, queue 1)")
    return _LOWERINGS[op_type]
