"""Lowering registry: OpType -> PyTorch lowering function (counterpart of
flexflow_tpu/ops/registry.py).

A lowering has signature `fn(attrs, inputs, params, ctx) -> list[Tensor]`
where `params` is the op's weight dict and `ctx` a LowerCtx. The executor
calls them eagerly, node by node, in topological order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from flexflow_tpu_torch.ffconst import OpType

_MASK64 = (1 << 64) - 1


def node_seed(stream: Tuple[int, int], node_guid: int) -> int:
    """The seed of one node's random draws in one training step: (fit
    stream, step, node guid) mixed by splitmix64's finaliser, so a node's
    draw never depends on how many other nodes drew before it (the
    reference folds the guid into the step's key, jax.random.fold_in)."""
    h = 0
    for v in (*stream, node_guid):
        h = ((h ^ (int(v) & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


@dataclasses.dataclass
class LowerCtx:
    """Per-call lowering context: the device the step runs on and the
    mesh (parallel/mesh.py), whose `seq` axis cuts ring attention."""

    device: Optional[torch.device] = None
    mesh: Optional[Any] = None
    # the process mesh (parallel/spmd.ProcessMesh) a rank's pieces run
    # on, None in one process: ring attention reads its `seq` axis
    pmesh: Optional[Any] = None
    training: bool = False
    # FFConfig.seq_length, the iteration-config truncation
    seq_length: Optional[int] = None
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
    # the load-balance term an MoE lowering adds to the training loss
    # (EXPERTS, and AGGREGATE with lambda_bal > 0, in training); the
    # executor sums them over the graph
    aux_loss: Optional[torch.Tensor] = None
    # this node's random stream in a training step (node_seed), None
    # outside training: eval and predict draw nothing
    rng_seed: Optional[int] = None
    # non-trainable weights the lowering moves (BatchNorm's running
    # statistics), merged into the non-trainable tree by the train step
    state_updates: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def generator(self, device) -> torch.Generator:
        """A torch.Generator on `device` seeded from `rng_seed`, fresh at
        every call: a forward recomputed under torch.utils.checkpoint
        (which restores only the global RNG state) draws the same mask
        as the first one."""
        if self.rng_seed is None:
            raise RuntimeError(
                "this lowering draws random numbers but the call has no "
                "random stream: only a training step (Executor.run_forward"
                "(training=True)) draws")
        gen = torch.Generator(device=device)
        gen.manual_seed(self.rng_seed)
        return gen


_LOWERINGS: Dict[OpType, Callable] = {}


def register_lowering(op_type: OpType):
    def deco(fn):
        _LOWERINGS[op_type] = fn
        return fn

    return deco


def get_lowering(op_type: OpType) -> Callable:
    # importing the op library and the parallel ops populates the
    # registry on first use
    from flexflow_tpu_torch.ops import torch_ops  # noqa: F401
    from flexflow_tpu_torch.parallel import parallel_ops  # noqa: F401

    if op_type not in _LOWERINGS:
        raise NotImplementedError(
            f"{op_type} has no lowering: it is not an executable node, in "
            "the JAX package either")
    return _LOWERINGS[op_type]
