"""Parallel operators: first-class PCG resharding nodes (counterpart of
flexflow_tpu/parallel/parallel_ops.py).

  Repartition(dim, axes)   partition a dim over mesh axes
  Combine(dim)             unpartition a dim (all-gather)
  Replicate()              broadcast forward, sum of gradients backward
  Reduction()              all-reduce of a partial sum
  AllToAll(src, dst)       move the cut from one dim to another (Ulysses)
  FusedParallelOp(steps)   a chain of the above as one node

The strategy search inserts and prices them (search/substitution.py,
search/cost_model.py). None of them changes a tensor's value, only where
its pieces live. On a process mesh (the `data` and `model` axes, one
process per card) each lays its input out as the reference's lowering
constrains it, with real collectives (parallel/shard_rules.py: a cut is
a local slice, a gather an all-gather, a moved cut an all-to-all; their
backwards in parallel/spmd.py). In one process every piece of every axis
but `seq` is the one piece, and every `seq` piece lives in that process,
so the lowering below passes its input on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpAttrs, elementwise_like
from flexflow_tpu_torch.ops.registry import register_lowering
from flexflow_tpu_torch.parallel.sharding import Spec
from flexflow_tpu_torch.pcg.tensor import ParallelDim, ParallelTensorShape


@dataclasses.dataclass(frozen=True)
class RepartitionAttrs(OpAttrs):
    """Partition `dim` over mesh axes `axes` (reference partition.cc)."""

    dim: int
    axes: Tuple[str, ...]

    def infer(self, x: ParallelTensorShape):
        dims = list(x.dims)
        dims[self.dim] = ParallelDim(dims[self.dim].size, dims[self.dim].degree, self.axes)
        return (dataclasses.replace(x, dims=tuple(dims)),)

    def spec(self, ndim: int) -> Spec:
        return tuple(self.axes if i == self.dim else () for i in range(ndim))


@dataclasses.dataclass(frozen=True)
class CombineAttrs(OpAttrs):
    """Unpartition `dim` (reference combine.cc: fwd gather, bwd scatter).
    `axes` names the mesh axes being gathered (for the cost model)."""

    dim: int
    axes: Tuple[str, ...] = ()

    def infer(self, x: ParallelTensorShape):
        dims = list(x.dims)
        dims[self.dim] = ParallelDim(dims[self.dim].size)
        return (dataclasses.replace(x, dims=tuple(dims)),)


@dataclasses.dataclass(frozen=True)
class ReplicateAttrs(OpAttrs):
    """Replicate over `axes` (reference replicate.cc). Forward broadcast;
    grad-psum over the replica axes is emitted by the partitioner."""

    axes: Tuple[str, ...] = ()

    def infer(self, x: ParallelTensorShape):
        return (elementwise_like(x),)


@dataclasses.dataclass(frozen=True)
class ReductionAttrs(OpAttrs):
    """Sum partial results (reference reduction.cc) — lowers to an
    all-reduce placed where this node sits; output fully replicated unless
    `out_spec` re-shards it (reduce-scatter). `axes` names the mesh axes
    being reduced over (for the cost model)."""

    out_spec: Optional[Spec] = None
    axes: Tuple[str, ...] = ()

    def infer(self, x: ParallelTensorShape):
        return (elementwise_like(x),)


@dataclasses.dataclass(frozen=True)
class FusedParallelOpAttrs(OpAttrs):
    """A chain of parallel-op steps fused into ONE resharding node
    (reference src/parallel_ops/fused_parallel_op.cc; fusion enabled by
    SimplificationSettings.fuse_parallel_ops, substitution.cc:1924). Each
    step is (kind, dim, axes) with kind in repartition|combine|replicate|
    reduction|all_to_all. On TPU the whole chain is a single sharding
    constraint — XLA emits one fused collective where possible — and the
    cost model prices the steps with a single latency term."""

    steps: Tuple[Tuple[str, int, Tuple[str, ...]], ...]

    def infer(self, x: ParallelTensorShape):
        dims = list(x.dims)
        for kind, dim, axes in self.steps:
            if kind == "repartition":
                dims[dim] = ParallelDim(dims[dim].size, dims[dim].degree,
                                        tuple(axes))
            elif kind in ("combine", "reduction", "replicate"):
                if 0 <= dim < len(dims):
                    dims[dim] = ParallelDim(dims[dim].size)
            elif kind == "all_to_all":
                dims[dim] = ParallelDim(dims[dim].size, dims[dim].degree,
                                        tuple(axes))
        return (dataclasses.replace(x, dims=tuple(dims)),)

    def final_spec(self, ndim: int) -> Spec:
        spec = [()] * ndim
        for kind, dim, axes in self.steps:
            if kind in ("repartition", "all_to_all") and 0 <= dim < ndim:
                spec[dim] = tuple(axes)
            elif kind in ("combine", "reduction", "replicate") and 0 <= dim < ndim:
                spec[dim] = ()
        return tuple(spec)


@dataclasses.dataclass(frozen=True)
class AllToAllAttrs(OpAttrs):
    """Move sharding from `src_dim` to `dst_dim` (Ulysses sequence<->head
    exchange; net-new vs reference, whose closest analog is
    FusedParallelOp)."""

    src_dim: int
    dst_dim: int
    axes: Tuple[str, ...]

    def infer(self, x: ParallelTensorShape):
        dims = list(x.dims)
        dims[self.src_dim] = ParallelDim(dims[self.src_dim].size)
        dims[self.dst_dim] = ParallelDim(
            dims[self.dst_dim].size, dims[self.dst_dim].degree, self.axes
        )
        return (dataclasses.replace(x, dims=tuple(dims)),)


def _reshard(attrs, inputs, params, ctx):
    """The identity in one process, where every piece of a `seq` axis and
    the only piece of every other axis live (a process mesh lays such
    values out in parallel/shard_rules.py instead)."""
    return [inputs[0]]


for _op in (OpType.REPARTITION, OpType.COMBINE, OpType.REPLICATE,
            OpType.REDUCTION, OpType.ALL_TO_ALL, OpType.FUSED_PARALLEL):
    register_lowering(_op)(_reshard)
