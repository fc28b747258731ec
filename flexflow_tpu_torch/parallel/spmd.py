"""One process per card: the process mesh, its collectives and the layout
of a sharded value (the port's counterpart of GSPMD's NamedSharding and
the collectives XLA inserts for it).

Every rank runs the same program on its own shards. A value's layout is a
`Spec` (parallel/sharding.py): for each dim, the mesh axes that cut it,
the first axis major, as a PartitionSpec names them. A rank holds the
piece its coordinates pick; a dim with no axes is whole on every rank.

Gradients follow one rule (Megatron's): the gradient a rank holds for a
value replicated over an axis is the FULL gradient of that value, the same
on every rank of the axis. The collectives below are autograd Functions
that keep the rule:

  all_gather   shard -> whole        backward: this rank's slice
  split        whole -> shard        backward: all-gather
  all_reduce   partial -> whole      backward: identity      (Megatron's g)
  copy_to      whole, used in a computation cut over an axis:
               identity forward      backward: all-reduce    (Megatron's f)
  all_to_all   move the cut from one dim to another, and back in backward
  scale_grad   identity forward      backward: times a constant

The parameters are the one exception, kept for the optimizer: a parameter
replicated over `data` (or `seq`) and used on activations cut over it
holds the partial gradient of its rank's rows (or tokens), and the train
step reduces it over `data` and `seq` (an all-reduce, or under ZeRO-1 a
reduce-scatter).

`ring_shift` is the ring's hop over `seq` (ops/ring_flash.py): rank j of
a `seq` group sends to j + 1 and receives from j - 1, every send and its
receive posted together, so no rank waits on another's order.

The gloo backend moves CPU tensors; a CUDA tensor under gloo (several
ranks on one card, which NCCL refuses) is staged through the host by
`_stage`, on purpose and for every collective alike. NCCL takes CUDA
tensors as they are.
"""

from __future__ import annotations

import copy
import itertools
import math
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from flexflow_tpu_torch.parallel.mesh import process_axes

Spec = Tuple[Tuple[str, ...], ...]


def replicated(ndim: int) -> Spec:
    return tuple(() for _ in range(ndim))


class ProcessMesh:
    """The process axes (mesh.process_axes: `data`, `seq`, `model`) over
    the world's ranks, in the canonical axis order (the last axis varies
    fastest over the ranks, so `model` groups are neighbouring ranks and
    `seq` groups the next stride). Builds one process group for
    every set of axes and every position of the others, on every rank, in
    the same order (torch.distributed.new_group's contract), with the
    timeout initialize() gave the process group."""

    def __init__(self, axes: Dict[str, int]):
        from flexflow_tpu_torch.runtime.distributed import (
            collective_timeout_s,
        )

        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh over several processes needs torch.distributed: "
                "call flexflow_tpu_torch.runtime.distributed.initialize() "
                "first (torchrun sets its environment)")
        self.names = process_axes(axes, dist.get_world_size())
        self.sizes = {n: axes[n] for n in self.names}
        world = math.prod(self.sizes.values())
        if world != dist.get_world_size():
            raise ValueError(
                f"mesh {dict(axes)} spans {world} processes but the process "
                f"group's world size is {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        # this rank's position on each axis (row-major over self.names)
        rem, self.coords = self.rank, {}
        for n in reversed(self.names):
            self.coords[n] = rem % self.sizes[n]
            rem //= self.sizes[n]
        self.groups: Dict[Tuple[str, ...], object] = {}
        shape = tuple(self.sizes[n] for n in self.names)
        timeout = timedelta(seconds=collective_timeout_s())
        for r in range(1, len(self.names) + 1):
            for subset in itertools.combinations(self.names, r):
                others = [n for n in self.names if n not in subset]
                for fixed in itertools.product(
                        *(range(self.sizes[n]) for n in others)):
                    pos = dict(zip(others, fixed))
                    ranks = []
                    for idx in itertools.product(*(range(s) for s in shape)):
                        c = dict(zip(self.names, idx))
                        if all(c[n] == pos[n] for n in others):
                            ranks.append(self._rank_of(c))
                    g = dist.new_group(sorted(ranks), timeout=timeout)
                    if all(self.coords[n] == pos[n] for n in others):
                        self.groups[subset] = g

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for n in self.names:
            r = r * self.sizes[n] + coords[n]
        return r

    def without(self, axes: Sequence[str]) -> "ProcessMesh":
        """This mesh with `axes` taken out of its names: a layout that
        cuts a dim over one of them reads as whole, and collectives run
        in the groups of the others (which this rank shares with the
        ranks at its own positions on `axes`). Decode runs so, replicated
        over `seq`."""
        other = copy.copy(self)
        other.names = tuple(n for n in self.names if n not in axes)
        other.sizes = {n: self.sizes[n] for n in other.names}
        other.coords = {n: self.coords[n] for n in other.names}
        return other

    def live(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """`axes` without those the process mesh lacks or holds at 1, in
        mesh order (the order a group is keyed by)."""
        return tuple(n for n in self.names if n in axes)

    def keep(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """`axes` without those the process mesh lacks, in their own
        order (the order that says which shard a rank holds)."""
        return tuple(a for a in axes if a in self.sizes)

    def degree(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's shard index for a dim cut over `axes` (the first
        axis major)."""
        i = 0
        for a in axes:
            if a in self.sizes:
                i = i * self.sizes[a] + self.coords[a]
        return i

    def group_ranks_order(self, axes: Sequence[str]) -> bool:
        """True when the ranks of a group over `axes`, sorted, list the
        shards in `axes` order (all_gather returns rank order)."""
        return list(self.live(axes)) == [a for a in axes if a in self.sizes]

    # -- plain collectives (no autograd) ------------------------------

    def all_reduce(self, x: torch.Tensor, axes, op=dist.ReduceOp.SUM,
                   inplace: bool = False):
        """The reduction of `x` over the ranks of `axes`. With `inplace`
        the collective may overwrite `x` (a tensor the caller owns, such
        as a gradient); otherwise `x` is left as it was, which an
        autograd forward needs of its input."""
        axes = self.live(axes)
        if not axes:
            return x
        buf, back = _stage(x.contiguous(), self.backend)
        if buf is x and not inplace:
            buf = buf.clone()
        dist.all_reduce(buf, op=op, group=self.groups[axes])
        return back(buf)

    def all_gather(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """Concatenate every rank's `x` along `dim`, shards in `axes`
        order."""
        if not self.live(axes):
            return x
        if not self.group_ranks_order(axes):
            raise ValueError(f"axes {axes} out of mesh order {self.names}")
        axes = self.live(axes)
        n = self.degree(axes)
        buf, back = _stage(x.movedim(dim, 0).contiguous(), self.backend)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=self.groups[axes])
        return back(torch.cat(parts, 0)).movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """The sum over the ranks of `axes`, each keeping its slice of
        `dim`."""
        if not self.live(axes):
            return x
        if not self.group_ranks_order(axes):
            raise ValueError(f"axes {axes} out of mesh order {self.names}")
        axes = self.live(axes)
        n = self.degree(axes)
        buf, back = _stage(x.movedim(dim, 0).contiguous(), self.backend)
        out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]),
                          dtype=buf.dtype, device=buf.device)
        # reduce_scatter_single is reduce_scatter_tensor's newer name
        fn = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        fn(out, buf, group=self.groups[axes])
        return back(out).movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, split_dim: int, cat_dim: int,
                   axes) -> torch.Tensor:
        """Cut `split_dim` into the group's pieces, send piece j to shard
        j, and concatenate what arrives along `cat_dim`."""
        if not self.live(axes):
            return x
        if not self.group_ranks_order(axes):
            raise ValueError(f"axes {axes} out of mesh order {self.names}")
        axes = self.live(axes)
        n = self.degree(axes)
        pieces = torch.stack(torch.chunk(x, n, dim=split_dim)).contiguous()
        buf, back = _stage(pieces, self.backend)
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self.groups[axes])
        return torch.cat(list(back(out).unbind(0)), dim=cat_dim)

    def ring_shift(self, tensors: Sequence[torch.Tensor], axis: str
                   ) -> list:
        """One hop of the ring over `axis`: this rank's `tensors` go to
        the next position (j -> j + 1 mod n) and the previous position's
        arrive, in one dist.batch_isend_irecv, so a send and its receive
        never wait on each other. Ranks come from dist.get_global_rank
        on the axis's group (its group rank is the position: the
        group's ranks, sorted, list the positions in order). Under gloo
        CUDA tensors go through the host, as every collective here."""
        group = self.groups[(axis,)]
        n, j = self.sizes[axis], self.coords[axis]
        nxt = dist.get_global_rank(group, (j + 1) % n)
        prv = dist.get_global_rank(group, (j - 1) % n)
        ops, bufs, backs = [], [], []
        for i, t in enumerate(tensors):
            buf, back = _stage(t.contiguous(), self.backend)
            got = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.isend, buf, nxt, group, tag=i))
            ops.append(dist.P2POp(dist.irecv, got, prv, group, tag=i))
            bufs.append(got)
            backs.append(back)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [back(b) for back, b in zip(backs, bufs)]

    # -- shards of whole tensors (no autograd) --------------------------

    def shard(self, full: torch.Tensor, spec: Optional[Spec]):
        """This rank's piece of a whole tensor."""
        if spec is None:
            return full
        out = full
        for d, axes in enumerate(_pad(spec, full.ndim)):
            axes = self.live(axes)
            if axes:
                n = self.degree(axes)
                out = out.narrow(d, self.index(axes) * (out.shape[d] // n),
                                 out.shape[d] // n)
        return out

    def gather(self, local: torch.Tensor, spec: Optional[Spec]):
        """The whole tensor from every rank's piece."""
        if spec is None:
            return local
        out = local
        for d, axes in enumerate(_pad(spec, local.ndim)):
            if self.live(axes):
                out = self.all_gather(out, d, axes)
        return out


def _pad(spec: Spec, ndim: int) -> Spec:
    spec = tuple(tuple(a) for a in spec)[:ndim]
    return spec + replicated(ndim - len(spec))


def _stage(x: torch.Tensor, backend: str):
    """(buffer the backend takes, function that brings a result back):
    under gloo a CUDA tensor goes through host memory."""
    if backend == "gloo" and x.is_cuda:
        dev = x.device
        return x.cpu(), lambda t: t.to(dev)
    return x, lambda t: t


# ---------------------------------------------------------------------------
# autograd collectives


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pm, dim, axes):
        ctx.pm, ctx.dim, ctx.axes = pm, dim, axes
        return pm.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.pm, ctx.dim, ctx.axes), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pm, dim, axes):
        ctx.pm, ctx.dim, ctx.axes = pm, dim, axes
        return _slice(x, pm, dim, axes).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.pm.all_gather(g, ctx.dim, ctx.axes), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pm, axes):
        return pm.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pm, axes):
        ctx.pm, ctx.axes = pm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.pm.all_reduce(g, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pm, src, dst, axes):
        ctx.pm, ctx.src, ctx.dst, ctx.axes = pm, src, dst, axes
        return pm.all_to_all(x, dst, src, axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.pm.all_to_all(g, ctx.src, ctx.dst, ctx.axes),
                None, None, None, None)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _slice(x, pm, dim, axes):
    n = pm.degree(pm.live(axes))
    size = x.shape[dim] // n
    return x.narrow(dim, pm.index(axes) * size, size)


def all_gather(x, pm: ProcessMesh, dim: int, axes):
    return _AllGather.apply(x, pm, dim, tuple(axes)) if pm.live(axes) else x


def split(x, pm: ProcessMesh, dim: int, axes):
    return _Split.apply(x, pm, dim, tuple(axes)) if pm.live(axes) else x


def all_reduce(x, pm: ProcessMesh, axes):
    return _AllReduce.apply(x, pm, tuple(axes)) if pm.live(axes) else x


def copy_to(x, pm: ProcessMesh, axes):
    return _CopyTo.apply(x, pm, tuple(axes)) if pm.live(axes) else x


def all_to_all(x, pm: ProcessMesh, src: int, dst: int, axes):
    return (_AllToAll.apply(x, pm, src, dst, tuple(axes))
            if pm.live(axes) else x)


def scale_grad(x, s: float):
    return _ScaleGrad.apply(x, s) if s != 1.0 else x


def sharded_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for axes in spec for a in axes)


def redistribute(x: torch.Tensor, pm: ProcessMesh, src: Spec,
                 dst: Spec) -> torch.Tensor:
    """`x`, laid out as `src`, laid out as `dst`: a cut that moves whole
    from one dim to another is one all-to-all; otherwise every dim whose
    axes change is gathered, then cut."""
    src = tuple(pm.keep(a) for a in _pad(src, x.ndim))
    dst = tuple(pm.keep(a) for a in _pad(dst, x.ndim))
    if src == dst:
        return x
    changed = [d for d in range(x.ndim) if src[d] != dst[d]]
    if len(changed) == 2:
        a, b = changed
        if not src[b] and not dst[a] and src[a] == dst[b]:
            return all_to_all(x, pm, a, b, src[a])
        if not src[a] and not dst[b] and src[b] == dst[a]:
            return all_to_all(x, pm, b, a, src[b])
    for d in changed:
        if src[d]:
            x = all_gather(x, pm, d, src[d])
    for d in changed:
        if dst[d]:
            x = split(x, pm, d, dst[d])
    return x
