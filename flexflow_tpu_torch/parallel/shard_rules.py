"""Each op on its shards (the port's counterpart of GSPMD's partitioning
of the reference's traced step).

A rule looks at a node, the layouts its inputs arrive in and the layouts
its weights are stored in, and returns a `Plan`: the layouts it computes
in, a function over this rank's pieces, and the layouts of its outputs.
`run_node` redistributes the operands to the plan's layouts, applies the
gradient rule of parallel/spmd.py, runs the plan and returns the outputs
with their layouts; the executor then lays each output out as its view
says (the reference's with_sharding_constraint).

  - LINEAR: column-parallel (kernel cut on its output dim: no collective)
    and row-parallel (cut on its input dim: the partial products are
    all-reduced, then the bias and the activation apply).
  - EMBEDDING: a table cut on its width gives a cut output; cut on the
    vocabulary, each rank looks up the ids it owns and the rows are
    all-reduced.
  - MULTIHEAD_ATTENTION: heads cut over an axis (wq/wk/wv on their head
    dim, wo on its first): each rank runs the one-card lowering on its
    local heads (H/m and Hkv/m; K1/K2 or K4 on the card, as on one card),
    the output projection's partial sums are all-reduced, then `bo`. The
    sequence is whole. In a decode step (a dense KV cache) the rank's
    cache holds its rows and its kv heads.
  - RING_ATTENTION: the same, and when `seq` is a process axis the
    inputs and the output are cut on the sequence (dim 1) over it: the
    ring or Ulysses runs between the ranks (parallel/ring.py). kv heads
    that do not split over the head cut stay whole, and each rank
    projects the kv head of each of its q heads (the reference's
    ring_repeats_kv repeat), whether or not `seq` is a process axis.
  - element-wise ops, the norms and softmax keep their input's layout,
    whole on the dims they reduce over.
  - per-row ops (LSTM, convolution, pooling, shape ops that keep dim 0)
    keep dim 0's cut and take everything else whole.
  - the parallel ops (REPARTITION, COMBINE, ...) lay their input out as
    the reference's lowering constrains it.
  - anything else runs whole on every rank (inputs gathered, weights
    gathered) and its outputs are cut by their views: dropout's masks and
    BatchNorm's batch statistics are then the one-card ones.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from flexflow_tpu_torch.ffconst import AggrMode, OpType
from flexflow_tpu_torch.ops.registry import get_lowering
from flexflow_tpu_torch.parallel import spmd
from flexflow_tpu_torch.parallel.spmd import Spec, replicated

DATA, SEQ = "data", "seq"
# the axes over which a parameter's gradient is left partial, for the
# train step to reduce: a rank's rows (`data`) or tokens (`seq`)
GRAD_AXES = (DATA, SEQ)

_PARALLEL_OPS = (OpType.REPARTITION, OpType.COMBINE, OpType.REPLICATE,
                 OpType.REDUCTION, OpType.ALL_TO_ALL, OpType.FUSED_PARALLEL)
# ops computed row by row along dim 0 (with conditions on their attrs in
# _batch_local)
_PER_ROW = (OpType.LSTM, OpType.CONV2D, OpType.POOL2D, OpType.FLAT,
            OpType.RESHAPE, OpType.TRANSPOSE, OpType.REVERSE, OpType.CONCAT,
            OpType.SPLIT, OpType.BATCH_MATMUL, OpType.REDUCE_SUM,
            OpType.MEAN, OpType.TOPK, OpType.NOOP)


@dataclasses.dataclass
class Plan:
    in_specs: List[Spec]
    w_specs: Dict[str, Spec]
    out_specs: List[Spec]
    compute: Callable
    # weights used after the plan's own reduction over `reduced`
    post: Tuple[str, ...] = ()
    reduced: Tuple[str, ...] = ()


def _without(spec: Spec, axes) -> Spec:
    return tuple(tuple(a for a in d if a not in axes) for d in spec)


def _whole_dims(spec: Spec, dims) -> Spec:
    return tuple(() if i in dims else d for i, d in enumerate(spec))


def _full_shape(node, i=0):
    return tuple(d.size for d in node.outputs[i].dims)


def _lower(node, ctx, attrs=None):
    fn = get_lowering(node.op_type)
    a = node.attrs if attrs is None else attrs
    return lambda ins, params: fn(a, ins, params, ctx)


def whole_plan(node, in_shapes, w_shapes, ctx) -> Plan:
    """Every operand whole, every output whole."""
    return Plan([replicated(len(s)) for s in in_shapes],
                {k: replicated(len(s)) for k, s in w_shapes.items()},
                [replicated(len(o.dims)) for o in node.outputs],
                _lower(node, ctx))


def _batch_local(node, in_shapes) -> bool:
    a = node.attrs
    t = node.op_type
    nd = len(in_shapes[0]) if in_shapes else 1
    if t == OpType.TRANSPOSE:
        return a.perm[0] == 0
    if t in (OpType.REVERSE, OpType.CONCAT, OpType.SPLIT):
        return a.axis % nd != 0
    if t in (OpType.REDUCE_SUM, OpType.MEAN):
        return all(x % nd != 0 for x in a.axes)
    return True


def per_row_plan(node, in_layouts, in_shapes, w_shapes, pm, ctx) -> Plan:
    """Dim 0 keeps the cut of input 0's dim 0 on every operand and output
    that has the batch as dim 0; everything else whole."""
    b = in_shapes[0][0] if in_shapes and in_shapes[0] else None
    axes0 = tuple(in_layouts[0][0]) if in_shapes and in_shapes[0] else ()

    def spec(shape):
        s = replicated(len(shape))
        if shape and shape[0] == b and axes0:
            s = ((axes0,) + s[1:])
        return s

    outs = [spec(tuple(d.size for d in o.dims)) for o in node.outputs]
    attrs = None
    if node.op_type == OpType.RESHAPE:
        shape = tuple(node.attrs.shape)
        if not axes0 or not shape or shape[0] != b:
            return whole_plan(node, in_shapes, w_shapes, ctx)
        attrs = dataclasses.replace(
            node.attrs, shape=(b // pm.degree(axes0),) + shape[1:])
    return Plan([spec(s) for s in in_shapes],
                {k: replicated(len(s)) for k, s in w_shapes.items()},
                outs, _lower(node, ctx, attrs))


def keep_plan(node, in_layouts, in_shapes, w_shapes, ctx, whole_dims
              ) -> Plan:
    """Input 0's layout, whole on `whole_dims`, for the input and the
    output (element-wise ops, the norms, softmax)."""
    nd = len(in_shapes[0])
    s = _whole_dims(tuple(in_layouts[0]), {d % nd for d in whole_dims})
    return Plan([s], {k: replicated(len(v)) for k, v in w_shapes.items()},
                [s] * len(node.outputs), _lower(node, ctx))


def binary_plan(node, in_layouts, in_shapes, w_shapes, ctx) -> Plan:
    out = _full_shape(node)
    a, b = in_shapes
    if node.attrs.position_table:
        # b is the (rows, width) table its positions index: rows whole,
        # the width cut as a's
        s = _whole_dims(tuple(in_layouts[0]), set())
        return Plan([s, ((),) + (s[-1],)], {}, [s], _lower(node, ctx))
    lead = [i for i, sh in enumerate(in_shapes) if tuple(sh) == out]
    if not lead:
        return whole_plan(node, in_shapes, w_shapes, ctx)
    # the leader is the input already cut most
    li = max(lead, key=lambda i: len(spmd.sharded_axes(in_layouts[i])))
    s = tuple(in_layouts[li])
    specs = []
    for sh in in_shapes:
        k = len(sh)
        sub = s[len(s) - k:] if k else ()
        specs.append(tuple(d if sh[i] == out[len(out) - k + i] else ()
                           for i, d in enumerate(sub)))
    return Plan(specs, {}, [s], _lower(node, ctx))


def linear_plan(node, in_layouts, in_shapes, w_layouts, pm, ctx) -> Plan:
    kin, kout = (tuple(x) for x in w_layouts["kernel"])
    used = set(kin) | set(kout)
    x = _without(tuple(in_layouts[0]), used)[:-1] + (kin,)
    attrs = node.attrs
    w = {"kernel": (kin, kout)}
    if attrs.use_bias:
        w["bias"] = (kout,)

    def compute(ins, params):
        from flexflow_tpu_torch.ops.torch_ops import apply_activation

        (xx,) = ins
        y = torch.matmul(xx, params["kernel"].to(xx.dtype))
        y = spmd.all_reduce(y, pm, kin)
        if attrs.use_bias:
            y = y + params["bias"].to(xx.dtype)
        return [apply_activation(y, attrs.activation)]

    return Plan([x], w, [x[:-1] + (kout,)], compute,
                post=("bias",) if kin else (), reduced=kin)


def embedding_plan(node, in_layouts, in_shapes, w_layouts, pm, ctx) -> Plan:
    v_ax, e_ax = (tuple(x) for x in w_layouts["kernel"])
    attrs = node.attrs
    ids = _without(tuple(in_layouts[0]), set(v_ax) | set(e_ax))
    if attrs.aggr != AggrMode.NONE:
        ids = ids[:-1] + ((),)
        out = ids[:-1] + (e_ax,)
    else:
        out = ids + (e_ax,)
    if not v_ax:
        return Plan([ids], {"kernel": (v_ax, e_ax)}, [out],
                    _lower(node, ctx))

    def compute(ins, params):
        (ii,) = ins
        table = params["kernel"]
        n = table.shape[0]
        local = ii.long() - pm.index(v_ax) * n
        own = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)] * own[..., None].to(table.dtype)
        if attrs.aggr == AggrMode.SUM:
            rows = rows.sum(dim=-2)
        elif attrs.aggr == AggrMode.AVG:
            rows = rows.mean(dim=-2)
        return [spmd.all_reduce(rows, pm, v_ax).to(attrs.dtype.torch_dtype)]

    return Plan([ids], {"kernel": (v_ax, e_ax)}, [out], compute,
                reduced=v_ax)


def attention_plan(node, in_layouts, in_shapes, w_layouts, pm, ctx,
                   remat: bool) -> Plan:
    from flexflow_tpu_torch.parallel.comm_spec import ring_repeats_kv

    attrs = node.attrs
    wq = tuple(tuple(x) for x in w_layouts["wq"])
    heads = wq[1]
    if wq[0] or wq[2]:
        raise NotImplementedError(
            f"{node.name}: attention weights cut on the model width or the "
            "head dim; the port cuts attention on its heads only")
    ring = node.op_type == OpType.RING_ATTENTION and ctx.kv_cache is None
    # the reference's repeat rule (ring_repeats_kv): kv heads that do not
    # split over the head cut stay whole (wk and wv uncut), and each rank
    # projects the kv head of each of its q heads (_rank_kv)
    kv_whole = ring and bool(heads) and ring_repeats_kv(
        attrs.num_heads, attrs.num_kv, pm.degree(heads))
    if heads:
        m = pm.degree(heads)
        if attrs.num_heads % m or (attrs.num_kv % m and not kv_whole):
            raise ValueError(
                f"{node.name}: {attrs.num_heads} heads / {attrs.num_kv} kv "
                f"heads do not split over {heads} of degree {m}: a model "
                "degree must divide the kv heads (ring attention's kv heads "
                "stay whole when they do not split; decode and plain "
                "attention need them cut)")
    kvh = () if kv_whole else heads
    w = {"wq": ((), heads, ()), "wk": ((), kvh, ()),
         "wv": ((), kvh, ()), "wo": (heads, (), ())}
    if attrs.use_bias:
        w.update(bq=(heads, ()), bk=(kvh, ()), bv=(kvh, ()), bo=((),))
    # the sequence: cut over `seq` when the ring or Ulysses runs between
    # the ranks, whole otherwise
    seq = pm.live((SEQ,)) if ring else ()
    xs = []
    for lay, shape in zip(in_layouts, in_shapes):
        x = _without(tuple(lay), set(heads) | {SEQ})[:-1] + ((),)
        if seq:
            if shape[1] % pm.degree(seq):
                raise ValueError(
                    f"{node.name}: sequence {shape[1]} does not split over "
                    f"the {pm.degree(seq)} positions of mesh axis 'seq'")
            x = (x[0], seq) + x[2:]
        xs.append(x)
    lower = get_lowering(node.op_type)

    def local(*args):
        ins = list(args[:len(xs)])
        params = dict(zip(names, args[len(xs):]))
        if attrs.use_bias:
            params["bo"] = torch.zeros_like(params["bo"])
        return lower(attrs, ins, params, ctx)[0]

    names = list(w)

    def compute(ins, params):
        if kv_whole:
            params = dict(params, **_rank_kv(params, heads, pm,
                                             attrs.num_heads, attrs.num_kv))
        args = list(ins) + [params[k] for k in names]
        if remat:
            y = checkpoint(local, *args, use_reentrant=False)
        else:
            y = local(*args)
        y = spmd.all_reduce(y, pm, heads)
        if attrs.use_bias:
            y = y + params["bo"].to(y.dtype)
        return [y]

    return Plan(xs, w, [xs[0]], compute, post=("bo",), reduced=heads)


def _rank_kv(params, heads, pm, H: int, Hkv: int) -> Dict:
    """wk, wv (and bk, bv) whole over the head cut, narrowed to the kv head
    of each of this rank's q heads (q head j uses kv head j // (H / Hkv),
    jnp.repeat's order), so the rank's attention is on H / m heads each.
    Autograd sums each kv head's gradient over the q heads that use it;
    the step sums the ranks' parts."""
    h = H // pm.degree(heads)
    i = pm.index(heads)
    out = {}
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in params:
            w = params[name]
            idx = torch.arange(i * h, (i + 1) * h, device=w.device) \
                // (H // Hkv)
            out[name] = w.index_select(dim, idx)
    return out


def parallel_op_spec(node, ndim: int) -> Spec:
    """The layout a parallel op's lowering constrains its output to (the
    reference's _make_parallel_lowering)."""
    from flexflow_tpu_torch.parallel.parallel_ops import (
        AllToAllAttrs,
        FusedParallelOpAttrs,
        ReductionAttrs,
        RepartitionAttrs,
    )

    a = node.attrs
    if isinstance(a, FusedParallelOpAttrs):
        return a.final_spec(ndim)
    if isinstance(a, RepartitionAttrs):
        return a.spec(ndim)
    if isinstance(a, AllToAllAttrs):
        return tuple(tuple(a.axes) if i == a.dst_dim else ()
                     for i in range(ndim))
    if isinstance(a, ReductionAttrs):
        return tuple(a.out_spec) if a.out_spec else replicated(ndim)
    return replicated(ndim)


def plan_for(node, in_layouts, in_shapes, w_layouts, w_shapes, pm, ctx,
             remat: bool, prune) -> Plan:
    t = node.op_type
    rate = getattr(node.attrs, "dropout", 0.0) if ctx.training else 0.0
    if t in _PARALLEL_OPS:
        s = prune(parallel_op_spec(node, len(in_shapes[0])), in_shapes[0])
        return Plan([s], {}, [s], lambda ins, params: [ins[0]])
    if t == OpType.LINEAR:
        return linear_plan(node, in_layouts, in_shapes, w_layouts, pm, ctx)
    if t == OpType.EMBEDDING:
        return embedding_plan(node, in_layouts, in_shapes, w_layouts, pm,
                              ctx)
    if t in (OpType.MULTIHEAD_ATTENTION, OpType.RING_ATTENTION) \
            and rate == 0.0 and ctx.page_tables is None:
        return attention_plan(node, in_layouts, in_shapes, w_layouts, pm,
                              ctx, remat)
    if t in (OpType.ELEMENT_UNARY, OpType.CAST):
        return keep_plan(node, in_layouts, in_shapes, w_shapes, ctx, ())
    if t == OpType.RMS_NORM:
        return keep_plan(node, in_layouts, in_shapes, w_shapes, ctx, (-1,))
    if t == OpType.LAYER_NORM:
        if any(a % len(in_shapes[0]) == 0 for a in node.attrs.axes):
            return whole_plan(node, in_shapes, w_shapes, ctx)
        return keep_plan(node, in_layouts, in_shapes, w_shapes, ctx,
                         node.attrs.axes)
    if t == OpType.SOFTMAX:
        if node.attrs.axis % len(in_shapes[0]) == 0:
            return whole_plan(node, in_shapes, w_shapes, ctx)
        return keep_plan(node, in_layouts, in_shapes, w_shapes, ctx,
                         (node.attrs.axis,))
    if t == OpType.ELEMENT_BINARY:
        return binary_plan(node, in_layouts, in_shapes, w_shapes, ctx)
    if t in _PER_ROW and _batch_local(node, in_shapes):
        return per_row_plan(node, in_layouts, in_shapes, w_shapes, pm, ctx)
    return whole_plan(node, in_shapes, w_shapes, ctx)


def run_node(node, ins: Sequence[torch.Tensor], in_layouts, in_shapes,
             params: Dict, w_layouts: Dict, w_shapes: Dict, pm, ctx,
             remat: bool, prune):
    """One node on this rank's pieces: (outputs, their layouts)."""
    plan = plan_for(node, in_layouts, in_shapes, w_layouts, w_shapes, pm,
                    ctx, remat, prune)
    xs = [spmd.redistribute(x, pm, lay, s)
          for x, lay, s in zip(ins, in_layouts, plan.in_specs)]
    ps = {k: spmd.redistribute(v, pm, w_layouts[k], plan.w_specs[k])
          if k in plan.w_specs else v for k, v in params.items()}
    # the gradient rule: an operand whole over an axis the computation
    # is cut over gets the sum of its ranks' gradients (copy_to); a
    # parameter's sum over `data` and `seq` (GRAD_AXES) is left to the
    # train step, and a parameter used where nothing is cut over one of
    # them takes 1/size of the gradient every rank of it computes whole
    cut = set()
    for s in list(plan.in_specs) + [plan.w_specs[k] for k in plan.w_specs
                                    if k not in plan.post]:
        cut |= set(pm.keep(spmd.sharded_axes(s)))
    for i, x in enumerate(xs):
        if x.is_floating_point():
            xs[i] = spmd.copy_to(
                x, pm, tuple(a for a in pm.names if a in cut
                             and a not in spmd.sharded_axes(plan.in_specs[i])))
    for k, v in ps.items():
        if not v.requires_grad:
            continue
        use = cut - set(plan.reduced) if k in plan.post else cut
        own = set(spmd.sharded_axes(plan.w_specs.get(k, ())))
        f = tuple(a for a in pm.names if a in use and a not in own
                  and a not in GRAD_AXES)
        v = spmd.copy_to(v, pm, f)
        v = spmd.scale_grad(v, 1.0 / pm.degree(
            [a for a in pm.live(GRAD_AXES) if a not in use]))
        ps[k] = v
    return plan.compute(xs, ps), plan.out_specs
