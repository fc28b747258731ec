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
    the output projection's partial sums are all-reduced, then `bo`.
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

# the axis whose parameter gradients the train step reduces
DATA = "data"

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
    attrs = node.attrs
    wq = tuple(tuple(x) for x in w_layouts["wq"])
    heads = wq[1]
    if wq[0] or wq[2]:
        raise NotImplementedError(
            f"{node.name}: attention weights cut on the model width or the "
            "head dim; the port cuts attention on its heads only")
    if heads:
        m = pm.degree(heads)
        kv = attrs.kv_heads or attrs.num_heads
        if kv % m or attrs.num_heads % m:
            raise ValueError(
                f"{node.name}: {attrs.num_heads} heads / {kv} kv heads do "
                f"not split over {heads} of degree {m}: a model degree "
                "must divide the kv heads")
    w = {"wq": ((), heads, ()), "wk": ((), heads, ()),
         "wv": ((), heads, ()), "wo": (heads, (), ())}
    if attrs.use_bias:
        w.update(bq=(heads, ()), bk=(heads, ()), bv=(heads, ()), bo=((),))
    xs = [_without(tuple(lay), set(heads))[:-1] + ((),)
          for lay in in_layouts]
    lower = get_lowering(node.op_type)

    def local(*args):
        ins = list(args[:len(xs)])
        params = dict(zip(names, args[len(xs):]))
        if attrs.use_bias:
            params["bo"] = torch.zeros_like(params["bo"])
        return lower(attrs, ins, params, ctx)[0]

    names = list(w)

    def compute(ins, params):
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
    if t == OpType.MULTIHEAD_ATTENTION and rate == 0.0 \
            and ctx.kv_cache is None:
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
    # parameter's sum over `data` is left to the train step, and a
    # parameter used where nothing is cut over `data` takes 1/d of the
    # gradient every data rank computes whole
    cut = set()
    for s in list(plan.in_specs) + [plan.w_specs[k] for k in plan.w_specs
                                    if k not in plan.post]:
        cut |= set(pm.keep(spmd.sharded_axes(s)))
    for i, x in enumerate(xs):
        if x.is_floating_point():
            xs[i] = spmd.copy_to(
                x, pm, tuple(a for a in pm.names if a in cut
                             and a not in spmd.sharded_axes(plan.in_specs[i])))
    d = pm.sizes.get(DATA, 1)
    for k, v in ps.items():
        if not v.requires_grad:
            continue
        use = cut - set(plan.reduced) if k in plan.post else cut
        own = set(spmd.sharded_axes(plan.w_specs.get(k, ())))
        f = tuple(a for a in pm.names if a in use and a not in own
                  and a != DATA)
        v = spmd.copy_to(v, pm, f)
        if d > 1 and DATA not in use:
            v = spmd.scale_grad(v, 1.0 / d)
        ps[k] = v
    return plan.compute(xs, ps), plan.out_specs
