"""Strategy space: legal ShardingViews per operator
(counterpart of flexflow_tpu/search/space.py, the same logic).

Reference analog: the SOAP dimensions (sample/operator/attribute/parameter)
from MLSys'19 and the per-op ParallelConfig enumeration used by the MCMC
search (FFModel::rewrite, model.cc:3260) plus register_all_machine_views
(graph.cc:2329). Here a "view" names mesh axes instead of device lists; the
enumeration yields, per op, the TPU-meaningful points: pure DP, column/row
TP for linears (parameter parallelism), head parallelism for attention
(attribute), expert parallelism for MoE, vocab/ffn splits, sequence
parallelism (net-new vs the reference, SURVEY.md §5.7), and the 2-axis
combinations (data×model / data×seq on activations) the flagship hybrid
strategies are made of.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.parallel.sharding import (
    ShardingView,
    Spec,
    batch_spec,
    data_batch_spec,
    replicated_spec,
)
from flexflow_tpu_torch.pcg.graph import Graph, Node


def _with_seq(spec: Spec, seq_dim: int = 1) -> Spec:
    """Also shard `seq_dim` over the seq axis (sequence parallelism)."""
    out = list(spec)
    if seq_dim < len(out) and not out[seq_dim]:
        out[seq_dim] = ("seq",)
    return tuple(out)


def _seq_variants(views: List[ShardingView], out_ndim: int,
                  has_seq: bool) -> List[ShardingView]:
    """For every view whose output has a free dim 1, add a variant that also
    shards dim 1 over `seq` — the DP×SP and TP×SP combination points. The
    view's input_specs get the same seq extension so the cost model keeps
    pricing TP×SP chains consistently (a seq-sharded row-TP linear still
    consumes a model-sharded, seq-sharded input for free)."""
    if not has_seq or out_ndim < 3:
        return views
    extra = []
    for v in views:
        spec = v.output_spec(0)
        if spec is None or (1 < len(spec) and spec[1]):
            continue
        extra.append(ShardingView(
            (_with_seq(spec),) + tuple(v.output_specs[1:]),
            dict(v.weight_specs),
            tuple(
                _with_seq(s) if s is not None else None
                for s in v.input_specs
            ),
        ))
    return views + extra


def enumerate_views(node: Node, axis_sizes: Dict[str, int],
                    param_parallel: bool = True,
                    attr_parallel: bool = True) -> List[ShardingView]:
    """Candidate ShardingViews for one node. Always includes the
    data-parallel default (weights replicated). `param_parallel` gates
    weight-dim sharding (linear/conv/embedding), `attr_parallel` gates
    attention-head sharding — the reference's SOAP dimension flags
    (model.cc:3613-3617)."""
    has_model = axis_sizes.get("model", 1) > 1 and param_parallel
    has_attr = axis_sizes.get("model", 1) > 1 and attr_parallel
    has_seq = axis_sizes.get("seq", 1) > 1
    has_sub = axis_sizes.get("data_sub", 1) > 1
    has_expert = axis_sizes.get("expert", 1) > 1
    out_ndim = node.outputs[0].ndim if node.outputs else 2
    dim0 = (node.outputs[0].dims[0].size
            if node.outputs and node.outputs[0].dims else 0)
    if has_sub:
        # submesh placement (MachineView start/stride analog): the dp
        # point shards over the widest divisible data x data_sub group;
        # when the full group divides, the ("data",)-only SUBSET view is
        # also offered — a small op can prefer fewer devices (it pays
        # shorter collectives and still divides)
        dp = ShardingView((data_batch_spec(out_ndim, dim0, axis_sizes),))
        views = [dp]
        full = (axis_sizes.get("data", 1)
                * axis_sizes.get("data_sub", 1))
        if dim0 and axis_sizes.get("data", 1) > 1 and dim0 % full == 0:
            views.append(ShardingView((batch_spec(out_ndim),)))
    else:
        dp = ShardingView((batch_spec(out_ndim),))
        views = [dp]
    # every non-pure-DP view below batch-shards over the widest divisible
    # data group (data x data_sub under the submesh split) so hybrid
    # strategies keep full data-parallel width
    bspec = (data_batch_spec(out_ndim, dim0, axis_sizes) if has_sub
             else batch_spec(out_ndim))
    t = node.op_type

    if t == OpType.LINEAR and has_model:
        # column parallel (parameter parallelism on out_dim); activations
        # stay batch-sharded => data×model 2-axis combination. Consumes a
        # feature-replicated input (declared so the cost model prices the
        # all-gather when the producer left the feature dim sharded).
        views.append(
            ShardingView(
                (bspec[:-1] + (("model",),),),
                {"kernel": ((), ("model",)), "bias": (("model",),)},
                input_specs=(bspec,),
            )
        )
        # row parallel (contraction dim sharded -> all-reduce after); the
        # consumed input arrives sharded on its last dim
        views.append(
            ShardingView(
                (bspec,),
                {"kernel": (("model",), ()), "bias": ((),)},
                input_specs=(bspec[:-1] + (("model",),),),
            )
        )
    elif t in (OpType.MULTIHEAD_ATTENTION, OpType.RING_ATTENTION) and (
        has_attr or has_seq
    ):
        if has_attr:
            # head (attribute) parallelism, activations batch-sharded
            views.append(
                ShardingView(
                    (bspec,),
                    {
                        "wq": ((), ("model",), ()),
                        "wk": ((), ("model",), ()),
                        "wv": ((), ("model",), ()),
                        "wo": (("model",), (), ()),
                    },
                    input_specs=(bspec,) * 3,
                )
            )
    elif t == OpType.EMBEDDING and has_model:
        views.append(
            ShardingView(
                (bspec,),
                {"kernel": ((), ("model",))},
            )
        )
        views.append(
            ShardingView(
                (bspec,),
                {"kernel": (("model",), ())},  # vocab-sharded
            )
        )
    elif t == OpType.PIPELINE and axis_sizes.get("pipe", 1) > 1:
        from flexflow_tpu_torch.parallel.sharding import pipeline_pipe_view

        batch = node.outputs[0].dims[0].size if node.outputs else 0
        micro = max(node.attrs.n_microbatches, 1)
        # only executable views: the lowering falls back to a plain scan
        # when layers don't divide into stages or the batch doesn't split
        # into microbatches, and pipeline_apply replicates over data when
        # the microbatch doesn't split across it — pricing compute/memory
        # the execution won't deliver would mislead the search
        if (node.attrs.layers % axis_sizes["pipe"] == 0
                and batch % micro == 0
                and (batch // micro) % axis_sizes.get("data", 1) == 0):
            views.append(pipeline_pipe_view(out_ndim))
    elif t == OpType.EXPERTS and (has_expert or has_model):
        ax = "expert" if has_expert else "model"
        views.append(
            ShardingView(
                (bspec,),
                {"w1": ((ax,), (), ()), "w2": ((ax,), (), ())},
            )
        )
    elif t == OpType.CONV2D and has_model:
        # output-channel (parameter) parallelism
        views.append(
            ShardingView(
                ((bspec[0],) + (("model",),) + ((),) * (out_ndim - 2),),
                {"kernel": (("model",), (), (), ()), "bias": (("model",),)},
            )
        )
    elif t in (OpType.ELEMENT_BINARY, OpType.ELEMENT_UNARY,
               OpType.DROPOUT, OpType.SOFTMAX, OpType.CAST) and has_model:
        # elementwise ops can consume/produce a feature-dim-sharded
        # activation, letting col-TP chains (gate→silu→×→down) flow without
        # resharding; sharded softmax costs only tiny reduction collectives
        # which XLA emits (approximated as free here)
        views.append(
            ShardingView((bspec[:-1] + (("model",),),))
        )

    # full-mesh DP: batch sharded over data AND model — the "use every chip
    # for samples" point (reference: a MachineView spanning all GPUs with a
    # batch-dim stride). Time-optimal at inference (zero collectives) while
    # keeping weights replicated; the memory-λ search trades it against TP.
    # Gated on batch divisibility: prune_spec drops the whole axes tuple at
    # execution when the dim doesn't divide, so an indivisible view would
    # be priced 8-way but run fully replicated.
    full_axes = bspec[0] + ("model",)
    full_deg = 1
    for a in full_axes:
        full_deg *= axis_sizes.get(a, 1)
    if (axis_sizes.get("model", 1) > 1 and node.outputs
            and node.outputs[0].dims
            and node.outputs[0].dims[0].size % full_deg == 0):
        views.append(ShardingView(
            ((full_axes,) + tuple(() for _ in range(out_ndim - 1)),)
        ))

    views = _seq_variants(views, out_ndim, has_seq)
    return views


def default_dp_strategy(graph: Graph, axis_sizes: Dict[str, int]) -> Dict[str, ShardingView]:
    """Pure data parallelism on EVERY node (the reference's default view,
    graph.cc:1955). Covering all nodes (not just inputs) matters for cost
    fidelity: an uncovered node would be priced unsharded and charge
    phantom reshardings against its sharded neighbors."""
    out = {}
    for n in graph.nodes:
        if n.outputs:
            dim0 = n.outputs[0].dims[0].size if n.outputs[0].dims else 0
            out[n.name] = ShardingView(
                (data_batch_spec(n.outputs[0].ndim, dim0, axis_sizes),)
            )
    return out
