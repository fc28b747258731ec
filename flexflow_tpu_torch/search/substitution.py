"""Graph substitutions (GraphXfer) + Unity-style outer search
(counterpart of flexflow_tpu/search/substitution.py, the same logic).

Reference analog: src/runtime/substitution.cc — pattern graphs (OpX/TensorX,
substitution.h:40-110) matched against the PCG, rewritten candidates ranked
by optimal_cost in a budgeted best-first search (base_optimize,
substitution.cc:2229), seeded from hand-coded xfer builders
(substitution.cc:1726-1868).

TPU-native differences: rewrites operate on attrs/views rather than device
lists; the canonical TP substitutions insert explicit parallel-op nodes
(Repartition/Combine/Replicate/Reduction) exactly like the reference so the
cost model can price the resharding, and the executor lowers them to
sharding constraints.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import ActiMode, OpType, PARALLEL_OP_TYPES
from flexflow_tpu_torch.ops import attrs as A
from flexflow_tpu_torch.parallel.parallel_ops import (
    CombineAttrs,
    ReductionAttrs,
    RepartitionAttrs,
    ReplicateAttrs,
)
from flexflow_tpu_torch.parallel.sharding import ShardingView, batch_spec
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.search.cost_model import CostModel, GraphCost, graph_cost


@dataclasses.dataclass
class OpX:
    """One pattern node: match by op type (None = any) + optional
    predicate on attrs (reference OpX, substitution.h:40)."""

    op_type: Optional[OpType]
    predicate: Optional[Callable[[Node], bool]] = None

    def matches(self, node: Node) -> bool:
        if self.op_type is not None and node.op_type != self.op_type:
            return False
        return self.predicate(node) if self.predicate else True


@dataclasses.dataclass
class GraphXfer:
    """A rewrite rule: match a linear chain of pattern ops, then rebuild.

    `pattern` is a chain (each node feeding the next, single-output), which
    covers the reference's hand-coded TP/fusion xfers; `rewrite(graph,
    matched_nodes)` returns a new Graph or None if not applicable.

    `scope`: "local" rules run inside the sequence-DP's per-module
    searches; "global" rules span module boundaries (e.g. N decoder
    blocks -> PIPELINE) and are applied in a whole-graph pre-pass before
    the sequence decomposition."""

    name: str
    pattern: List[OpX]
    rewrite: Callable[[Graph, List[Node]], Optional[Graph]]
    scope: str = "local"

    def find_matches(self, graph: Graph) -> List[List[Node]]:
        out = []
        for start in graph.nodes:
            if not self.pattern[0].matches(start):
                continue
            chain = [start]
            ok = True
            for px in self.pattern[1:]:
                succs = graph.succs(chain[-1])
                nxt = [s for s in succs if px.matches(s)]
                # chain steps must be the sole consumer to rewrite safely
                if len(nxt) != 1 or len(graph.out_edges(chain[-1])) != 1:
                    ok = False
                    break
                chain.append(nxt[0])
            if ok:
                out.append(chain)
        return out

    def apply_all(self, graph: Graph) -> List[Graph]:
        res = []
        for match in self.find_matches(graph):
            g = self.rewrite(graph, match)
            if g is not None:
                res.append(g)
        return res


# ---------------------------------------------------------------------------
# rewrite helpers


def _replace_node(graph: Graph, old: Node, make_nodes) -> Graph:
    """Copy `graph`, replacing `old` with a chain built by
    `make_nodes(new_graph, reuse) -> (entry_node, exit_node)`; all of old's
    in-edges go to entry, out-edges leave from exit. `reuse(op_type, attrs,
    name)` creates the primary replacement node WITH old's guid, so
    identity-keyed metadata (initializer overrides, which key on
    name_guid) survives the rewrite."""
    g = graph.copy()
    node = g.node(old.guid)
    in_edges = list(g.in_edges(node))
    out_edges = list(g.out_edges(node))
    for e in in_edges + out_edges:
        g.remove_edge(e)
    g.remove_node(node)

    def reuse(op_type, attrs, name):
        n = g.add_node(Node(old.guid, op_type, attrs, name))
        # seed shapes from the replaced node: in a module SUBGRAPH (sequence
        # decomposition) the producers may live outside this graph, so
        # infer_shapes cannot resolve the entry node's inputs — it keeps
        # these cached shapes instead (graph.py infer_shapes guard).
        # INVARIANT: this seed is only valid while every rewrite consumes
        # the same inputs with the same meaning as the node it replaces; a
        # rewrite that reinterprets its inputs (e.g. collapsing a cast, so
        # the true producer dtype differs from old's recorded input dtype)
        # must recompute in_shapes from its bound external inputs instead.
        n.in_shapes = old.in_shapes
        if old.in_shapes:
            n.outputs = tuple(attrs.infer(*old.in_shapes))
        return n

    entry, exit_ = make_nodes(g, reuse)
    for e in in_edges:
        g.add_edge(g.node(e.src), entry, e.src_idx, e.dst_idx)
    for e in out_edges:
        g.add_edge(exit_, g.node(e.dst), e.src_idx, e.dst_idx)
    g.infer_shapes()
    return g


# ---------------------------------------------------------------------------
# concrete xfers (reference substitution.cc:1726-1868)


def make_partition_linear_combine(axis: str = "model") -> GraphXfer:
    """Linear -> Repartition(batch)-free column-TP:
    Linear(col-sharded kernel) + Combine(out dim) — the reference's
    create_partition_linear_combine (substitution.cc:1809)."""

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        (lin,) = match
        attrs: A.LinearAttrs = lin.attrs
        ndim = lin.outputs[0].ndim

        def build(g: Graph, reuse):
            n1 = reuse(OpType.LINEAR, attrs, f"{lin.name}")
            n1.sharding = ShardingView(
                (batch_spec(ndim)[:-1] + ((axis,),),),
                {"kernel": ((), (axis,)), "bias": ((axis,),)}
                if attrs.use_bias
                else {"kernel": ((), (axis,))},
            )
            comb = g.create_node(
                OpType.COMBINE, CombineAttrs(ndim - 1, (axis,)), f"{lin.name}_combine"
            )
            comb.sharding = ShardingView((batch_spec(ndim),))
            g.add_edge(n1, comb)
            return n1, comb

        return _replace_node(graph, lin, build)

    return GraphXfer(
        "partition_linear_combine",
        [OpX(OpType.LINEAR, lambda n: n.sharding is None or not n.sharding.weight_specs)],
        rewrite,
    )


def make_replicate_linear_reduce(axis: str = "model") -> GraphXfer:
    """Linear -> row-TP: kernel sharded on in_dim + Reduction (the
    reference's create_replicate_linear_combine, substitution.cc:1756)."""

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        (lin,) = match
        attrs: A.LinearAttrs = lin.attrs
        if attrs.activation != ActiMode.NONE:
            return None  # activation must come after the reduction
        ndim = lin.outputs[0].ndim

        def build(g: Graph, reuse):
            n1 = reuse(OpType.LINEAR, attrs, f"{lin.name}")
            n1.sharding = ShardingView(
                (), {"kernel": ((axis,), ()), "bias": ((),)}
                if attrs.use_bias
                else {"kernel": ((axis,), ())},
            )
            red = g.create_node(
                OpType.REDUCTION, ReductionAttrs(axes=(axis,)), f"{lin.name}_reduce"
            )
            red.sharding = ShardingView((batch_spec(ndim),))
            g.add_edge(n1, red)
            return n1, red

        return _replace_node(graph, lin, build)

    return GraphXfer(
        "replicate_linear_reduce",
        [OpX(OpType.LINEAR, lambda n: n.sharding is None or not n.sharding.weight_specs)],
        rewrite,
    )


def make_partition_attention_combine(axis: str = "model") -> GraphXfer:
    """Head-parallel attention (create_partition_attention_combine,
    substitution.cc:1764)."""

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        (attn,) = match

        def build(g: Graph, reuse):
            n1 = reuse(OpType.MULTIHEAD_ATTENTION, attn.attrs, attn.name)
            n1.sharding = ShardingView(
                (),
                {
                    "wq": ((), (axis,), ()),
                    "wk": ((), (axis,), ()),
                    "wv": ((), (axis,), ()),
                    "wo": (((axis,), (), ())),
                },
            )
            return n1, n1

        return _replace_node(graph, attn, build)

    return GraphXfer(
        "partition_attention_combine",
        [
            OpX(
                OpType.MULTIHEAD_ATTENTION,
                lambda n: n.sharding is None or not n.sharding.weight_specs,
            )
        ],
        rewrite,
    )


def make_mha_to_ring_attention(axis_sizes: Dict[str, int],
                               seq_mode: str = "ring") -> GraphXfer:
    """MULTIHEAD_ATTENTION -> RING_ATTENTION: structure discovery for
    sequence parallelism (VERDICT r2 weakness 4 — the net-new analog of the
    reference's TP-discovery xfers, substitution.cc:1756-1770). Legal when
    the mesh has a `seq` axis and the sequence length divides it; the
    rewrite seeds the seq-sharded view so the cost model immediately prices
    the overlapped ring ppermute against plain attention's q/k/v
    all-gather (cost_model.node_comm_time)."""
    seq_deg = axis_sizes.get("seq", 1)

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        (attn,) = match
        a = attn.attrs
        if attn.outputs[0].ndim < 3:
            return None
        S = attn.outputs[0].dims[1].size
        if seq_deg <= 1 or S % seq_deg != 0:
            return None
        if a.dropout or a.use_bias:
            return None  # the ring lowering supports neither
        if seq_mode == "ulysses" and a.num_heads % seq_deg != 0:
            # the ulysses exchange turns seq sharding into head sharding;
            # with indivisible heads the lowering would silently fall back
            # to the ring kernel and the priced all-to-alls would be for a
            # kernel that never runs
            return None
        new_attrs = A.RingAttentionAttrs(
            a.embed_dim, a.num_heads, a.kv_heads, a.head_dim, a.causal,
            a.use_bias, a.dropout, a.rope, a.rope_theta, seq_mode,
        )
        ndim = attn.outputs[0].ndim
        seq_spec = (batch_spec(ndim)[:1] + (("seq",),)
                    + batch_spec(ndim)[2:])

        def build(g: Graph, reuse):
            n1 = reuse(OpType.RING_ATTENTION, new_attrs, attn.name)
            n1.sharding = ShardingView(
                (seq_spec,), input_specs=(seq_spec,) * 3
            )
            return n1, n1

        return _replace_node(graph, attn, build)

    return GraphXfer(
        "mha_to_ring_attention",
        [OpX(OpType.MULTIHEAD_ATTENTION,
             lambda n: n.sharding is None or not n.sharding.weight_specs)],
        rewrite,
    )


@dataclasses.dataclass
class _DecoderRunXfer(GraphXfer):
    """GraphXfer whose matcher finds maximal runs of identical llama-style
    decoder blocks (rms -> GQA attention -> residual -> rms -> SwiGLU ->
    residual) instead of a linear chain. Built by
    make_blocks_to_pipeline()."""

    def find_matches(self, graph: Graph) -> List[List[Node]]:
        return _find_decoder_runs(graph)


def _match_decoder_block(graph: Graph, rms1: Node):
    """If `rms1` opens a llama decoder block, return (nodes, h_in_key,
    out_node, sig) where sig captures the attrs that must be uniform
    across a pipeline run; else None."""
    if rms1.op_type != OpType.RMS_NORM:
        return None
    ins = graph.in_edges(rms1)
    if len(ins) != 1:
        return None
    h_key = (ins[0].src, ins[0].src_idx)
    cons = graph.succs(rms1)
    if len(cons) != 1 or cons[0].op_type != OpType.MULTIHEAD_ATTENTION:
        return None
    attn = cons[0]
    a = attn.attrs
    # the pipeline composite's stacked decoder assumes llama conventions
    if (a.use_bias or a.dropout or not a.rope or not a.causal
            or a.head_dim not in (None, a.embed_dim // a.num_heads)):
        return None
    if any((e.src, e.src_idx) != (rms1.guid, 0)
           for e in graph.in_edges(attn)):
        return None  # self-attention only
    add1 = _single_succ(graph, attn)
    if (add1 is None or add1.op_type != OpType.ELEMENT_BINARY
            or add1.attrs.kind != "add"):
        return None
    add1_srcs = {(e.src, e.src_idx) for e in graph.in_edges(add1)}
    if add1_srcs != {h_key, (attn.guid, 0)}:
        return None
    add1_cons = graph.succs(add1)
    if len(add1_cons) != 2:
        return None
    rms2 = next((n for n in add1_cons if n.op_type == OpType.RMS_NORM), None)
    add2 = next((n for n in add1_cons
                 if n.op_type == OpType.ELEMENT_BINARY
                 and n.attrs.kind == "add"), None)
    if rms2 is None or add2 is None:
        return None
    if abs(rms1.attrs.eps - rms2.attrs.eps) > 0:
        return None
    mlps = graph.succs(rms2)
    if len(mlps) != 2 or any(n.op_type != OpType.LINEAR for n in mlps):
        return None
    silu = None
    gate = up = None
    for cand in mlps:
        sc = _single_succ(graph, cand)
        if (sc is not None and sc.op_type == OpType.ELEMENT_UNARY
                and sc.attrs.kind == "silu"):
            gate, silu = cand, sc
        else:
            up = cand
    if gate is None or up is None or silu is None:
        return None
    if gate.attrs.out_dim != up.attrs.out_dim:
        return None
    if gate.attrs.use_bias or up.attrs.use_bias:
        return None
    mul = _single_succ(graph, silu)
    if (mul is None or mul.op_type != OpType.ELEMENT_BINARY
            or mul.attrs.kind != "multiply"
            or _single_succ(graph, up) is not mul):
        return None
    down = _single_succ(graph, mul)
    if (down is None or down.op_type != OpType.LINEAR or down.attrs.use_bias
            or _single_succ(graph, down) is not add2):
        return None
    if {(e.src, e.src_idx) for e in graph.in_edges(add2)} != {
            (add1.guid, 0), (down.guid, 0)}:
        return None
    dim = attn.outputs[0].dims[-1].size
    if down.attrs.out_dim != dim:
        return None
    sig = (dim, a.num_heads, a.num_kv, gate.attrs.out_dim, a.rope_theta,
           rms1.attrs.eps)
    nodes = [rms1, attn, add1, rms2, gate, up, silu, mul, down, add2]
    return nodes, h_key, add2, sig


def _single_succ(graph: Graph, node: Node):
    es = graph.out_edges(node)
    return graph.node(es[0].dst) if len(es) == 1 else None


def _find_decoder_runs(graph: Graph) -> List[List[Node]]:
    """Maximal runs (>= 2) of consecutive identical decoder blocks, each
    returned as the flat node list of the whole run. Block i can only be
    EXTENDED by block i+1 when its residual output feeds exactly the next
    block's (rms1, add1) pair — an external tap (aux head, early exit)
    ends the run there, so the rewrite never deletes a tensor someone
    else consumes. A signature change mid-chain starts a fresh run (e.g.
    blocks A,A,B,B yield the A,A and B,B runs)."""
    blocks = {}
    for n in graph.nodes:
        m = _match_decoder_block(graph, n)
        if m:
            nodes, h_key, out, sig = m
            blocks[h_key] = (nodes, out, sig)

    def extends(cur_key):
        """Key of the next chained block, or None if the run ends here."""
        nodes, out, sig = blocks[cur_key]
        nxt_key = (out.guid, 0)
        nxt = blocks.get(nxt_key)
        if nxt is None or nxt[2] != sig:
            return None
        # the residual output must feed ONLY the next block's rms1 + add1
        nxt_nodes = nxt[0]
        if {s.guid for s in graph.succs(out)} != {
                nxt_nodes[0].guid, nxt_nodes[2].guid}:
            return None
        return nxt_key

    continued = {extends(k) for k in blocks} - {None}
    runs = []
    for start in blocks:
        if start in continued:
            continue  # not a run head: a same-sig block chains into it
        run_nodes = []
        key = start
        count = 0
        while True:
            run_nodes.extend(blocks[key][0])
            count += 1
            key = extends(key)
            if key is None:
                break
        if count >= 2:
            runs.append(run_nodes)
    return runs


def make_blocks_to_pipeline(axis_sizes: Dict[str, int]) -> GraphXfer:
    """N consecutive decoder blocks -> one PIPELINE composite (stacked
    weights, GPipe over the `pipe` axis). The structure-discovery analog of
    the reference's parallel-chain rewrites for the net-new pipeline mode
    (VERDICT r2 weakness 4). Only proposed when the mesh has a pipe axis
    that divides the run's layer count; the microbatch count is the
    largest of (8, 4, 2) dividing the batch."""
    pipe_deg = axis_sizes.get("pipe", 1)

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        # match = flat run: 10 nodes per block
        if pipe_deg <= 1 or not match or len(match) % 10:
            return None
        layers = len(match) // 10
        if layers % pipe_deg:
            return None
        first_rms = match[0]
        last_add = match[-1]
        m = _match_decoder_block(graph, first_rms)
        if m is None:
            return None
        _, h_key, _, sig = m
        dim, heads, kv_heads, hidden, rope_theta, eps = sig
        b = first_rms.outputs[0].dims[0].size
        ddeg = axis_sizes.get("data", 1)
        # largest microbatch count that still leaves a data-divisible
        # microbatch (space.py only offers the pipe view when
        # batch % micro == 0 and (batch // micro) % data == 0)
        micro = next((m_ for m_ in (8, 4, 2) if b % m_ == 0
                      and (b // m_) % ddeg == 0), 1)
        attrs = A.PipelineAttrs(layers, heads, kv_heads, hidden,
                                n_microbatches=micro, causal=True,
                                rope_theta=rope_theta, norm_eps=eps)
        g = graph.copy()
        out_edges = list(g.out_edges(g.node(last_add.guid)))
        for n in match:
            gn = g.node(n.guid)
            for e in list(g.in_edges(gn)) + list(g.out_edges(gn)):
                g.remove_edge(e)
            g.remove_node(gn)
        pipe = g.create_node(
            OpType.PIPELINE, attrs, f"{first_rms.name}_pipeline"
        )
        g.add_edge(g.node(h_key[0]), pipe, h_key[1], 0)
        for e in out_edges:
            g.add_edge(pipe, g.node(e.dst), 0, e.dst_idx)
        g.infer_shapes()
        return g

    xf = _DecoderRunXfer(
        "blocks_to_pipeline",
        [OpX(OpType.RMS_NORM)],  # unused: find_matches is overridden
        rewrite,
        scope="global",  # runs spanning module boundaries — see GraphXfer
    )
    return xf


def make_fuse_linear_activation() -> GraphXfer:
    """Linear + ElementUnary(relu|gelu|sigmoid|tanh) -> Linear(activation)
    (the reference's linear+relu fusion xfer)."""
    fusable = {"relu": ActiMode.RELU, "gelu": ActiMode.GELU,
               "sigmoid": ActiMode.SIGMOID, "tanh": ActiMode.TANH}

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        lin, act = match
        attrs: A.LinearAttrs = lin.attrs
        new_attrs = dataclasses.replace(attrs, activation=fusable[act.attrs.kind])
        g = graph.copy()
        lin_n, act_n = g.node(lin.guid), g.node(act.guid)
        lin_n.attrs = new_attrs
        out_edges = list(g.out_edges(act_n))
        in_edge = g.in_edges(act_n)[0]
        for e in out_edges + [in_edge]:
            g.remove_edge(e)
        for e in out_edges:
            g.add_edge(lin_n, g.node(e.dst), 0, e.dst_idx)
        g.remove_node(act_n)
        g.infer_shapes()
        return g

    return GraphXfer(
        "fuse_linear_activation",
        [
            OpX(OpType.LINEAR, lambda n: n.attrs.activation == ActiMode.NONE),
            OpX(OpType.ELEMENT_UNARY, lambda n: n.attrs.kind in fusable),
        ],
        rewrite,
    )


def make_fuse_parallel_ops() -> GraphXfer:
    """Fuse two adjacent parallel-op nodes into one FusedParallelOp
    (reference SimplificationSettings.fuse_parallel_ops applied in
    substitution.cc:1924-1930; op src/parallel_ops/fused_parallel_op.cc)."""
    from flexflow_tpu_torch.parallel.parallel_ops import FusedParallelOpAttrs

    def step_of(node: Node):
        a = node.attrs
        if isinstance(a, FusedParallelOpAttrs):
            return list(a.steps)
        if isinstance(a, RepartitionAttrs):
            return [("repartition", a.dim, tuple(a.axes))]
        if isinstance(a, CombineAttrs):
            return [("combine", a.dim, tuple(a.axes))]
        if isinstance(a, ReplicateAttrs):
            return [("replicate", -1, tuple(a.axes))]
        if isinstance(a, ReductionAttrs):
            return [("reduction", -1, tuple(a.axes))]
        return None

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        first, second = match
        s1, s2 = step_of(first), step_of(second)
        if s1 is None or s2 is None:
            return None
        g = graph.copy()
        f, s = g.node(first.guid), g.node(second.guid)
        in_e = g.in_edges(f)[0]
        out_edges = list(g.out_edges(s))
        mid = g.in_edges(s)[0]
        for e in [in_e, mid] + out_edges:
            g.remove_edge(e)
        g.remove_node(f)
        g.remove_node(s)
        fused = g.create_node(
            OpType.FUSED_PARALLEL,
            FusedParallelOpAttrs(tuple(s1 + s2)),
            f"{first.name}_{second.name}_fused",
        )
        g.add_edge(g.node(in_e.src), fused, in_e.src_idx, 0)
        for e in out_edges:
            g.add_edge(fused, g.node(e.dst), 0, e.dst_idx)
        g.infer_shapes()
        return g

    pl = [OpType.REPARTITION, OpType.COMBINE, OpType.REPLICATE,
          OpType.REDUCTION, OpType.FUSED_PARALLEL]
    return GraphXfer(
        "fuse_parallel_ops",
        [OpX(None, lambda n: n.op_type in pl),
         OpX(None, lambda n: n.op_type in pl)],
        rewrite,
    )


def make_cancel_parallel_ops() -> GraphXfer:
    """Repartition followed by Combine on the same dim cancels (the
    SimplificationSettings.fuse_parallel_ops pass, substitution.cc:1924)."""

    def rewrite(graph: Graph, match: List[Node]) -> Optional[Graph]:
        rep, comb = match
        if rep.attrs.dim != comb.attrs.dim:
            return None
        g = graph.copy()
        rep_n, comb_n = g.node(rep.guid), g.node(comb.guid)
        in_e = g.in_edges(rep_n)[0]
        out_edges = list(g.out_edges(comb_n))
        mid = g.in_edges(comb_n)[0]
        for e in [in_e, mid] + out_edges:
            g.remove_edge(e)
        for e in out_edges:
            g.add_edge(g.node(in_e.src), g.node(e.dst), in_e.src_idx, e.dst_idx)
        g.remove_node(rep_n)
        g.remove_node(comb_n)
        g.infer_shapes()
        return g

    return GraphXfer(
        "cancel_partition_combine",
        [OpX(OpType.REPARTITION), OpX(OpType.COMBINE)],
        rewrite,
    )


def default_xfers(axis_sizes: Dict[str, int],
                  full_corpus: Optional[bool] = None,
                  stats_out: Optional[Dict] = None) -> List[GraphXfer]:
    """`stats_out`: optionally receives the active-vs-full declarative-
    corpus counts (corpus_rules_full/active/excluded) recorded by the
    corpus load below — attached here, at the resolution site, so every
    search entry point that resolves the default set gets the
    observability for free (ADVICE r5)."""
    # linear+activation fusion comes from the JSON corpus
    # (fuse_linear_{relu,gelu,sigmoid,tanh,silu}); registering the
    # hand-coded make_fuse_linear_activation too would double-match every
    # pair and waste search budget on structure-hash-deduped twins
    xf = [make_cancel_parallel_ops(), make_fuse_parallel_ops()]
    if axis_sizes.get("model", 1) > 1:
        xf += [
            make_partition_linear_combine("model"),
            make_replicate_linear_reduce("model"),
            make_partition_attention_combine("model"),
        ]
    if axis_sizes.get("seq", 1) > 1:
        # structure discovery: sequence parallelism via ring/Ulysses
        # attention (net-new parallel modes the search can now propose)
        xf += [
            make_mha_to_ring_attention(axis_sizes, "ring"),
            make_mha_to_ring_attention(axis_sizes, "ulysses"),
        ]
    if axis_sizes.get("pipe", 1) > 1:
        xf.append(make_blocks_to_pipeline(axis_sizes))
    # declarative JSON corpus (general pattern graphs: multi-input merges,
    # cancellations, conv/embedding parallelization — xfer_engine.py)
    from flexflow_tpu_torch.search.xfer_engine import default_decl_xfers

    xf += default_decl_xfers(axis_sizes, full_corpus=full_corpus)
    if stats_out is not None:
        from flexflow_tpu_torch.search import xfer_engine

        stats_out.update(xfer_engine.last_corpus_counts)
    return xf


# ---------------------------------------------------------------------------
# sequence decomposition (generic_sequence_optimize, substitution.cc:2572)


def find_split_nodes(graph: Graph) -> List[Node]:
    """All valid sequence-split points in topo order (reference
    find_split_node, substitution.cc:2094): positions no edge jumps over.
    On a transformer these are the residual-add chain — the module
    boundaries the sequence DP splits at."""
    order = graph.topo_order()
    pos = {n.guid: i for i, n in enumerate(order)}
    far = -1
    splits = []
    for i, n in enumerate(order):
        if 0 < i < len(order) - 1 and far <= i:
            splits.append(n)
        for e in graph.out_edges(n):
            far = max(far, pos[e.dst])
    return splits


def _glue(parts: List[Graph]) -> Graph:
    """Reassemble sequence modules into one graph (boundary nodes appear in
    two consecutive parts and are deduped by guid)."""
    out = Graph()
    out._guid_counter = parts[-1]._guid_counter  # shared counter object
    seen_nodes = set()
    seen_edges = set()
    for g in parts:
        for n in g.topo_order():
            if n.guid not in seen_nodes:
                seen_nodes.add(n.guid)
                out.add_node(n)
    for g in parts:
        for n in g.topo_order():
            for e in g.out_edges(n):
                key = (e.src, e.dst, e.src_idx, e.dst_idx)
                if key not in seen_edges:
                    seen_edges.add(key)
                    out.add_edge(out.node(e.src), out.node(e.dst),
                                 e.src_idx, e.dst_idx)
    out.infer_shapes()
    return out


def sequence_unity_search(
    graph: Graph,
    cost: CostModel,
    *,
    budget: int = 20,
    alpha: float = 1.05,
    training: bool = True,
    xfers: Optional[List[GraphXfer]] = None,
    memory_limit: Optional[float] = None,
    min_module: int = 6,
    objective=None,
    candidates_out: Optional[List] = None,
    candidates_k: int = 4,
    stats_out: Optional[Dict] = None,
    runner_up_out: Optional[List] = None,
) -> Tuple[Graph, Dict[str, ShardingView], float]:
    """Sequence-DP outer decomposition (reference generic_sequence_optimize,
    substitution.cc:2572): split the PCG at module boundaries, run the
    budgeted best-first substitution search per module, and stitch the
    rewritten modules + strategies back together. Keeps the search tractable
    on deep graphs (a 32-layer Llama is ~66 small solves instead of one
    best-first over ~450 nodes).

    `candidates_out`: forwarded to the flat search when the graph has too
    few module boundaries to decompose; the stitched path cannot build a
    whole-graph pool itself (graph_optimize adds the winner-vs-baseline
    pair instead).

    `runner_up_out` (the port's addition): when a list is passed, the
    stitched path appends (cost, graph, strategy) of the next-best whole
    graph: the winner with the one module whose best other candidate
    costs least more swapped in, so a playoff can time a rewrite against
    a winner that is the graph as built."""
    all_xfers = (xfers if xfers is not None
                 else default_xfers(cost.axis_sizes, stats_out=stats_out))
    if stats_out is not None:
        # the honest whole-graph baseline: the UNREWRITTEN input at its
        # ViewDP-optimal views, captured before the global pre-pass can
        # rewrite anything and before per-module solves could double-count
        # shared boundary nodes. unity_search only fills this when absent.
        from flexflow_tpu_torch.search.dp import ViewDP

        _base_dp = ViewDP(cost, training=training, objective=objective)
        stats_out["baseline_cost"] = graph_cost(
            graph, _base_dp.optimize(graph), cost, training
        ).time
    # whole-graph pre-pass: "global" rewrites span module boundaries (N
    # decoder blocks -> PIPELINE), so the per-module searches below could
    # never propose them. Greedily adopt any that improve the ViewDP-
    # optimal modeled cost, then decompose whatever remains.
    global_xfers = [x for x in all_xfers
                    if getattr(x, "scope", "local") == "global"]
    if global_xfers:
        from flexflow_tpu_torch.search.dp import ViewDP

        pre_dp = ViewDP(cost, training=training, objective=objective)

        def pre_cost(g: Graph) -> float:
            # same ranking as unity_search.evaluate: objective when given,
            # else time with the over-memory-limit penalty — a whole-graph
            # rewrite the per-module searches would reject for memory must
            # not be adopted here (they cannot undo it downstream)
            gc = graph_cost(g, pre_dp.optimize(g), cost, training)
            if objective is not None:
                return objective(gc.time, gc.memory_per_chip)
            t = gc.time
            if (memory_limit is not None
                    and gc.memory_per_chip > memory_limit):
                t += 1e3 * (gc.memory_per_chip / memory_limit)
            return t

        cur_cost = pre_cost(graph)
        improved = True
        while improved:
            improved = False
            for x in global_xfers:
                for cand in x.apply_all(graph):
                    cc = pre_cost(cand)
                    if cc < cur_cost:
                        graph, cur_cost, improved = cand, cc, True
                        break  # candidates are stale once graph changed
                if improved:
                    break
    xfers = [x for x in all_xfers
             if getattr(x, "scope", "local") != "global"]
    splits = [
        s for s in find_split_nodes(graph)
        if s.op_type not in PARALLEL_OP_TYPES
    ]
    # space the splits so each module has at least min_module nodes
    order_pos = {n.guid: i for i, n in enumerate(graph.topo_order())}
    spaced, last = [], -min_module
    for s in splits:
        if order_pos[s.guid] - last >= min_module:
            spaced.append(s)
            last = order_pos[s.guid]
    if len(spaced) < 2 or len(graph) <= 2 * min_module:
        return unity_search(graph, cost, budget=budget, alpha=alpha,
                            training=training, xfers=xfers,
                            memory_limit=memory_limit, objective=objective,
                            candidates_out=candidates_out,
                            candidates_k=candidates_k,
                            stats_out=stats_out)

    modules: List[Graph] = []
    rest = graph
    for s in spaced:
        if s.guid not in {n.guid for n in rest.nodes}:
            continue
        try:
            first, rest = rest.split_at_node(rest.node(s.guid))
        except ValueError:
            continue
        modules.append(first)
    modules.append(rest)

    rewritten: List[Graph] = []
    strategy: Dict[str, ShardingView] = {}
    module_alts: List[Tuple] = []
    total = 0.0
    for i, mod in enumerate(modules):
        # all modules share the source graph's guid counter object (set by
        # split_at_node), so rewrites across modules can never collide
        guids = {n.guid for n in mod.nodes}
        next_shared = guids & (
            {n.guid for n in modules[i + 1].nodes} if i + 1 < len(modules)
            else set()
        )
        prev_shared = guids & (
            {n.guid for n in modules[i - 1].nodes} if i > 0 else set()
        )
        orig_attrs = {n.guid: n.attrs for n in mod.nodes}
        mod_pool = [] if runner_up_out is not None else None
        g, s, t = unity_search(mod, cost, budget=budget, alpha=alpha,
                               training=training, xfers=xfers,
                               memory_limit=memory_limit, objective=objective,
                               candidates_out=mod_pool, candidates_k=2,
                               stats_out=stats_out)

        def boundary_ok(g: Graph) -> bool:
            # boundary nodes shared with a neighbor module must come
            # through the rewrite UNTOUCHED: present, attrs unchanged (a
            # fusion that rewrites a source boundary's attrs would be
            # deduped away by _glue), and — for the sink boundary — with
            # no appended successors the next module's consumers would
            # bypass
            new_nodes = {n.guid: n for n in g.nodes}
            for bg in next_shared | prev_shared:
                n = new_nodes.get(bg)
                if n is None or n.attrs is not orig_attrs[bg]:
                    return False
                if bg in next_shared and g.out_edges(n):
                    return False
            return True

        bad = not boundary_ok(g)
        if bad:
            from flexflow_tpu_torch.search.dp import ViewDP

            g = mod
            s = ViewDP(cost, training=training,
                       objective=objective).optimize(mod)
        rewritten.append(g)
        strategy.update(s)
        total += t
        if mod_pool:
            h = g.structure_hash()
            won = min((c for c, pg, _ in mod_pool if pg.structure_hash() == h),
                      default=t)
            alt = next(((c, pg, ps) for c, pg, ps in mod_pool
                        if pg.structure_hash() != h and boundary_ok(pg)),
                       None)
            if alt is not None:
                module_alts.append((alt[0] - won, len(rewritten) - 1,
                                    alt[1], alt[2]))
    merged = _glue(rewritten)
    gc = graph_cost(merged, strategy, cost, training)
    if module_alts:
        _, i, alt_graph, alt_views = min(module_alts,
                                         key=lambda a: (a[0], a[1]))
        parts = list(rewritten)
        parts[i] = alt_graph
        alt_strategy = dict(strategy)
        alt_strategy.update(alt_views)
        alt = _glue(parts)
        runner_up_out.append((graph_cost(alt, alt_strategy, cost,
                                         training).time, alt, alt_strategy))
    return merged, strategy, gc.time


# ---------------------------------------------------------------------------
# budgeted best-first search (base_optimize, substitution.cc:2229)


def structural_class(graph: Graph) -> frozenset:
    """The set of STRUCTURAL parallel modes a graph embodies — sequence
    parallelism (ring/ulysses attention) and pipelining. Candidates are
    bucketed by this so the playoff pool always retains the best member of
    each class: a structural rewrite's modeled margin over plain DP is
    small and algebraic rewrites (QKV merges etc.) would otherwise crowd
    every structural candidate out of the top-k (r03 MULTICHIP failure)."""
    kinds = set()
    for n in graph.nodes:
        if n.op_type == OpType.RING_ATTENTION:
            kinds.add(("seq_attention",
                       getattr(n.attrs, "seq_mode", "ring")))
        elif n.op_type == OpType.PIPELINE:
            kinds.add(("pipeline",))
    return frozenset(kinds)


def unity_search(
    graph: Graph,
    cost: CostModel,
    *,
    budget: int = 20,
    alpha: float = 1.05,
    training: bool = True,
    xfers: Optional[List[GraphXfer]] = None,
    use_dp: bool = True,
    memory_limit: Optional[float] = None,
    objective=None,
    candidates_out: Optional[List] = None,
    candidates_k: int = 4,
    stats_out: Optional[Dict] = None,
) -> Tuple[Graph, Dict[str, ShardingView], float]:
    """Best-first search over substitution rewrites; each candidate graph is
    costed at its optimal views (ViewDP when `use_dp`, else current views +
    DP default). Candidates worse than alpha × best are pruned; strategies
    over `memory_limit` bytes/chip are heavily penalized (the reference's
    is_valid_strategy memory check, graph.cc:1983). `objective(time, mem)`
    replaces the pure-time ranking when given (memory-λ search). Returns
    (best graph, best strategy, best cost).

    `candidates_out`: when a list is passed, it receives DISTINCT
    candidates seen during the search as (modeled_cost, graph, strategy),
    best first — the pool for empirical whole-step validation (SURVEY §7:
    'cost the whole step for top-k candidate strategies', compensating for
    model-vs-XLA-fusion gaps). The pool holds the `candidates_k` best PLUS
    the best candidate of each structural_class PLUS the unrewritten input
    graph's own entry — structural candidates and the baseline can never
    be crowded out by algebraic rewrites.

    `stats_out`: optional dict receiving search-cost observability fields
    (expansions, candidates_seen, baseline_cost — the unrewritten graph at
    its ViewDP-optimal views)."""
    from flexflow_tpu_torch.search.dp import ViewDP

    xfers = (xfers if xfers is not None
             else default_xfers(cost.axis_sizes, stats_out=stats_out))
    if stats_out is not None:
        # corpus-size observability: a truncated (active-set) or inflated
        # corpus shows up in gate records next to wall_s
        stats_out["n_xfers"] = len(xfers)
    # one ViewDP across all candidates: its memo keys on (structure hash,
    # boundary views), so shared subgraphs are solved once
    view_dp = (ViewDP(cost, training=training, objective=objective)
               if use_dp else None)

    def views_of(g: Graph) -> Dict[str, ShardingView]:
        if view_dp is not None:
            return view_dp.optimize(g)
        out = {n.name: n.sharding for n in g.nodes if n.sharding is not None}
        from flexflow_tpu_torch.search.space import default_dp_strategy

        base = default_dp_strategy(g, cost.axis_sizes)
        base.update(out)
        return base

    def evaluate(g: Graph) -> Tuple[float, Dict[str, ShardingView]]:
        s = views_of(g)
        gc = graph_cost(g, s, cost, training)
        t = gc.time
        if getattr(cost, "event_sim", False):
            # rank by the per-device task simulator (overlap, pipeline
            # bubbles, per-ring-instance ICI contention); the serial sum
            # stays the fallback when the native engine is unavailable —
            # stats_out["eventsim"] records which ranking each candidate
            # actually got (oversize fallbacks must not pass silently)
            from flexflow_tpu_torch.search.eventsim import simulate_graph

            sim_info = {} if stats_out is not None else None
            sim = simulate_graph(g, s, cost, training, info=sim_info)
            if sim is not None:
                t = sim
            if stats_out is not None:
                cov = stats_out.setdefault("eventsim", {})
                mode = sim_info.get("mode", "unavailable")
                cov[mode] = cov.get(mode, 0) + 1
        if objective is not None:
            return objective(t, gc.memory_per_chip), s
        if memory_limit is not None and gc.memory_per_chip > memory_limit:
            t += 1e3 * (gc.memory_per_chip / memory_limit)
        return t, s

    # pooled entries carry their structure hash so collect() never rehashes
    # a graph: (cost, hash, graph, strategy)
    topk: List[Tuple] = []
    structural_best: Dict[frozenset, Tuple] = {}
    baseline_entry: List = []  # the input graph's own entry

    def collect(c: float, g: Graph, s: Dict[str, ShardingView],
                h: int) -> None:
        if candidates_out is None:
            return
        if not baseline_entry:
            baseline_entry.append((c, h, g, s))  # first collect = input
        changed = False
        cls = structural_class(g)
        if cls:
            cur = structural_best.get(cls)
            if cur is None or c < cur[0]:
                structural_best[cls] = (c, h, g, s)
                changed = True
        if len(topk) < candidates_k or c < topk[-1][0]:
            topk.append((c, h, g, s))
            topk.sort(key=lambda t: t[0])
            del topk[candidates_k:]
            changed = True
        if not changed:
            return
        merged = list(topk)
        hashes = {hh for _, hh, _, _ in merged}
        for extra in baseline_entry + list(structural_best.values()):
            if extra[1] not in hashes:
                hashes.add(extra[1])
                merged.append(extra)
        merged.sort(key=lambda t: t[0])
        candidates_out[:] = [(c_, g_, s_) for c_, _, g_, s_ in merged]

    best_graph = graph
    best_cost, best_strategy = evaluate(graph)
    initial_cost = best_cost  # the unrewritten graph at its optimal views
    input_hash = graph.structure_hash()
    collect(best_cost, graph, best_strategy, input_hash)
    seen = {input_hash}
    # rewrite provenance: structure hash -> tuple of rule names applied
    # along the candidate's derivation — the winner's lineage tells the
    # coverage tool exactly which rules CARRY the result (and are worth
    # ablation-pricing), at zero extra search cost
    lineage = {input_hash: ()}
    best_lineage = ()
    counter = itertools.count()
    heap = [(best_cost, next(counter), graph)]
    expansions = 0
    while heap and expansions < budget:
        c, _, g = heapq.heappop(heap)
        if c > alpha * best_cost:
            continue
        expansions += 1
        g_line = lineage.get(g.structure_hash(), ())
        for xfer in xfers:
            cands = xfer.apply_all(g)
            if stats_out is not None and cands:
                # rule-coverage observability: which rules ever fire
                fires = stats_out.setdefault("rule_fires", {})
                fires[xfer.name] = fires.get(xfer.name, 0) + len(cands)
            for cand in cands:
                h = cand.structure_hash()
                if h in seen:
                    continue
                seen.add(h)
                lineage[h] = g_line + (xfer.name,)
                cc, ss = evaluate(cand)
                collect(cc, cand, ss, h)
                if cc < best_cost:
                    best_graph, best_cost, best_strategy = cand, cc, ss
                    best_lineage = lineage[h]
                if cc <= alpha * best_cost:
                    heapq.heappush(heap, (cc, next(counter), cand))
    if stats_out is not None:
        stats_out["expansions"] = (
            stats_out.get("expansions", 0) + expansions
        )
        stats_out["candidates_seen"] = (
            stats_out.get("candidates_seen", 0) + len(seen)
        )
        wr = stats_out.setdefault("winner_rules", [])
        for name in best_lineage:
            if name not in wr:
                wr.append(name)
        # the sequence-DP path pre-fills the whole-graph baseline; only a
        # direct (flat) call records its own input graph's cost here
        stats_out.setdefault("baseline_cost", initial_cost)
    return best_graph, best_strategy, best_cost


# deep graphs get the sequence-DP decomposition; flat best-first below this
SEQUENCE_SEARCH_MIN_NODES = 40


def pick_search_fn(graph: Graph):
    """Flat best-first for small graphs, sequence-DP decomposition for deep
    ones — shared by the plain and memory-λ search paths."""
    return (sequence_unity_search if len(graph) > SEQUENCE_SEARCH_MIN_NODES
            else unity_search)


# ---------------------------------------------------------------------------
# memory-λ search (graph_optimize_task λ binary search, graph.cc:2046-2131)


def memory_lambda_search(
    graph: Graph,
    cost: CostModel,
    *,
    memory_limit: float,
    budget: int = 20,
    alpha: float = 1.05,
    training: bool = True,
    xfers: Optional[List[GraphXfer]] = None,
    iters: int = 6,
    search_fn=None,
):
    """Memory-aware strategy search: binary-search the run-time weight λ of
    GraphCost.multi_obj until the best strategy fits `memory_limit`
    bytes/chip (reference try_one_lambda loop, graph.cc:2046-2131). λ=1 is
    pure run time; smaller λ weights per-chip memory more, pushing the DP
    toward sharded (ZeRO/TP) views. Memory is normalized into time units by
    the λ=1 solution's (time / memory) so the blend is scale-free. Returns
    (graph, strategy, GraphCost of the chosen strategy)."""
    search_fn = search_fn or pick_search_fn(graph)

    def run(objective, mem_limit):
        g, s, _ = search_fn(graph, cost, budget=budget, alpha=alpha,
                            training=training, xfers=xfers,
                            memory_limit=mem_limit, objective=objective)
        gc = graph_cost(g, s, cost, training)
        return g, s, gc

    # λ=1 first: if the time-optimal strategy already fits, done
    g, s, gc = run(None, memory_limit)
    if gc.memory_per_chip <= memory_limit:
        return g, s, gc
    scale = gc.time / max(gc.memory_per_chip, 1.0)

    def obj_of(lam):
        return lambda t, m: GraphCost(t, m).multi_obj(lam, memory_scale=scale)

    # λ=0 anchor: the memory-minimal strategy. If even that does not fit,
    # the model is infeasible on this machine — return it anyway (the
    # reference reports the best-effort strategy and lets compile fail).
    g0, s0, gc0 = run(obj_of(0.0), None)
    if gc0.memory_per_chip > memory_limit:
        return g0, s0, gc0
    best = (g0, s0, gc0)
    lo, hi = 0.0, 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        g1, s1, gc1 = run(obj_of(mid), None)
        if gc1.memory_per_chip <= memory_limit:
            best, lo = (g1, s1, gc1), mid
        else:
            hi = mid
    return best
