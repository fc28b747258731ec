"""Generic DAG algorithms used by the PCG layer and the strategy search
(counterpart of flexflow_tpu/pcg/algorithms.py, the same logic).

Re-implements (TPU-framework-native, pure Python) the algorithm surface of the
reference's header-only graph utilities: topological sort, dominators,
post-dominators, immediate (post-)dominators, transitive reduction
(reference: include/flexflow/dominators.h:156-377, basic_graph.h).

All functions operate on a minimal adjacency view: `nodes` iterable plus
`succs(n)` / `preds(n)` callables, so they work on PCG graphs, pattern graphs,
and test fixtures alike (the reference's `GraphStructure` trait).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Iterable, List, Optional, Set, TypeVar

N = TypeVar("N", bound=Hashable)


def topo_sort(
    nodes: Iterable[N],
    succs: Callable[[N], Iterable[N]],
    preds: Callable[[N], Iterable[N]],
) -> List[N]:
    """Kahn topological order; deterministic given deterministic iteration."""
    nodes = list(nodes)
    indeg: Dict[N, int] = {n: 0 for n in nodes}
    for n in nodes:
        for s in succs(n):
            indeg[s] += 1
    ready = [n for n in nodes if indeg[n] == 0]
    order: List[N] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for s in succs(n):
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if len(order) != len(nodes):
        raise ValueError("graph has a cycle")
    return order


def sources(nodes: Iterable[N], preds: Callable[[N], Iterable[N]]) -> List[N]:
    return [n for n in nodes if not list(preds(n))]


def sinks(nodes: Iterable[N], succs: Callable[[N], Iterable[N]]) -> List[N]:
    return [n for n in nodes if not list(succs(n))]


def dominators(
    nodes: Iterable[N],
    succs: Callable[[N], Iterable[N]],
    preds: Callable[[N], Iterable[N]],
) -> Dict[N, Set[N]]:
    """dom(n) = {n} ∪ ⋂_{p ∈ preds(n)} dom(p), iterated to fixpoint.

    Multi-source graphs are handled the way the reference does: source nodes
    dominate only themselves.
    """
    order = topo_sort(nodes, succs, preds)
    dom: Dict[N, Set[N]] = {}
    for n in order:
        ps = list(preds(n))
        if not ps:
            dom[n] = {n}
        else:
            acc = set(dom[ps[0]])
            for p in ps[1:]:
                acc &= dom[p]
            acc.add(n)
            dom[n] = acc
    return dom


def post_dominators(
    nodes: Iterable[N],
    succs: Callable[[N], Iterable[N]],
    preds: Callable[[N], Iterable[N]],
) -> Dict[N, Set[N]]:
    """Dominators of the reversed graph (reference dominators.h:243)."""
    return dominators(nodes, preds, succs)


def imm_dominators(
    nodes: Iterable[N],
    succs: Callable[[N], Iterable[N]],
    preds: Callable[[N], Iterable[N]],
) -> Dict[N, N]:
    """Immediate dominator: the dominator closest to n (excluding n itself).

    Sources map to themselves (reference dominators.h:250-310 convention).
    """
    order = topo_sort(nodes, succs, preds)
    depth = {n: i for i, n in enumerate(order)}
    dom = dominators(nodes, succs, preds)
    idom: Dict[N, N] = {}
    for n in order:
        cands = dom[n] - {n}
        idom[n] = max(cands, key=lambda d: depth[d]) if cands else n
    return idom


def imm_post_dominators(
    nodes: Iterable[N],
    succs: Callable[[N], Iterable[N]],
    preds: Callable[[N], Iterable[N]],
) -> Dict[N, N]:
    return imm_dominators(nodes, preds, succs)


def transitive_reduction_edges(
    nodes: Iterable[N],
    succs: Callable[[N], Iterable[N]],
    preds: Callable[[N], Iterable[N]],
) -> Set[tuple]:
    """Return the set of redundant (u, v) edges: v reachable from u without
    the direct edge. Reference: Graph::reduced() (graph.cc:1772)."""
    nodes = list(nodes)
    order = topo_sort(nodes, succs, preds)
    pos = {n: i for i, n in enumerate(order)}
    redundant: Set[tuple] = set()
    for u in nodes:
        direct = list(succs(u))
        direct_set = set(direct)
        for v in direct:
            # BFS from u through successors != the direct edge u->v
            stack = [w for w in direct_set if w is not v and w != v]
            seen: Set[N] = set(stack)
            found = False
            while stack and not found:
                w = stack.pop()
                for x in succs(w):
                    if x == v:
                        found = True
                        break
                    if x not in seen and pos[x] < pos[v]:
                        seen.add(x)
                        stack.append(x)
            if found:
                redundant.add((u, v))
    return redundant


def find_bottleneck_node(
    nodes: Iterable[N],
    succs: Callable[[N], Iterable[N]],
    preds: Callable[[N], Iterable[N]],
) -> Optional[N]:
    """A node through which every source→sink path passes (and that is neither
    a source-only nor sink-only trivial split). Used by the search's sequence
    split (reference graph.cc:1631 find_bottleneck_node): a node that
    post-dominates every source and dominates every sink.
    """
    nodes = list(nodes)
    srcs = sources(nodes, preds)
    snks = sinks(nodes, succs)
    dom = dominators(nodes, succs, preds)
    pdom = post_dominators(nodes, succs, preds)
    order = topo_sort(nodes, succs, preds)
    for n in order:
        if n in srcs or n in snks:
            continue
        if all(n in dom[t] for t in snks) and all(n in pdom[s] for s in srcs):
            return n
    return None
