"""The Parallel Computation Graph (counterpart of flexflow_tpu/pcg/graph.py).

A DAG of operator nodes with multi-edges carrying (src output index, dst
input index), plus the structural operations the strategy search needs:
sequence split at a bottleneck node, horizontal split of parallel
branches, transitive reduction, copies, the DOT export and a content hash
for DP memoization. Node guids are drawn from the same counter (starting
at 1000) in the same order, so a model built by either package gets the
same node keys.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Set, Tuple

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.pcg import algorithms as alg
from flexflow_tpu_torch.pcg.tensor import ParallelTensorShape


@dataclasses.dataclass(frozen=True, eq=True)
class Edge:
    """Multi-edge: output `src_idx` of node `src` feeds input `dst_idx` of
    node `dst` (reference graph.h Edge{srcOp,dstOp,srcIdx,dstIdx})."""

    src: int
    dst: int
    src_idx: int = 0
    dst_idx: int = 0


@dataclasses.dataclass
class Node:
    """A PCG node: an operator instance.

    `attrs` is the op's attribute dataclass (flexflow_tpu_torch.ops.attrs); it owns
    shape inference and cost accounting. `outputs` caches inferred
    ParallelTensorShapes. `sharding` (assigned by the strategy search or the
    default-DP path) is this op's ShardingView — the MachineView analog.
    """

    guid: int
    op_type: OpType
    attrs: object = None
    name: str = ""
    outputs: Tuple[ParallelTensorShape, ...] = ()
    sharding: object = None  # flexflow_tpu_torch.parallel.sharding.ShardingView
    # input shapes cached at infer_shapes() time so subgraphs produced by
    # search splits (which drop producer nodes) can still be costed
    in_shapes: Tuple[ParallelTensorShape, ...] = ()

    def __hash__(self):
        return hash(self.guid)

    def __eq__(self, other):
        return isinstance(other, Node) and self.guid == other.guid

    def stable_key(self) -> str:
        """The node's stable identity string: the key of its parameters
        and of its KV pool, equal to the JAX package's for the same
        builder calls."""
        return f"{self.name}_{self.guid}"

    def __repr__(self):
        return f"Node({self.guid}:{self.op_type.value}:{self.name})"


class Graph:
    """Mutable PCG DAG with multi-edges."""

    def __init__(self):
        self._nodes: Dict[int, Node] = {}
        self._out: Dict[int, List[Edge]] = {}
        self._in: Dict[int, List[Edge]] = {}
        self._guid_counter = itertools.count(1000)

    # ---- construction ----

    def new_guid(self) -> int:
        return next(self._guid_counter)

    def add_node(self, node: Node) -> Node:
        if node.guid in self._nodes:
            raise ValueError(f"duplicate guid {node.guid}")
        self._nodes[node.guid] = node
        self._out.setdefault(node.guid, [])
        self._in.setdefault(node.guid, [])
        return node

    def create_node(self, op_type: OpType, attrs=None, name: str = "") -> Node:
        node = Node(self.new_guid(), op_type, attrs, name or op_type.value)
        return self.add_node(node)

    def add_edge(self, src: Node, dst: Node, src_idx: int = 0, dst_idx: int = 0):
        e = Edge(src.guid, dst.guid, src_idx, dst_idx)
        self._out[src.guid].append(e)
        self._in[dst.guid].append(e)
        return e

    def remove_edge(self, e: Edge):
        self._out[e.src].remove(e)
        self._in[e.dst].remove(e)

    def remove_node(self, node: Node):
        if self._in[node.guid] or self._out[node.guid]:
            raise ValueError(f"cannot remove {node}: has edges")
        del self._nodes[node.guid]
        del self._in[node.guid]
        del self._out[node.guid]

    # ---- access ----

    @property
    def nodes(self) -> List[Node]:
        return list(self._nodes.values())

    def node(self, guid: int) -> Node:
        return self._nodes[guid]

    def __contains__(self, node: Node) -> bool:
        return node.guid in self._nodes

    def __len__(self) -> int:
        return len(self._nodes)

    def in_edges(self, node: Node) -> List[Edge]:
        """Incoming edges sorted by dst input index."""
        return sorted(self._in[node.guid], key=lambda e: e.dst_idx)

    def out_edges(self, node: Node) -> List[Edge]:
        return list(self._out[node.guid])

    def preds(self, node: Node) -> List[Node]:
        seen, out = set(), []
        for e in self._in[node.guid]:
            if e.src not in seen:
                seen.add(e.src)
                out.append(self._nodes[e.src])
        return out

    def succs(self, node: Node) -> List[Node]:
        seen, out = set(), []
        for e in self._out[node.guid]:
            if e.dst not in seen:
                seen.add(e.dst)
                out.append(self._nodes[e.dst])
        return out

    def input_shapes(self, node: Node) -> List[ParallelTensorShape]:
        shapes = []
        for e in self.in_edges(node):
            shapes.append(self._nodes[e.src].outputs[e.src_idx])
        return shapes

    # ---- algorithms ----

    def topo_order(self) -> List[Node]:
        return alg.topo_sort(self.nodes, self.succs, self.preds)

    def sources(self) -> List[Node]:
        return alg.sources(self.nodes, self.preds)

    def sinks(self) -> List[Node]:
        return alg.sinks(self.nodes, self.succs)

    def dominators(self):
        return alg.dominators(self.nodes, self.succs, self.preds)

    def post_dominators(self):
        return alg.post_dominators(self.nodes, self.succs, self.preds)

    def find_bottleneck_node(self) -> Optional[Node]:
        return alg.find_bottleneck_node(self.nodes, self.succs, self.preds)

    def reduced(self) -> "Graph":
        """Transitive reduction (reference graph.cc:1772) — same nodes,
        redundant edges dropped."""
        redundant = alg.transitive_reduction_edges(self.nodes, self.succs, self.preds)
        g = Graph()
        for n in self.nodes:
            g.add_node(n)
        for n in self.nodes:
            for e in self._out[n.guid]:
                if (self._nodes[e.src], self._nodes[e.dst]) not in redundant:
                    g._out[e.src].append(e)
                    g._in[e.dst].append(e)
        return g

    def infer_shapes(self):
        """Run shape inference over the whole graph in topo order. Each
        node's attrs.infer(input_shapes) -> output shapes. A node whose
        producers live outside this graph (a boundary node of a sequence
        split) keeps its previously inferred shapes — in_shapes/outputs
        are caches stamped when the full graph was inferred."""
        for node in self.topo_order():
            ins = self.input_shapes(node)
            if node.in_shapes and len(ins) < len(node.in_shapes):
                continue  # producers outside this subgraph: keep cache
            node.in_shapes = tuple(ins)
            if node.attrs is not None:
                node.outputs = tuple(node.attrs.infer(*ins))
            # source nodes (INPUT/WEIGHT) must have outputs pre-set

    # ---- structural splits used by the search ----

    def split_at_node(self, node: Node) -> Tuple["Graph", "Graph"]:
        """Sequence split: (prefix including `node`, suffix including `node`)
        — reference graph.cc:958. `node` appears in both halves (it is the
        boundary whose output crosses the cut)."""
        order = self.topo_order()
        pos = {n.guid: i for i, n in enumerate(order)}
        cut = pos[node.guid]
        first, second = Graph(), Graph()
        first._guid_counter = self._guid_counter
        second._guid_counter = self._guid_counter
        for n in order:
            if pos[n.guid] <= cut:
                first.add_node(n)
            if pos[n.guid] >= cut:
                second.add_node(n)
        # An edge goes to `first` if both endpoints are at/before the cut,
        # to `second` if both at/after; the boundary node keeps its in-edges
        # in `first` and out-edges in `second`.
        for n in order:
            for e in self._out[n.guid]:
                s, d = pos[e.src], pos[e.dst]
                if s <= cut and d <= cut:
                    first._out[e.src].append(e)
                    first._in[e.dst].append(e)
                elif s >= cut and d >= cut:
                    second._out[e.src].append(e)
                    second._in[e.dst].append(e)
                else:
                    raise ValueError(
                        f"{node} is not a valid sequence split point: edge {e} crosses it"
                    )
        return first, second

    def split_horizontal(self, include: Set[Node]) -> Tuple["Graph", "Graph"]:
        """Parallel-branch split (reference graph.cc:1113): partition nodes
        into `include` and the rest; no edges may cross."""
        a, b = Graph(), Graph()
        a._guid_counter = self._guid_counter
        b._guid_counter = self._guid_counter
        inc = {n.guid for n in include}
        for n in self.nodes:
            (a if n.guid in inc else b).add_node(n)
        for n in self.nodes:
            for e in self._out[n.guid]:
                if (e.src in inc) != (e.dst in inc):
                    raise ValueError(f"edge {e} crosses horizontal split")
                g = a if e.src in inc else b
                g._out[e.src].append(e)
                g._in[e.dst].append(e)
        return a, b

    def connected_components(self, within: Set[Node]) -> List[Set[Node]]:
        """Weakly-connected components of the subgraph induced on `within`:
        only edges with BOTH endpoints inside couple nodes. Used for
        horizontal splits (around a bottleneck, or of independently
        searchable regions in the view DP)."""
        keep = {n.guid for n in within}
        seen: Set[int] = set()
        comps: List[Set[Node]] = []
        adj: Dict[int, Set[int]] = {g: set() for g in keep}
        for g in keep:
            for e in self._out[g]:
                if e.dst in keep:
                    adj[e.src].add(e.dst)
                    adj[e.dst].add(e.src)
            for e in self._in[g]:
                if e.src in keep:
                    adj[e.src].add(e.dst)
                    adj[e.dst].add(e.src)
        for g0 in keep:
            if g0 in seen:
                continue
            comp, stack = set(), [g0]
            while stack:
                g = stack.pop()
                if g in seen:
                    continue
                seen.add(g)
                comp.add(self._nodes[g])
                stack.extend(adj[g] - seen)
            comps.append(comp)
        return comps

    def connected_components_ignoring(self, node: Node) -> List[Set[Node]]:
        """Weakly-connected components of the graph with `node` removed."""
        return self.connected_components(
            {n for n in self.nodes if n.guid != node.guid}
        )

    # ---- hashing / export ----

    def structure_hash(self) -> int:
        """Content hash for DP memoization (reference dp_state_hash
        graph.cc:1863): op types + attrs + shardings + edge structure,
        independent of guid numbering."""
        order = self.topo_order()
        idx = {n.guid: i for i, n in enumerate(order)}
        items: List = []
        for n in order:
            items.append(
                (
                    n.op_type.value,
                    repr(n.attrs),
                    repr(n.sharding),
                    tuple(
                        (idx[e.src], e.src_idx, e.dst_idx)
                        for e in self.in_edges(n)
                    ),
                )
            )
        return hash(tuple(items))

    def copy(self) -> "Graph":
        g = Graph()
        g._guid_counter = self._guid_counter
        for n in self.nodes:
            g.add_node(
                Node(n.guid, n.op_type, n.attrs, n.name, n.outputs,
                     n.sharding, n.in_shapes)
            )
        for n in self.nodes:
            for e in self._out[n.guid]:
                g._out[e.src].append(e)
                g._in[e.dst].append(e)
        return g

    def to_dot(self, include_shapes: bool = True, costs: Optional[Dict] = None) -> str:
        """GraphViz export (reference Graph::print_dot graph.cc:446 and
        export_strategy_computation_graph)."""
        lines = ["digraph PCG {", "  node [shape=record];"]
        for n in self.topo_order():
            label = f"{n.name}"
            if include_shapes and n.outputs:
                label += "|" + ", ".join(str(o) for o in n.outputs)
            if n.sharding is not None:
                label += f"|{n.sharding}"
            if costs and n.guid in costs:
                label += f"|{costs[n.guid]:.3g}ms"
            label = label.replace("[", "\\[").replace("]", "\\]")
            lines.append(f'  n{n.guid} [label="{{{label}}}"];')
        for n in self.nodes:
            for e in self._out[n.guid]:
                lines.append(f"  n{e.src} -> n{e.dst};")
        lines.append("}")
        return "\n".join(lines)
