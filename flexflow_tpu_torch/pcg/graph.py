"""The Parallel Computation Graph (counterpart of flexflow_tpu/pcg/graph.py).

A DAG of operator nodes with multi-edges carrying (src output index, dst
input index). The port keeps what the builder and the executor need:
construction, topological order, shape inference and the structure hash.
Node guids are drawn from the same counter (starting at 1000) in the same
order, so a model built by either package gets the same node keys.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Tuple

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.pcg.tensor import ParallelTensorShape


@dataclasses.dataclass(frozen=True, eq=True)
class Edge:
    """Output `src_idx` of node `src` feeds input `dst_idx` of `dst`."""

    src: int
    dst: int
    src_idx: int = 0
    dst_idx: int = 0


@dataclasses.dataclass
class Node:
    """A PCG node: an operator instance with its attrs and the output
    shapes shape inference gave it."""

    guid: int
    op_type: OpType
    attrs: object = None
    name: str = ""
    outputs: Tuple[ParallelTensorShape, ...] = ()
    sharding: object = None
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
        return self.add_node(
            Node(self.new_guid(), op_type, attrs, name or op_type.value))

    def add_edge(self, src: Node, dst: Node, src_idx: int = 0,
                 dst_idx: int = 0) -> Edge:
        e = Edge(src.guid, dst.guid, src_idx, dst_idx)
        self._out[src.guid].append(e)
        self._in[dst.guid].append(e)
        return e

    @property
    def nodes(self) -> List[Node]:
        return list(self._nodes.values())

    def node(self, guid: int) -> Node:
        return self._nodes[guid]

    def __len__(self) -> int:
        return len(self._nodes)

    def in_edges(self, node: Node) -> List[Edge]:
        """Incoming edges sorted by dst input index."""
        return sorted(self._in[node.guid], key=lambda e: e.dst_idx)

    def out_edges(self, node: Node) -> List[Edge]:
        return list(self._out[node.guid])

    def preds(self, node: Node) -> List[Node]:
        return list(dict.fromkeys(self._nodes[e.src]
                                  for e in self._in[node.guid]))

    def succs(self, node: Node) -> List[Node]:
        return list(dict.fromkeys(self._nodes[e.dst]
                                  for e in self._out[node.guid]))

    def input_shapes(self, node: Node) -> List[ParallelTensorShape]:
        return [self._nodes[e.src].outputs[e.src_idx]
                for e in self.in_edges(node)]

    def topo_order(self) -> List[Node]:
        """Kahn order over insertion order: the same order the JAX
        package's pcg.algorithms.topo_sort gives."""
        nodes = self.nodes
        indeg = {n: 0 for n in nodes}
        for n in nodes:
            for s in self.succs(n):
                indeg[s] += 1
        ready = [n for n in nodes if indeg[n] == 0]
        order: List[Node] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in self.succs(n):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(nodes):
            raise ValueError("graph has a cycle")
        return order

    def sources(self) -> List[Node]:
        return [n for n in self.nodes if not self.preds(n)]

    def sinks(self) -> List[Node]:
        return [n for n in self.nodes if not self.succs(n)]

    def infer_shapes(self):
        """Shape inference over the whole graph in topo order."""
        for node in self.topo_order():
            ins = self.input_shapes(node)
            node.in_shapes = tuple(ins)
            if node.attrs is not None:
                node.outputs = tuple(node.attrs.infer(*ins))

    def structure_hash(self) -> int:
        """Content hash: op types + attrs + shardings + edge structure,
        independent of guid numbering (the reference's dp_state_hash)."""
        order = self.topo_order()
        idx = {n.guid: i for i, n in enumerate(order)}
        return hash(tuple(
            (n.op_type.value, repr(n.attrs), repr(n.sharding),
             tuple((idx[e.src], e.src_idx, e.dst_idx)
                   for e in self.in_edges(n)))
            for n in order))
