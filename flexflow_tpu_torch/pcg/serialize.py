"""Whole-PCG JSON serialization (counterpart of
flexflow_tpu/pcg/serialize.py).

The wire format is the JAX package's: nodes (guid, op type, attrs
dataclass, name, sharding), multi-edges and the guid watermark. Attrs
encode generically (every op attribute class is a frozen dataclass of
scalars, tuples, enums and TensorShapes) as {"$dc": [class name,
fields]}, {"$enum": [enum, member]} and {"$shape": [dims, dtype]}, so
each package reads the other's `pcg.json` (a checkpoint's graph).
Node shardings (the strategy search's ShardingViews) travel in
parallel/sharding.py's JSON form, and the parallel ops' attrs classes
(parallel/parallel_ops.py) encode like the ops'.

Round trip: `graph_from_json(graph_to_json(g))` reproduces guids, attrs,
shardings, edges and `structure_hash()`.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import json
from typing import Dict, Optional

from flexflow_tpu_torch.ffconst import (
    ActiMode,
    AggrMode,
    DataType,
    OpType,
    PoolType,
)
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.pcg.tensor import TensorShape

_ENUMS = {cls.__name__: cls for cls in
          (ActiMode, AggrMode, DataType, OpType, PoolType)}

_REGISTRY: Optional[Dict[str, type]] = None


def _attrs_registry() -> Dict[str, type]:
    """Every OpAttrs subclass by class name (ops + parallel ops)."""
    global _REGISTRY
    if _REGISTRY is None:
        import flexflow_tpu_torch.ops.attrs as A
        import flexflow_tpu_torch.parallel.parallel_ops as P
        from flexflow_tpu_torch.ops.base import OpAttrs

        _REGISTRY = {
            obj.__name__: obj for mod in (A, P) for obj in vars(mod).values()
            if isinstance(obj, type) and issubclass(obj, OpAttrs)
            and obj is not OpAttrs}
    return _REGISTRY


def _enc(v):
    if isinstance(v, enum.Enum):
        return {"$enum": [type(v).__name__, v.name]}
    if isinstance(v, TensorShape):
        return {"$shape": [list(v.dims), _enc(v.dtype)]}
    if isinstance(v, (tuple, list)):
        return [_enc(x) for x in v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"$dc": [
            type(v).__name__,
            {f.name: _enc(getattr(v, f.name))
             for f in dataclasses.fields(v)},
        ]}
    return v


def _dec(v):
    if isinstance(v, list):
        # frozen attrs dataclasses store sequences as (hashable) tuples
        return tuple(_dec(x) for x in v)
    if isinstance(v, dict):
        if "$enum" in v:
            cls_name, member = v["$enum"]
            return _ENUMS[cls_name][member]
        if "$shape" in v:
            dims, dt = v["$shape"]
            return TensorShape(tuple(int(d) for d in dims), _dec(dt))
        if "$dc" in v:
            cls_name, fields = v["$dc"]
            cls = _attrs_registry()[cls_name]
            return cls(**{k: _dec(x) for k, x in fields.items()})
    return v


def graph_to_dict(graph: Graph) -> Dict:
    from flexflow_tpu_torch.parallel.sharding import view_to_json

    nodes = []
    max_guid = 0
    for n in graph.nodes:
        max_guid = max(max_guid, n.guid)
        nodes.append({
            "guid": n.guid,
            "op": n.op_type.name,
            "attrs": _enc(n.attrs) if n.attrs is not None else None,
            "name": n.name,
            "sharding": (view_to_json(n.sharding)
                         if n.sharding is not None else None),
        })
    edges = [
        [e.src, e.dst, e.src_idx, e.dst_idx]
        for n in graph.nodes for e in graph.out_edges(n)
    ]
    return {"nodes": nodes, "edges": edges, "next_guid": max_guid + 1}


def graph_to_json(graph: Graph) -> str:
    return json.dumps(graph_to_dict(graph))


def graph_from_dict(d: Dict) -> Graph:
    from flexflow_tpu_torch.parallel.sharding import view_from_json

    g = Graph()
    for spec in d["nodes"]:
        n = Node(spec["guid"], OpType[spec["op"]],
                 _dec(spec["attrs"]) if spec["attrs"] is not None else None,
                 spec["name"])
        n.sharding = view_from_json(spec["sharding"])
        g.add_node(n)
    for src, dst, si, di in d["edges"]:
        g.add_edge(g.node(src), g.node(dst), si, di)
    g._guid_counter = itertools.count(d["next_guid"])
    g.infer_shapes()
    return g


def graph_from_json(payload: str) -> Graph:
    return graph_from_dict(json.loads(payload))
