"""Executor: runs a PCG eagerly on one device (counterpart of
flexflow_tpu/runtime/executor.py, inference only).

Where the JAX package traces the topo-order walk into one jitted XLA
program, the port walks the same order eagerly, calling each node's
PyTorch lowering (ops/torch_ops.py). The serving slice needs parameter
creation, the paged KV pools and the one ragged step; training (loss,
backward, optimizers) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.registry import LowerCtx, get_lowering
from flexflow_tpu_torch.pcg.graph import Graph, Node
from flexflow_tpu_torch.runtime import initializer as init_mod

# weights whose lowering computes in fp32 whatever the activation dtype:
# stored fp32 so their values equal the reference's fp32 masters
_FP32_USE = {(OpType.RMS_NORM, "scale")}


def node_key(node: Node) -> str:
    return node.stable_key()


class Executor:
    """Owns the eager step functions for one compiled PCG on `device`."""

    def __init__(self, graph: Graph, device: torch.device):
        self.graph = graph
        self.device = torch.device(device)
        self.topo = graph.topo_order()
        self.input_nodes = [n for n in self.topo if n.op_type == OpType.INPUT]
        sinks = graph.sinks()
        if len(sinks) != 1:
            raise ValueError(f"PCG must have exactly one sink, got {sinks}")
        self.sink = sinks[0]

    # ------------------------------------------------------------------
    # parameters

    def weight_specs(self) -> Dict[str, Dict[str, Any]]:
        """(node_key -> weight name -> WeightSpec) for all ops with weights."""
        out = {}
        for n in self.topo:
            if n.attrs is None or n.op_type == OpType.INPUT:
                continue
            ws = n.attrs.weights(*self.graph.input_shapes(n))
            if ws:
                out[node_key(n)] = ws
        return out

    def storage_dtype(self, node: Node, weight_name: str, spec) -> torch.dtype:
        """The dtype a weight is stored in. The reference keeps fp32
        masters and casts each to its use-site dtype inside the lowering
        (the activation dtype, or fp32 for the norm scales); storing the
        use-site dtype directly gives the same values with half the
        memory of fp32 masters for a bf16 model."""
        if (node.op_type, weight_name) in _FP32_USE:
            return torch.float32
        return spec.shape.dtype.torch_dtype

    def init_params(self, seed: int):
        """Draw (trainable, nontrainable) parameter trees on the device.
        Leaf i (in sorted (node key, weight name) order) draws from its own
        torch.Generator on the device, seeded from (seed, i), so the
        values do not depend on which other leaves exist or in which
        order they are drawn. Each leaf is drawn in fp32 and stored at
        its storage dtype."""
        specs = self.weight_specs()
        by_key = {node_key(n): n for n in self.topo}
        index = {}
        for nk, ws in sorted(specs.items()):
            for wn in sorted(ws):
                index[(nk, wn)] = len(index)
        tr, ntr = {}, {}
        for nk, ws in specs.items():
            for wn, spec in ws.items():
                ini = init_mod.resolve(spec.initializer)
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed * 1_000_003 + index[(nk, wn)])
                arr = ini(gen, spec.shape.dims, torch.float32, self.device)
                arr = arr.to(self.storage_dtype(by_key[nk], wn, spec))
                (tr if spec.trainable else ntr).setdefault(nk, {})[wn] = arr
        return tr, ntr

    # ------------------------------------------------------------------
    # forward

    def run_forward(self, trainable, nontrainable, inputs: Sequence, *,
                    kv_caches=None, cache_position=None, cache_out=None,
                    page_tables=None, ragged=None):
        """Topo-order evaluation; returns the sink output. With
        `kv_caches` + `page_tables` attention nodes run the PAGED step:
        kv_caches are per-node {"k", "v"} page pools, updated in place and
        reported in `cache_out`, and `ragged` = (q_lens, depths, anc) is the
        per-entry work descriptor (causal-chain default when None)."""
        values: Dict[Tuple[int, int], Any] = {}
        if len(inputs) != len(self.input_nodes):
            raise ValueError(f"expected {len(self.input_nodes)} inputs, "
                             f"got {len(inputs)}")
        for n, x in zip(self.input_nodes, inputs):
            values[(n.guid, 0)] = x
        if page_tables is not None and ragged is None:
            from flexflow_tpu_torch.paged.attention import chain_descriptor

            ragged = chain_descriptor(inputs[0].shape[0], inputs[0].shape[1],
                                      device=inputs[0].device)
        q_lens, depths, anc = ragged if ragged is not None else (None,) * 3
        for n in self.topo:
            if n.op_type == OpType.INPUT:
                continue
            key = node_key(n)
            ins = [values[(e.src, e.src_idx)] for e in self.graph.in_edges(n)]
            params = {**trainable.get(key, {}), **nontrainable.get(key, {})}
            ctx = LowerCtx(
                device=self.device, node_guid=n.guid,
                kv_cache=(kv_caches.get(key) if kv_caches is not None
                          else None),
                cache_position=cache_position, page_tables=page_tables,
                ragged_q_lens=q_lens, ragged_depths=depths, ragged_anc=anc)
            outs = get_lowering(n.op_type)(n.attrs, ins, params, ctx)
            for i, o in enumerate(outs):
                values[(n.guid, i)] = o
            if ctx.cache_updates and cache_out is not None:
                cache_out[key] = dict(ctx.cache_updates)
        return values[(self.sink.guid, 0)]

    # ------------------------------------------------------------------
    # paged KV pools + the ragged step

    def paged_kv_cache_specs(self, num_pages: int, page_size: int,
                             dtype: Optional[torch.dtype] = None
                             ) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype]]]:
        """{node key: {"k"/"v": (shape, dtype)}} of the paged K/V pools:
        (num_pages, page_size, Hkv, D) per attention node, at the
        attention's activation dtype unless `dtype` is given."""
        specs = {}
        for n in self.topo:
            if n.op_type == OpType.PIPELINE:
                raise ValueError("paged decode does not support PIPELINE "
                                 "composite graphs")
            if n.op_type not in (OpType.MULTIHEAD_ATTENTION,
                                 OpType.RING_ATTENTION):
                continue
            ins = self.graph.input_shapes(n)
            dt = dtype or (ins[0].dtype.torch_dtype if ins
                           else torch.bfloat16)
            shape = (num_pages, page_size, n.attrs.num_kv, n.attrs.kdim)
            specs[node_key(n)] = {"k": (shape, dt), "v": (shape, dt)}
        if not specs:
            raise ValueError("paged decode needs attention nodes "
                             "(MULTIHEAD_ATTENTION or RING_ATTENTION)")
        return specs

    def init_paged_kv_cache(self, num_pages: int, page_size: int,
                            dtype: Optional[torch.dtype] = None):
        """Per-attention-node zeroed K/V page pools on the device."""
        return {key: {name: torch.zeros(shape, dtype=dt, device=self.device)
                      for name, (shape, dt) in bufs.items()}
                for key, bufs in self.paged_kv_cache_specs(
                    num_pages, page_size, dtype).items()}

    @torch.inference_mode()
    def ragged_step_fn(self, trainable, nontrainable, caches, page_tables,
                       pos, q_lens, depths, anc, ids):
        """(params, pools, page_tables, pos, q_lens, depths, anc, ids) ->
        (probs, pools): ONE ragged paged step over a packed batch of work
        items — decode rows and prefill chunk pieces in the same call.
        Entry b carries q_lens[b] live rows of the (B, S) ids window,
        writing K/V at pos[b]..pos[b]+q_lens[b]-1 through its table row;
        entries padded to the launch shape pass q_len 0 and do no work.
        The pools are updated in place and returned. (The reference's
        ragged_step_fn() returns a jitted step; here the method is the
        step.)"""
        cache_out: Dict[str, Dict[str, torch.Tensor]] = {}
        out = self.run_forward(
            trainable, nontrainable, [ids], kv_caches=caches,
            cache_position=pos, cache_out=cache_out,
            page_tables=page_tables, ragged=(q_lens, depths, anc))
        return out, cache_out
