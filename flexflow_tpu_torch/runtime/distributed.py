"""One process per card (counterpart of flexflow_tpu/runtime/distributed.py).

The reference runs one JAX controller per host and `jax.distributed`
joins them. The port runs one process per card, joined by
torch.distributed:

  - `initialize()` joins the process group: without arguments it reads
    torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) and takes the card LOCAL_RANK names. The backend is NCCL
    for a CUDA device and gloo for the CPU unless the caller names one;
    it is never switched behind the caller's back. Collective timeouts
    are explicit.
  - `broadcast_strategy`, `broadcast_graph`, `broadcast_candidates`,
    `broadcast_stats`, `broadcast_winner_index`: rank 0's search result,
    as JSON, to every rank, so a search that is not deterministic (or
    measures costs) cannot leave two ranks with two programs.
  - `host_local_batch()`: each rank's piece of the global batch (its
    data rank's rows, and where `seq` spans processes its block of the
    sequence), `sync_global_devices()` a barrier.

Launch: `torchrun --nproc-per-node N -m flexflow_tpu_torch script.py
--mesh data=D,seq=S,model=M` (D x S x M = N).
"""

from __future__ import annotations

import json
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
# the timeout initialize() gave the process group; the process mesh's
# groups take the same one
_timeout_s = DEFAULT_TIMEOUT_S


def initialize(backend: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               device: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group (a no-op when already joined) and return
    this rank's device. `device` is "cuda" (the default: the card
    LOCAL_RANK names), "cuda:N" (several ranks may name one card, as
    only gloo allows) or "cpu". `backend` defaults to "nccl" on a CUDA
    device and "gloo" on the CPU. `rank`, `world_size` and `init_method`
    default to torchrun's environment ("env://")."""
    device = device or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"initialize(device={device!r}) on a machine without a "
                "CUDA device: pass device='cpu' for the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    global _timeout_s
    _timeout_s = timeout_s
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend moves CUDA tensors: pass a CUDA "
                         "device, or backend='gloo' for the CPU")
    kw = {}
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            timeout=timedelta(seconds=timeout_s), **kw)
    return dev


def shutdown() -> None:
    """Leave the process group (after a final barrier)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def collective_timeout_s() -> float:
    """The timeout of every collective: initialize()'s `timeout_s`."""
    return _timeout_s


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multi_host() -> bool:
    """More than one process (the reference's name: there, one process
    per host)."""
    return process_count() > 1


def _comm_device() -> torch.device:
    """Where the backend takes tensors: the current card under NCCL, the
    host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast_payload(payload: bytes) -> Optional[bytes]:
    """Rank 0's bytes on every rank: the length, then the buffer. Length
    0 is None (rank 0 had nothing)."""
    dev = _comm_device()
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=0)
    size = int(n.item())
    if size == 0:
        return None
    if process_index() == 0:
        buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
    else:
        buf = torch.empty(size, dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=0)
    return buf.cpu().numpy().tobytes()


def _broadcast_json(obj, none_ok: bool = True):
    if not is_multi_host():
        return obj
    payload = b""
    if process_index() == 0 and obj is not None:
        payload = json.dumps(obj, sort_keys=True).encode()
    got = _broadcast_payload(payload)
    if got is None:
        if not none_ok:
            raise RuntimeError("rank 0 sent nothing where every rank needs "
                               "its value")
        return None
    return json.loads(got.decode())


def strategy_to_json(strategy: Optional[Dict]):
    from flexflow_tpu_torch.parallel.sharding import view_to_json

    if strategy is None:
        return None
    return {k: view_to_json(v) for k, v in sorted(strategy.items())}


def strategy_from_json(d) -> Optional[Dict]:
    from flexflow_tpu_torch.parallel.sharding import view_from_json

    if d is None:
        return None
    return {k: view_from_json(v) for k, v in d.items()}


def broadcast_strategy(strategy: Optional[Dict], mesh=None) -> Optional[Dict]:
    """Every rank takes rank 0's strategy {node name: ShardingView}."""
    if not is_multi_host():
        return strategy
    return strategy_from_json(_broadcast_json(strategy_to_json(strategy)))


def broadcast_graph(graph, strategy: Optional[Dict]):
    """Every rank takes rank 0's graph (the substitution search may have
    rewritten it) and strategy. A graph always exists on rank 0: an empty
    payload raises rather than leave ranks with different graphs."""
    if not is_multi_host():
        return graph, strategy
    from flexflow_tpu_torch.pcg.serialize import graph_from_dict, graph_to_dict

    d = _broadcast_json({"graph": graph_to_dict(graph),
                         "strategy": strategy_to_json(strategy)}
                        if process_index() == 0 else None, none_ok=False)
    return graph_from_dict(d["graph"]), strategy_from_json(d["strategy"])


def broadcast_candidates(candidates: List):
    """Rank 0's timed-playoff pool [(modeled cost, graph, strategy)] on
    every rank, so all ranks time the same candidates in the same order.
    Other ranks pass anything."""
    if not is_multi_host():
        return candidates
    from flexflow_tpu_torch.pcg.serialize import graph_from_dict, graph_to_dict

    got = _broadcast_json(
        [{"cost": c, "graph": graph_to_dict(g),
          "strategy": strategy_to_json(s)} for c, g, s in candidates]
        if process_index() == 0 else None)
    return [(d["cost"], graph_from_dict(d["graph"]),
             strategy_from_json(d["strategy"])) for d in (got or [])]


def broadcast_stats(stats: Dict) -> Dict:
    """Rank 0's search statistics (plain JSON) on every rank."""
    got = _broadcast_json(stats)
    return {} if got is None else got


def broadcast_winner_index(index: int) -> int:
    """Every rank adopts rank 0's playoff winner (the ranks' timings may
    order the candidates differently; the choice may not differ)."""
    if not is_multi_host():
        return index
    t = torch.tensor([index], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def host_local_batch(arrays: Sequence[np.ndarray], specs, pmesh
                     ) -> List[np.ndarray]:
    """Each global batch array's piece on this rank, as its spec cuts it:
    the rows of its data rank where dim 0 is cut, its sequence block
    where dim 1 is cut over `seq`, the whole array otherwise (`specs`
    holds one Spec or None per array)."""
    out = []
    for a, spec in zip(arrays, specs):
        if pmesh is None or spec is None:
            out.append(a)
            continue
        out.append(np.ascontiguousarray(
            pmesh.shard(torch.from_numpy(np.asarray(a)), spec).numpy()))
    return out


def sync_global_devices(tag: str = "barrier") -> None:
    """A barrier over every rank."""
    if is_multi_host():
        dist.barrier()
