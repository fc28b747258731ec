"""Checkpoint and resume (counterpart of flexflow_tpu/runtime/checkpoint.py).

A checkpoint is a directory in the JAX package's npz format, so either
package restores the other's:
- `arrays.npz`: every leaf of {"trainable", "nontrainable", "opt_state"}
  under its tree path joined by "\\x1f" (node names may hold "/"), e.g.
  "trainable\\x1f<node key>\\x1f<weight>", "opt_state\\x1fm\\x1f...", and
  "opt_state\\x1fstep" as a 0-d int32;
- `meta.json`: step count, seed, backend, extra, the FFConfig fields a
  rebuild needs, loss, metrics and the optimizer's dataclass fields;
- `strategy.json`: the node shardings, {} on one card;
- `pcg.json`: the whole graph (pcg/serialize.py), from which
  `restore_model` rebuilds the model without its builder code.

bfloat16 leaves, which numpy lacks, are written as the JAX package writes
them (ml_dtypes' bfloat16 saves as raw 2-byte "|V2" records) and read back
through an int16 view into torch.bfloat16, never through a cast. Restore
puts each leaf on the model's device in the dtype of the leaf it replaces.

On a process mesh (one process per card) every rank calls save: each
whole leaf is gathered from the ranks' pieces (the optimizer state's
ZeRO-1 slices too) and rank 0 writes, so the files are those of a
one-card save and either package restores them. Every rank restores,
each keeping its pieces of the whole leaves. The orbax backend (each
process writing its own shards) is ROADMAP.md queue 1 item 12 and raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

_SEP = "\x1f"
_ORBAX = ("the orbax backend (each process writing its own shards, the "
          "DCP counterpart) is not ported yet; the npz backend gathers "
          "whole leaves on rank 0 (ROADMAP.md queue 1 item 12)")
_BF16_RECORD = np.dtype("V2")


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split(_SEP)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def to_numpy(leaf) -> np.ndarray:
    """One state leaf as the numpy array the npz file holds: a Python
    int (the optimizer's step) as 0-d int32; bfloat16, which numpy lacks,
    as raw 2-byte records ("|V2", as ml_dtypes' bfloat16 saves)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, np.int32)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(_BF16_RECORD)
    return t.cpu().numpy()


def from_numpy(arr: np.ndarray, like) -> Any:
    """A saved array in the place of the current leaf `like`: its dtype
    and device (an int for the optimizer's step); 2-byte records are
    bfloat16 bits, taken through an int16 view, not a cast."""
    if not isinstance(like, torch.Tensor):
        return int(arr)
    if arr.dtype == _BF16_RECORD:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _state(ffmodel) -> Dict:
    """The saved trees, whole leaves (gathered on a process mesh)."""
    tr, ntr = ffmodel._params
    opt = ffmodel._opt_state or {}
    if ffmodel._pmesh is None:
        return {"trainable": tr, "nontrainable": ntr, "opt_state": opt}
    ex, pm = ffmodel.executor, ffmodel._pmesh
    specs = ex.opt_state_specs(opt)
    return {"trainable": ex.gather_params(tr),
            "nontrainable": ex.gather_params(ntr),
            "opt_state": {k: ({nk: {wn: pm.gather(t, specs[k][nk][wn])
                                    for wn, t in ws.items()}
                               for nk, ws in v.items()}
                              if k in specs else v)
                          for k, v in opt.items()}}


def _specs(ffmodel) -> Optional[Dict]:
    """The Spec of every saved leaf, shaped like _state's trees (None on
    one process)."""
    if ffmodel._pmesh is None:
        return None
    ex = ffmodel.executor
    ps = ex.param_specs()
    return {"trainable": ps, "nontrainable": ps,
            "opt_state": ex.opt_state_specs(ffmodel._opt_state or {})}


def save_checkpoint(path: str, ffmodel, extra: Optional[Dict] = None,
                    backend: str = "npz"):
    """Save the weights, the optimizer state and the training metadata
    under directory `path` (see the module docstring for its files)."""
    if backend != "npz":
        raise NotImplementedError(f"backend={backend!r}: {_ORBAX}")
    from flexflow_tpu_torch.pcg.serialize import graph_to_json

    from flexflow_tpu_torch.runtime import distributed as dist

    state = _state(ffmodel)
    if dist.process_index() != 0:
        dist.sync_global_devices("checkpoint")
        return
    os.makedirs(path, exist_ok=True)
    arrays = {k: to_numpy(v) for k, v in _flatten(state).items()}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    opt = ffmodel._optimizer
    opt_spec = None
    if opt is not None:
        if dataclasses.is_dataclass(opt):
            opt_spec = {"cls": type(opt).__name__,
                        "fields": dataclasses.asdict(opt)}
        else:
            warnings.warn(
                f"optimizer {type(opt).__name__} is not a dataclass and "
                "cannot be serialized; restore_model will require an "
                "explicit optimizer= argument")
    cfg = ffmodel.config
    meta = {
        "step_count": ffmodel._step_count,
        "seed": cfg.seed,
        "backend": backend,
        "extra": extra or {},
        "config": {
            "batch_size": cfg.batch_size,
            "mesh_shape": dict(cfg.mesh_shape or {}),
            "seed": cfg.seed,
            "seq_length": cfg.seq_length,
            "remat": cfg.remat,
            "param_sync": cfg.param_sync.name,
            "donate_buffers": cfg.donate_buffers,
        },
        "loss_type": ffmodel._loss_type.name,
        "metrics": [m.name for m in ffmodel._metrics],
        "optimizer": opt_spec,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    # the node shardings, as --export-strategy writes them ({} when no
    # node carries one)
    from flexflow_tpu_torch.parallel.sharding import view_to_json

    with open(os.path.join(path, "strategy.json"), "w") as f:
        json.dump({n.name: view_to_json(n.sharding)
                   for n in ffmodel.graph.nodes if n.sharding is not None},
                  f, indent=1)
    with open(os.path.join(path, "pcg.json"), "w") as f:
        f.write(graph_to_json(ffmodel.graph))
    dist.sync_global_devices("checkpoint")


def _read_meta(path: str) -> Dict:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (missing meta.json)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("backend") == "orbax" \
            or os.path.isdir(os.path.join(path, "state")):
        raise NotImplementedError(f"checkpoint {path!r}: {_ORBAX}")
    return meta


def restore_checkpoint(path: str, ffmodel) -> Dict:
    """Restore the weights, optimizer state and step count saved under
    `path` into a compiled FFModel with the same leaves: a missing leaf
    raises KeyError, a leaf of another shape ValueError. Returns the saved
    metadata. A model compiled without an optimizer (a serving model)
    takes the weights alone."""
    meta = _read_meta(path)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        state = _unflatten({k: data[k] for k in data.files})

    pm = ffmodel._pmesh
    specs = _specs(ffmodel) or {}

    def put_like(saved: Dict, current: Dict, spec: Optional[Dict]) -> Dict:
        out = {}
        for k, cur in current.items():
            if isinstance(cur, dict):
                out[k] = put_like(saved.get(k, {}), cur,
                                  (spec or {}).get(k))
                continue
            if k not in saved:
                raise KeyError(f"checkpoint missing parameter {k}")
            arr = saved[k]
            shape = tuple(cur.shape) if isinstance(cur, torch.Tensor) \
                else ()
            cut = (spec or {}).get(k) if pm is not None else None
            if cut is not None:
                # the whole leaf this rank's piece comes from
                shape = tuple(n * pm.degree(a)
                              for n, a in zip(shape, cut))
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint shape mismatch for {k}: "
                                 f"{arr.shape} vs {shape}")
            t = from_numpy(arr, cur)
            out[k] = pm.shard(t, cut).clone() if cut is not None else t
        return out

    tr, ntr = ffmodel._params
    ffmodel._params = (
        put_like(state.get("trainable", {}), tr, specs.get("trainable")),
        put_like(state.get("nontrainable", {}), ntr,
                 specs.get("nontrainable")))
    if ffmodel._opt_state is not None:
        ffmodel._opt_state = put_like(state.get("opt_state", {}),
                                      ffmodel._opt_state,
                                      specs.get("opt_state"))
    ffmodel._step_count = meta.get("step_count", 0)
    return meta


def periodic_save(ckpt_dir: str, ffmodel, *,
                  backend: Optional[str] = None) -> str:
    """One periodic checkpoint under `ckpt_dir/step_N` and a
    `latest.json` pointer to it (its base name, rejoined with ckpt_dir on
    restore, so a resume from another working directory finds it),
    replaced atomically so a crash mid-write never corrupts it. fit calls
    this every config.checkpoint_every steps; the backend is npz."""
    step = ffmodel._step_count
    name = f"step_{step}"
    path = os.path.join(ckpt_dir, name)
    save_checkpoint(path, ffmodel, backend=backend or "npz")
    tmp = os.path.join(ckpt_dir, ".latest.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"name": name, "step": step}, f)
    os.replace(tmp, os.path.join(ckpt_dir, "latest.json"))
    return path


def _latest(ckpt_dir: str) -> str:
    with open(os.path.join(ckpt_dir, "latest.json")) as f:
        return os.path.join(ckpt_dir, json.load(f)["name"])


def restore_latest(ckpt_dir: str, ffmodel) -> Dict:
    """Resume from the newest periodic checkpoint in `ckpt_dir`."""
    return restore_checkpoint(_latest(ckpt_dir), ffmodel)


def restore_latest_model(ckpt_dir: str, config=None, optimizer=None,
                         device: Optional[str] = None):
    """restore_model from the newest periodic checkpoint in `ckpt_dir`:
    crash recovery without the model's builder code."""
    return restore_model(_latest(ckpt_dir), config=config,
                         optimizer=optimizer, device=device)


def restore_model(path: str, config=None, optimizer=None,
                  device: Optional[str] = None):
    """A ready-to-train FFModel rebuilt from the checkpoint alone: the
    graph from pcg.json, the FFConfig from meta.json's fields, compiled
    with the saved optimizer, loss and metrics, then restored. `config`
    replaces the saved FFConfig (its `device` included); otherwise the
    saved fields run on `device` (the card when None). `optimizer`
    replaces the saved one (needed when that was not a dataclass). The
    saved metadata lands on the model as `ff.restored_meta`."""
    from flexflow_tpu_torch import ffconst
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.pcg.serialize import graph_from_json
    from flexflow_tpu_torch.runtime import optimizer as opt_mod

    meta = _read_meta(path)
    with open(os.path.join(path, "pcg.json")) as f:
        graph = graph_from_json(f.read())
    saved = meta["config"]
    cfg = config or FFConfig(
        batch_size=saved["batch_size"],
        mesh_shape=saved["mesh_shape"] or None,
        seed=saved["seed"],
        seq_length=saved["seq_length"],
        remat=saved["remat"],
        param_sync=ffconst.ParamSyncType[saved["param_sync"]],
        donate_buffers=saved["donate_buffers"],
        device=device or "cuda")
    opt = optimizer
    if opt is None:
        spec = meta.get("optimizer")
        if not spec:
            raise ValueError(
                "checkpoint has no serialized optimizer (the original was "
                "not a dataclass); pass optimizer= explicitly")
        cls = getattr(opt_mod, spec["cls"], None)
        if not (isinstance(cls, type)
                and issubclass(cls, opt_mod.Optimizer)):
            raise ValueError(f"unknown optimizer class {spec['cls']!r} in "
                             "checkpoint; pass optimizer= explicitly")
        opt = cls(**spec["fields"])
    ff = FFModel(cfg)
    ff.graph = graph
    ff._used_names = {n.name for n in graph.nodes}
    ff.compile(optimizer=opt,
               loss_type=ffconst.LossType[meta["loss_type"]],
               metrics=[ffconst.MetricsType[m] for m in meta["metrics"]])
    ff.restored_meta = restore_checkpoint(path, ff)
    return ff
