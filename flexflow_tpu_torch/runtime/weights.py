"""Carrying parameters between packages.

The port keeps the JAX package's parameter layout — the same node keys
(`Node.stable_key()`), weight names and array shapes — so weights move
over with no reshaping: only the dtype and the device change, and only
the device unless a dtype is asked for, so fp32 masters stay fp32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Dict[str, torch.Tensor]]


def params_from_numpy(trainable: Dict[str, Dict[str, np.ndarray]],
                      nontrainable: Dict[str, Dict[str, np.ndarray]],
                      device, dtype: Optional[torch.dtype] = None
                      ) -> Tuple[Params, Params]:
    """(trainable, nontrainable) trees of arrays keyed node key -> weight
    name (e.g. the JAX package's `ff._params`, each leaf passed through
    np.asarray) -> the port's parameter trees on `device`. Floating
    leaves are cast to `dtype` when it is given; integer leaves keep
    theirs."""

    def convert(tree):
        out: Params = {}
        for nk, ws in tree.items():
            out[nk] = {}
            for wn, arr in ws.items():
                t = torch.from_numpy(np.array(arr, copy=True))
                if dtype is not None and t.is_floating_point():
                    t = t.to(dtype)
                out[nk][wn] = t.to(device)
        return out

    return convert(trainable), convert(nontrainable)


def params_to_numpy(trainable: Params, nontrainable: Params
                    ) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                               Dict[str, Dict[str, np.ndarray]]]:
    """The inverse of params_from_numpy: the port's parameter trees as
    numpy arrays on the host, each leaf in its own dtype (bfloat16 leaves,
    which numpy lacks, come back as float32)."""

    def convert(tree):
        return {nk: {wn: (t.detach().float() if t.dtype == torch.bfloat16
                          else t.detach()).cpu().numpy()
                     for wn, t in ws.items()}
                for nk, ws in tree.items()}

    return convert(trainable), convert(nontrainable)
