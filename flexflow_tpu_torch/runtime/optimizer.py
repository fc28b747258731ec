"""Optimizers: SGD (momentum, nesterov) and Adam(W) (counterpart of
flexflow_tpu/runtime/optimizer.py).

The same hyper-parameters and update math as the reference, on trees of
tensors keyed node key -> weight name. Where the reference's optimizers
are pure (`update` returns new trees), the port's update the parameters
and the state IN PLACE under torch.no_grad(), so a step holds one copy of
the weights and of the moments; `update` returns the same trees. Every
update computes in fp32 and rounds only on store.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaves(*trees):
    """(node key, weight name, leaf of each tree) over the first tree."""
    for nk, ws in trees[0].items():
        for wn in ws:
            yield tuple(t[nk][wn] for t in trees)


def _zeros_like(params: Tree, dtype: torch.dtype) -> Tree:
    return {nk: {wn: torch.zeros_like(p, dtype=dtype) for wn, p in ws.items()}
            for nk, ws in params.items()}


class Optimizer:
    def init_state(self, params: Tree) -> Dict[str, Any]:
        raise NotImplementedError

    def update(self, grads: Tree, params: Tree, state) -> Tuple[Tree, Any]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SGDOptimizer(Optimizer):
    """SGD with momentum and weight decay (the reference's lr, momentum,
    nesterov, weight_decay)."""

    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init_state(self, params: Tree):
        state = {"step": 0}
        if self.momentum != 0.0:
            state["v"] = _zeros_like(params, torch.float32)
        return state

    @torch.no_grad()
    def update(self, grads: Tree, params: Tree, state):
        if self.momentum == 0.0:
            for g, p in _leaves(grads, params):
                g = g.float() + self.weight_decay * p.float()
                p.copy_(p.float() - self.lr * g)
        else:
            for g, p, v in _leaves(grads, params, state["v"]):
                g = g.float() + self.weight_decay * p.float()
                v.mul_(self.momentum).add_(g)
                step = v * self.momentum + g if self.nesterov else v
                p.copy_(p.float() - self.lr * step)
        state["step"] += 1
        return params, state


@dataclasses.dataclass(frozen=True)
class AdamOptimizer(Optimizer):
    """Adam with bias correction (the reference's alpha, beta1, beta2,
    weight_decay, epsilon); `adamw=True` decouples the weight decay.
    `state_dtype` is the moments' storage dtype ("float32" or
    "bfloat16"); the update math always runs in fp32."""

    lr: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    adamw: bool = True
    state_dtype: str = "float32"

    def init_state(self, params: Tree):
        dt = _STATE_DTYPES[self.state_dtype]
        return {"step": 0, "m": _zeros_like(params, dt),
                "v": _zeros_like(params, dt)}

    @torch.no_grad()
    def update(self, grads: Tree, params: Tree, state):
        step = state["step"] + 1
        # the bias corrections in fp32, as the reference's
        # beta ** step.astype(float32)
        bc1 = 1.0 - torch.tensor(self.beta1, dtype=torch.float32) ** step
        bc2 = 1.0 - torch.tensor(self.beta2, dtype=torch.float32) ** step
        bc1, bc2 = float(bc1), float(bc2)
        for g, p, m_s, v_s in _leaves(grads, params, state["m"], state["v"]):
            g = g.float()
            p32 = p.float()
            if not self.adamw:
                g = g + self.weight_decay * p32
            m = self.beta1 * m_s.float() + (1 - self.beta1) * g
            v = self.beta2 * v_s.float() + (1 - self.beta2) * g * g
            new_p = p32 - self.lr * (m / bc1) / (torch.sqrt(v / bc2)
                                                 + self.epsilon)
            if self.adamw and self.weight_decay:
                new_p = new_p - self.lr * self.weight_decay * p32
            p.copy_(new_p)
            m_s.copy_(m)
            v_s.copy_(v)
        state["step"] = step
        return params, state
