"""Runtime configuration (counterpart of flexflow_tpu/config.py).

Carries the fields the serving and training slices read: batch size,
epochs, seed and the rematerialization mode, and the new `device`. Every
entry point runs on the card ("cuda") unless the caller asks for "cpu",
and a CUDA request on a machine without a card raises instead of
drifting to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

REMAT_MODES = ("none", "attention")


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    epochs: int = 1
    seed: int = 42
    # "cuda" (the default), "cuda:N", or "cpu" — never chosen implicitly
    device: str = "cuda"
    # rematerialization in training: "attention" recomputes each
    # attention lowering in backward (torch.utils.checkpoint) instead of
    # saving its intermediates; "none" saves everything. The reference's
    # "hidden" mode (MLP hidden activations) is not ported yet.
    remat: str = "attention"

    def __post_init__(self):
        if self.remat == "hidden":
            raise NotImplementedError(
                'remat="hidden" is not ported yet (ROADMAP.md, queue 1 '
                'item 3); use "attention" or "none"')
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{self.remat!r}")

    def torch_device(self) -> torch.device:
        return resolve_device(self.device)


def resolve_device(device) -> torch.device:
    """The torch.device for `device`, refusing a CUDA device when no card
    is visible (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
