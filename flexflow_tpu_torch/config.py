"""Runtime configuration (counterpart of flexflow_tpu/config.py).

Carries the fields the serving slice reads: batch size and seed, and the
new `device`. Every entry point runs on the card ("cuda") unless the
caller asks for "cpu", and a CUDA request on a machine without a card
raises instead of drifting to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    seed: int = 42
    # "cuda" (the default), "cuda:N", or "cpu" — never chosen implicitly
    device: str = "cuda"

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
