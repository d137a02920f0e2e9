"""Where the port's entry points run.

Entry points run on the CUDA card unless the caller asks for the CPU with
``device="cpu"`` (the tests do). Without a card and without an explicit
device they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, or ``RuntimeError`` when there
    is none; anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain torch versions"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
