"""The port's device rule: entry points run on the card unless the caller
names the CPU, and never move to the CPU on their own."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA when no card is
    visible, so a caller who wants the plain versions on the CPU must say
    ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device
