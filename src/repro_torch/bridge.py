"""Carry parameters and caches between the JAX package and the port.

Both packages use the same nested keys and the same stacked ``[n_layers,
...]`` layer layout, so a conversion is a tree map; the optimizer state
crosses the same way (``adamw_state_to_torch``).  The JAX side hands its
trees over as nested numpy arrays (``jax.tree.map(np.asarray, tree)``); this
module never imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.training.optimizer import AdamWState


def to_torch(tree: Any, device: torch.device | str = "cuda",
             dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``
    (the card unless the caller names the CPU).  ``dtype`` casts
    floating-point leaves only; integer leaves (positions) keep theirs."""
    return _to_torch(tree, resolve_device(device), dtype)


def _to_torch(tree: Any, device: torch.device, dtype: Optional[torch.dtype]) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> the same dict of numpy arrays (float32 for
    floating-point leaves)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def adamw_state_to_torch(step: Any, m: Any, v: Any,
                         device: torch.device | str = "cuda"):
    """The JAX ``AdamWState`` handed over as numpy (the step scalar and the
    m and v trees) -> the port's ``AdamWState`` on ``device``: an int32 0-d
    step and fp32 moments, so one optimizer step can be compared across the
    packages."""
    device = resolve_device(device)
    return AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                        device=device),
                      m=_to_torch(m, device, torch.float32),
                      v=_to_torch(v, device, torch.float32))
