"""Checkpointing: flat-key npz of a parameter / optimizer tree, in the JAX
package's format (``repro.training.checkpoint``), so a checkpoint written
by either package loads into the other.

Arrays are stored under their '/'-joined tree paths (``params/...``,
``opt/m/...``, ``opt/v/...``), the optimizer step as ``opt/step`` and the
caller's step as ``meta/step``; the write goes to a temporary file that is
then renamed over the target.  Restore maps into a template tree, whose
dtypes, shapes and device are authoritative.

numpy has no bfloat16.  The port writes a bfloat16 leaf widened to float32
(exact), which both packages restore into a bfloat16 template.  The JAX
package writes bfloat16 as 2-byte records (numpy reads them back as void
``V2``); the port reads those as the raw bfloat16 bits.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState

Params = Any


def _flatten(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        t = tree.detach().cpu()
        out[prefix[:-1]] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def save(path: str, params: Params, opt_state: Optional[AdamWState] = None,
         step: Optional[int] = None) -> None:
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        flat.update({f"opt/m/{k}": v for k, v in _flatten(opt_state.m).items()})
        flat.update({f"opt/v/{k}": v for k, v in _flatten(opt_state.v).items()})
        flat["opt/step"] = opt_state.step.cpu().numpy()
    if step is not None:
        flat["meta/step"] = np.asarray(step)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".", suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _to_tensor(arr: np.ndarray, template: torch.Tensor) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:    # JAX's bfloat16 records
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=template.device, dtype=template.dtype)


def _unflatten_into(template: Params, flat: Dict[str, np.ndarray],
                    prefix: str = "") -> Params:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    key = prefix[:-1]
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{key}: {arr.shape} != {tuple(template.shape)}")
    return _to_tensor(arr, template)


def _sub(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def restore(path: str, params_template: Params,
            opt_template: Optional[AdamWState] = None,
            ) -> Tuple[Params, Optional[AdamWState], int]:
    """Returns (params, opt_state | None, step), on the templates' devices."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten_into(params_template, _sub(flat, "params/"))
    opt_state = None
    if opt_template is not None and any(k.startswith("opt/") for k in flat):
        opt_state = AdamWState(
            step=_to_tensor(flat["opt/step"], opt_template.step),
            m=_unflatten_into(opt_template.m, _sub(flat, "opt/m/")),
            v=_unflatten_into(opt_template.v, _sub(flat, "opt/v/")))
    step = int(flat.get("meta/step", flat.get("opt/step", np.asarray(0))))
    return params, opt_state, step
