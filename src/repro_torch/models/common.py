"""Shared model layers (copies of ``repro.models.common``): the seeded
parameter init, norms, RoPE, position masks and embeddings.  The JAX
module's ``flash_attention_tri`` and ``flash_attention_train`` have one
counterpart, ``kernels.ops.flash_attn``.

Parameters are nested dicts of tensors with the JAX package's keys; layer
parameters are stacked along a leading ``n_layers`` axis.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | ones
    scale: Optional[float] = None     # stddev for "normal" (default 1/sqrt(fan_in))
    stacked: bool = False             # leading n_layers dim added implicitly

    def full_shape(self, n_layers: int) -> Tuple[int, ...]:
        return (n_layers, *self.shape) if self.stacked else self.shape


def _iter_defs(defs: Dict, prefix=()):
    for k, v in defs.items():
        if isinstance(v, ParamDef):
            yield (*prefix, k), v
        else:
            yield from _iter_defs(v, (*prefix, k))


def init_params(defs: Dict, generator: torch.Generator, n_layers: int,
                dtype: torch.dtype, device: torch.device | str) -> Dict:
    """Seeded init with the JAX package's distributions (normal x
    1/sqrt(fan_in) unless the def gives a scale; ones for norms).  The
    numbers differ from JAX's.  Draws in float32 one layer at a time, on the
    generator's device, then casts, so the float32 copy of a stacked weight
    never exists in full.  The generator must live on ``device``."""
    out: Dict = {}
    for path, d in _iter_defs(defs):
        shape = d.full_shape(n_layers)
        if d.init == "ones":
            arr = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
            scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
            arr = torch.empty(shape, dtype=dtype, device=device)
            for part in (arr if d.stacked else [arr]):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       dtype=torch.float32, device=device) * scale)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 reduction; the normalized row is cast to x's dtype before the
    multiply by gamma, as the JAX package does.  Runs ``kernels.ops.rmsnorm``:
    the kernel K5 on the card (forward and backward), its plain version on
    the CPU."""
    return ops.rmsnorm(x, gamma, eps)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the split-half RoPE angles, fp32, shaped [..., T, 1,
    head_dim/2] for positions [..., T].  One table serves every layer."""
    ang = positions[..., None].float() * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Split-half RoPE computed in fp32.  x: [..., T, n_heads, head_dim];
    positions: broadcastable to [..., T]; ``table`` is
    ``rope_table(positions, head_dim, theta)`` when the caller has it."""
    cos, sin = table if table is not None else rope_table(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def position_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
                  prefix_len: int = 0) -> torch.Tensor:
    """q_pos: [..., Tq]; k_pos: [..., Tk] absolute positions (-1 = unwritten).
    Returns bool [..., Tq, Tk]."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = (k >= 0) & (k <= q)
    if window is not None:
        ok &= k > q - window
    if prefix_len:
        ok |= (k >= 0) & (k < prefix_len)
    return ok


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """fp32 logits with padded vocab ids set to -1e30."""
    logits = (x @ table.T).float()
    if true_vocab < table.shape[0]:
        logits[..., true_vocab:] = -1e30
    return logits
