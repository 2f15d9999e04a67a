"""Public kernel wrappers: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version in ``ref.py``.  There is no
fallback between the two and no switch to force either.  Each path keeps a
launch count, so a run can show which one carried it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.spec_verify_attn import LaunchCount, spec_verify_attn_cuda

PLAIN = LaunchCount()    # calls of the plain version of spec_verify_attn


def spec_verify_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: Optional[int] = None, prefix_len: int = 0,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Verify-step attention (``repro.kernels.ops.spec_verify_attn``).
    q: [B,T,H,hd]; k/v: [B,L,KVH,hd]; q_pos/k_pos: [B,T]/[B,L] int32.
    Returns [B,T,H,hd].

    int8 caches: pass the int8 k/v plus per-(row, kv-head) ``k_scale`` /
    ``v_scale`` [B,L,KVH].  The kernel dequantizes tile by tile; the plain
    version dequantizes up front."""
    if q.is_cuda:
        return spec_verify_attn_cuda(q, k, v, q_pos, k_pos, window, prefix_len,
                                     scale, k_scale, v_scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if k_scale is not None:
        k = (k.float() * k_scale.float()[..., None]).to(q.dtype)
        v = (v.float() * v_scale.float()[..., None]).to(q.dtype)
    PLAIN.launches += 1
    return _ref.gqa_masked_ref(q, k, v, q_pos, k_pos, window, prefix_len, scale)
