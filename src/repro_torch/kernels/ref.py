"""Plain PyTorch versions of the attention kernels (copies of
``repro.kernels.ref``).

They define each kernel's numerical contract: the CPU tests hold them
against the JAX oracles, and ``chip_smoke.py`` holds the CUDA kernel against
them on the card.  A key row is attendable iff ``0 <= k_pos <= q_pos`` and
``k_pos > q_pos - window``, or ``0 <= k_pos < prefix_len``; softmax is in
fp32 and a fully masked query row outputs zeros.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _visible(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
             prefix_len: int) -> torch.Tensor:
    """q_pos [..., Tq], k_pos [..., Tk] -> bool [..., Tq, Tk]."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    ok = (kp >= 0) & (kp <= qp)
    if window is not None:
        ok &= kp > qp - window
    if prefix_len:
        ok |= (kp >= 0) & (kp < prefix_len)
    return ok


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: Optional[int] = None, prefix_len: int = 0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Masked attention, one kv-head group.  q: [B, Tq, hd]; k/v: [B, Tk, hd];
    q_pos: [B, Tq]; k_pos: [B, Tk] (-1 = unwritten row)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqh,bkh->bqk", q, k).float() * scale
    ok = _visible(q_pos, k_pos, window, prefix_len)
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(ok.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bqk,bkh->bqh", p.to(v.dtype), v)


def spec_verify_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: Optional[int] = None, prefix_len: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Verify-step attention: the same contract as :func:`flash_attn_ref`."""
    return flash_attn_ref(q, k, v, q_pos, k_pos, window, prefix_len, scale)


def gqa_masked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: Optional[int] = None, prefix_len: int = 0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention in the unfolded layout: q [B,T,H,hd]; k/v [B,L,KVH,hd];
    q_pos [B,T]; k_pos [B,L].  Returns [B,T,H,vd]."""
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, T, KVH, G, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k).float() * scale
    okb = _visible(q_pos, k_pos, window, prefix_len)[:, None, None]  # [B,1,1,T,L]
    s = torch.where(okb, s, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(okb.any(-1, keepdim=True), p, 0.0)
    out = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype), v)
    return out.reshape(B, T, H, v.shape[-1])
