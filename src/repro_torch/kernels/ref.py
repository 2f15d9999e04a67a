"""Plain PyTorch versions of the attention and norm kernels (copies of
``repro.kernels.ref``, plus the explicit backward of K4 and K5).

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


# ---------------------------------------------------------------------------
# RMSNorm (K5) and training flash attention (K4): forward and explicit backward


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Row RMS norm in fp32 with output in x's dtype; the normalized row is
    cast to x's dtype *before* the multiply by gamma (``repro.kernels.ref``)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rmsnorm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradients K5's backward computes, as JAX's autodiff of
    :func:`rmsnorm_ref` takes them: ``g = dy * gamma`` in x's dtype (the
    product's gradient), widened to fp32 (the cast's), then
    ``dx = rstd * (g - xh * mean(g * xh))`` with ``xh = x * rstd`` in fp32,
    cast to x's dtype; ``dgamma`` sums ``dy * xh.to(x.dtype)`` over the rows
    in fp32 and casts to gamma's dtype.  Returns ``(dx, dgamma)``."""
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xh = x32 * rstd
    g = (dy * gamma).float()
    dx = rstd * (g - xh * (g * xh).mean(dim=-1, keepdim=True))
    rows = dy.reshape(-1, dy.shape[-1]).float() * xh.to(x.dtype).reshape(-1, x.shape[-1]).float()
    return dx.to(x.dtype), rows.sum(0).to(gamma.dtype)


def _scores(q, k, q_pos, k_pos, window, prefix_len, scale):
    """Masked fp32 scores [B, KVH, G, T, L] of the unfolded GQA layout and
    the visibility mask [B, 1, 1, T, L]."""
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    qg = q.reshape(B, T, KVH, H // KVH, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k).float() * scale
    ok = _visible(q_pos, k_pos, window, prefix_len)[:, None, None]
    return s, ok


def flash_attn_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, k_pos: torch.Tensor,
                           window: Optional[int] = None, prefix_len: int = 0,
                           scale: Optional[float] = None):
    """:func:`gqa_masked_ref` plus the fp32 per-row logsumexp of the scaled
    scores, ``lse [B, H, T]`` (``-inf`` for a fully masked row, whose output
    is zeros).  The backward recomputes the probabilities from it."""
    B, T, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s, ok = _scores(q, k, q_pos, k_pos, window, prefix_len, scale)
    s = torch.where(ok, s, -torch.inf)
    lse = torch.logsumexp(s, dim=-1)                             # [B,KVH,G,T]
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    out = torch.einsum("bkgts,bskh->btkgh", p.to(v.dtype), v)
    return out.reshape(B, T, H, v.shape[-1]), lse.reshape(B, H, T)


def flash_attn_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                       q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: Optional[int] = None, prefix_len: int = 0,
                       scale: Optional[float] = None):
    """The explicit gradients K4's backward computes, in fp32, from the
    saved logsumexp: ``P = exp(S - lse)`` (0 where masked), ``D =
    rowsum(dO * O)``, ``dV = P^T dO``, ``dS = P * (dO V^T - D)``, ``dQ =
    dS K * scale``, ``dK = dS^T Q * scale``; dK and dV of a kv-head sum over
    its G query heads.  A masked or fully masked row contributes zeros.
    Returns ``(dq, dk, dv)`` in the dtypes of q, k, v."""
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s, ok = _scores(q.float(), k.float(), q_pos, k_pos, window, prefix_len, scale)
    lse = lse.reshape(B, KVH, G, T)
    p = torch.where(ok, torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None]), 0.0)
    do5 = do.float().reshape(B, T, KVH, G, -1)
    dd = (do5 * o.float().reshape(B, T, KVH, G, -1)).sum(-1).permute(0, 2, 3, 1)  # [B,KVH,G,T]
    dv = torch.einsum("bkgts,btkgh->bskh", p, do5)
    dp = torch.einsum("btkgh,bskh->bkgts", do5, v.float())
    ds = p * (dp - dd[..., None])
    dq = torch.einsum("bkgts,bskh->btkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgts,btkgh->bskh", ds, q.float().reshape(B, T, KVH, G, hd)) * scale
    return (dq.reshape(B, T, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
