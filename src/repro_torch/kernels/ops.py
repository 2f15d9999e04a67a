"""Public kernel wrappers: dispatch by the device of the tensors.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version in ``ref.py``.  There is no
fallback between the two and no switch to force either.  Each path keeps a
launch count, so a run can show which one carried it.

``spec_verify_attn`` is K1; ``rmsnorm`` (K5), ``flash_attn`` (K4) and
``ssd_chunked`` (K6, the Mamba-2 SSD scan) are ``torch.autograd.Function``s
whose backward dispatches the same way; ``ssd_chunk`` (K6's one-chunk
contract) is forward only: no model path differentiates it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attn as K4
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as K5
from repro_torch.kernels import ssd_chunk as K6
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
        k, v = _ref.dequant(k, k_scale, q.dtype), _ref.dequant(v, v_scale, q.dtype)
    PLAIN.launches += 1
    return _ref.gqa_masked_ref(q, k, v, q_pos, k_pos, window, prefix_len, scale)


# ---------------------------------------------------------------------------
# RMSNorm (K5) and position-masked flash attention (K4), with gradients

PLAIN_RMSNORM = LaunchCount()   # calls of rmsnorm's plain forward or backward
PLAIN_FLASH = LaunchCount()     # calls of flash_attn's plain forward or backward


class _RMSNorm(torch.autograd.Function):
    """x [n, d], gamma [d]: the kernel K5 on the card, the plain version on
    the CPU, forward and backward."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        if x.is_cuda:
            y, rstd = K5.rmsnorm_fwd_cuda(x, gamma, eps, save_rstd=True)
        else:
            PLAIN_RMSNORM.launches += 1
            y, rstd = _ref.rmsnorm_ref(x, gamma, eps), None
        ctx.save_for_backward(x, gamma, rstd)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rstd = ctx.saved_tensors
        if x.is_cuda:
            dx, dgamma = K5.rmsnorm_bwd_cuda(x, gamma, dy.contiguous(), rstd)
        else:
            PLAIN_RMSNORM.launches += 1
            dx, dgamma = _ref.rmsnorm_bwd_ref(x, gamma, dy, ctx.eps)
        return dx, dgamma, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm (``repro.kernels.ops.rmsnorm``): x [..., d], gamma [d];
    fp32 reduction, the normalized row cast to x's dtype before the multiply
    by gamma.  Differentiable in x and gamma; the forward keeps the fp32
    ``rstd`` for the backward only when a gradient is wanted."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        return _RMSNorm.apply(x2, gamma, eps).reshape(shape)
    if x.is_cuda:
        y, _ = K5.rmsnorm_fwd_cuda(x2, gamma, eps)
    else:
        PLAIN_RMSNORM.launches += 1
        y = _ref.rmsnorm_ref(x2, gamma, eps)
    return y.reshape(shape)


class _FlashAttn(torch.autograd.Function):
    """GQA position-masked attention: the kernel K4 on the card, the plain
    versions on the CPU, forward (with the logsumexp) and backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, prefix_len, scale):
        if q.is_cuda:
            out, lse = K4.flash_attn_fwd_cuda(q, k, v, q_pos, k_pos, window, prefix_len,
                                              scale, save_lse=True)
        else:
            PLAIN_FLASH.launches += 1
            out, lse = _ref.flash_attn_fwd_lse_ref(q, k, v, q_pos, k_pos, window,
                                                   prefix_len, scale)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.args = (window, prefix_len, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = K4.flash_attn_bwd_cuda(q, k, v, out, do, lse, q_pos, k_pos,
                                                *ctx.args)
        else:
            PLAIN_FLASH.launches += 1
            dq, dk, dv = _ref.flash_attn_bwd_ref(q, k, v, out, do, lse, q_pos, k_pos,
                                                 *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int] = None, prefix_len: int = 0,
               scale: Optional[float] = None) -> torch.Tensor:
    """GQA flash attention (``repro.kernels.ops.flash_attn``, and the
    model's ``flash_attention_train`` / ``flash_attention_tri``).  q
    [B,T,H,dk]; k [B,L,KVH,dk]; v [B,L,KVH,dv] (dv = dk, or MLA's dk 192
    with dv 128); q_pos/k_pos [B,T]/[B,L] int32 (-1 = never attended).
    Returns [B,T,H,dv]; ``scale`` defaults to ``1/sqrt(dk)``.
    Differentiable in q, k and v; the logsumexp the backward needs is kept
    only when a gradient is wanted."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttn.apply(q, k, v, q_pos, k_pos, window, prefix_len, scale)
    if q.is_cuda:
        out, _ = K4.flash_attn_fwd_cuda(q, k, v, q_pos, k_pos, window, prefix_len, scale)
        return out
    PLAIN_FLASH.launches += 1
    return _ref.gqa_masked_ref(q, k, v, q_pos, k_pos, window, prefix_len, scale)


# ---------------------------------------------------------------------------
# the Mamba-2 SSD scan (K6): one chunk (forward only), and the chunked scan
# with its gradients

PLAIN_SSD = LaunchCount()       # calls of ssd_chunk's or ssd_chunked's plain forward or backward


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
              l: torch.Tensor, h0: torch.Tensor):
    """One SSD chunk for a batch of (batch*head) slices
    (``repro.kernels.ops.ssd_chunk``): x [BH,Q,P]; b/c [BH,Q,N]; dt/l [BH,Q];
    h0 [BH,P,N] -> (y [BH,Q,P], h_new [BH,P,N]) in fp32."""
    if x.is_cuda:
        return K6.ssd_chunk_cuda(x, b, c, dt.float().contiguous(), l.float().contiguous(),
                                 h0.float().contiguous())
    PLAIN_SSD.launches += 1
    return _ref.ssd_chunk_ref(x, b, c, dt, l, h0)


class _SSDChunked(torch.autograd.Function):
    """The chunked scan: the kernel K6 on the card (its forward keeps each
    chunk's carried-in state for the backward), the plain versions on the
    CPU, forward and backward.  The final state's gradient is None when the
    caller drops h_final; the backward reads it as zero."""

    @staticmethod
    def forward(ctx, xh, B_, C_, dt, A, h0, chunk):
        ctx.set_materialize_grads(False)
        if xh.is_cuda:
            y, h, states = K6.ssd_chunked_cuda(xh, B_, C_, dt, A, h0, chunk)
        else:
            (y, h), states = _plain_ssd_chunked(xh, B_, C_, dt, A, h0, chunk), None
        ctx.save_for_backward(xh, B_, C_, dt, A, h0, states)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        xh, B_, C_, dt, A, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xh.shape, dtype=torch.float32, device=xh.device)
        if xh.is_cuda:
            grads = K6.ssd_chunked_bwd_cuda(xh, B_, C_, dt, A, h0, ctx.chunk, dy.contiguous(),
                                            None if dh is None else dh.contiguous(), states)
        else:
            PLAIN_SSD.launches += 1
            grads = _ref.ssd_chunked_bwd_ref(xh, B_, C_, dt, A, h0, ctx.chunk, dy, dh)
        return (*grads, None)


def _plain_ssd_chunked(xh, B_, C_, dt, A, h0, chunk):
    """The plain chunked scan, counted; h0 None is a zero state."""
    PLAIN_SSD.launches += 1
    if h0 is None:
        Bsz, _, H, P = xh.shape
        h0 = torch.zeros((Bsz, H, P, B_.shape[3]), dtype=torch.float32, device=xh.device)
    return _ref.ssd_chunked_ref(xh, B_, C_, dt, A, h0, chunk)


def ssd_chunked(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor, dt: torch.Tensor,
                A: torch.Tensor, h0: Optional[torch.Tensor], chunk: int):
    """The whole chunked scan of a Mamba-2 layer (the model's
    ``_ssd_chunked``): xh [B,T,H,P]; B_/C_ [B,T,G,N]; dt [B,T,H] fp32; A [H]
    fp32 (log-decay -dt*A); h0 [B,H,P,N] fp32, or None for a zero state;
    chunks of the largest divisor of T at most ``chunk``.  Returns (y
    [B,T,H,P], h_final [B,H,P,N]) in fp32.  One call of K6 on the card,
    however many chunks.  Differentiable in every tensor input; the chunk
    states the backward reads are kept only when a gradient is wanted."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (xh, B_, C_, dt, A, h0)):
        return _SSDChunked.apply(xh, B_, C_, dt, A, h0, chunk)
    if xh.is_cuda:
        return K6.ssd_chunked_cuda(xh, B_, C_, dt, A, h0, chunk)[:2]
    return _plain_ssd_chunked(xh, B_, C_, dt, A, h0, chunk)
