"""Plain PyTorch versions of the attention, norm and SSD kernels (copies of
``repro.kernels.ref``, plus the explicit backward of K4, K5 and K6).

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


def dequant(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 K/V codes [..., hd] and their per-(row, kv-head) scales [...] ->
    values in ``dtype``, the product in fp32 (``repro.models.transformer.
    _dequant``): how the plain paths read an int8 cache."""
    return (q.float() * scale.float()[..., None]).to(dtype)


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


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunk (K6): one chunk, and the model's whole chunk loop


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in its own dtype where that is wider (fp64 inputs give
    an fp64 evaluation, the yardstick of the fp32 ones)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def ssd_chunk_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  dt: torch.Tensor, l: torch.Tensor, h0: torch.Tensor):
    """One SSD chunk for a batch of (batch*head) slices, all math in fp32
    (``repro.kernels.ref.ssd_chunk_ref``, batched).  x: [BH, Q, P]; b/c:
    [BH, Q, N]; dt: [BH, Q] (>= 0); l: [BH, Q] log-decay (<= 0); h0: [BH,
    P, N].  With cs = cumsum(l) and M = tril(c b^T * exp(cs_i - cs_j)):
    y = (M * dt_j) x + (c * exp(cs)) h0^T and h_new = exp(cs_Q) h0 +
    (x * dt exp(cs_Q - cs))^T b.  Returns (y [BH, Q, P], h_new [BH, P, N])."""
    x, b, c, dt, l, h0 = (_wide(t) for t in (x, b, c, dt, l, h0))
    Q = x.shape[1]
    cs = torch.cumsum(l, dim=1)                                   # [BH, Q]
    cb = torch.einsum("zin,zjn->zij", c, b)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    dec = torch.where(mask, cs[:, :, None] - cs[:, None, :], 0.0)  # masked before exp
    M = torch.where(mask, cb * torch.exp(dec), 0.0)
    y_in = torch.einsum("zij,zjp->zip", M * dt[:, None, :], x)
    y_h = torch.einsum("zin,zpn->zip", c * torch.exp(cs)[:, :, None], h0)
    w = dt * torch.exp(cs[:, -1:] - cs)                           # [BH, Q]
    contrib = torch.einsum("zjp,zjn->zpn", x * w[:, :, None], b)
    h_new = torch.exp(cs[:, -1])[:, None, None] * h0 + contrib
    return y_in + y_h, h_new


def ssd_chunk_len(T: int, chunk: int) -> int:
    """The chunk length Q of a T-row scan: the largest divisor of T that is
    at most ``chunk`` (``repro.models.mamba2._ssd_chunked``), so that every
    chunk is whole."""
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    return Q


def ssd_chunked_ref(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                    dt: torch.Tensor, A: torch.Tensor, h0: torch.Tensor,
                    chunk: int):
    """The chunked SSD scan of ``repro.models.mamba2.Mamba2LM._ssd_chunked``
    in fp32: xh [B,T,H,P]; B_/C_ [B,T,G,N] (group g serves heads g*H/G ..);
    dt [B,T,H] (>= 0, zero on padding); A [H] (> 0, the decay rate, so the
    log-decay is -dt*A); h0 [B,H,P,N].  Chunks of Q = ``ssd_chunk_len(T,
    chunk)`` rows run in order, each carrying h into the next.  Returns (y
    [B,T,H,P] fp32, h_final [B,H,P,N] fp32; fp64 for fp64 inputs)."""
    Bsz, T, H, Pd = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = ssd_chunk_len(T, chunk)
    rep = H // G
    fold = lambda t: _wide(t).transpose(1, 2).reshape(Bsz * H, T, -1)  # noqa: E731
    x = fold(xh)                                                  # [BH, T, P]
    b = fold(B_.repeat_interleave(rep, dim=2))                    # [BH, T, N]
    c = fold(C_.repeat_interleave(rep, dim=2))
    dtf = _wide(dt).transpose(1, 2).reshape(Bsz * H, T)
    l = -dtf * _wide(A).repeat(Bsz)[:, None]
    h = _wide(h0).reshape(Bsz * H, Pd, N)
    ys = []
    for i in range(0, T, Q):
        y, h = ssd_chunk_ref(x[:, i:i + Q], b[:, i:i + Q], c[:, i:i + Q],
                             dtf[:, i:i + Q], l[:, i:i + Q], h)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(Bsz, H, T, Pd).transpose(1, 2)
    return y, h.reshape(Bsz, H, Pd, N)


def ssd_chunked_bwd_ref(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                        dt: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor],
                        chunk: int, dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None):
    """The gradients of :func:`ssd_chunked_ref` (with h0 None a zero state)
    for an output gradient ``dy`` [B,T,H,P] and ``dh_final`` [B,H,P,N] (None:
    the final state is not used), in fp32, in the order K6's backward takes
    them: each chunk's carried-in state h_in (the forward's carry); dh
    carried from the last chunk to the first (``dh_out`` of chunk k is
    ``dh_in`` of chunk k + 1, ``dh_in = exp(cs_end) dh_out + sum_i exp(cs_i)
    dy_i c_i^T``); then each chunk's gradients.  Per (batch, head) and chunk,
    with cs = cumsum(l), l = -dt * A, L_ij = exp(cs_i - cs_j) for i >= j
    (else 0), S = c b^T, D = dy x^T and e_j = exp(cs_end - cs_j):

      dx_j  = dt_j (sum_i S_ij L_ij dy_i + e_j dh_out b_j)
      db_j  = dt_j (sum_i L_ij D_ij c_i + e_j dh_out^T x_j)
      dc_i  = sum_j L_ij D_ij dt_j b_j + exp(cs_i) h_in^T dy_i
      ddt_j = sum_i S_ij L_ij D_ij + e_j x_j^T dh_out b_j      (direct part)

    The log-decay's gradient dcs_k = c_k . dc_k - dt_k ddt_k (the terms of
    every product that holds cs_i - cs_j, cs_i or cs_end - cs_j), plus, at
    the chunk's last row, E + sum_j W_j with E = exp(cs_end) <dh_out, h_in>
    and W_j = dt_j e_j x_j^T dh_out b_j; dl is its reverse cumsum and ddt_j
    = ddt_j - A dl_j.  dA = -sum dt dl sums that reverse cumsum of row minus
    column sums, which loses digits in fp32 (1e-5 to 1e-4 of its largest
    entry at 256-row chunks, by every fp32 route); it is taken in its direct
    form instead, each decay's derivative in A with cd the running sum of
    dt in the chunk and T_ij = S_ij L_ij D_ij dt_j, U_i = exp(cs_i) c_i^T
    h_in^T dy_i:

      dA = -(sum_{i>=j} T_ij (cd_i - cd_j) + sum_i U_i cd_i
             + sum_j W_j (cd_end - cd_j) + E cd_end)

    db and dc sum over the heads of a group.  fp32, or fp64 for fp64 inputs.
    Returns (dxh, dB, dC in the inputs' dtypes, ddt [B,T,H], dA [H], dh0
    [B,H,P,N] or None when h0 is None)."""
    Bsz, T, H, Pd = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = ssd_chunk_len(T, chunk)
    nc, rep = T // Q, H // G
    fold = lambda t: _wide(t).transpose(1, 2).reshape(Bsz * H, T, -1)  # noqa: E731
    x, g = fold(xh), fold(dy)                                     # [BH, T, P]
    b = fold(B_.repeat_interleave(rep, dim=2))                    # [BH, T, N]
    c = fold(C_.repeat_interleave(rep, dim=2))
    dtf = _wide(dt).transpose(1, 2).reshape(Bsz * H, T)
    Af = _wide(A).repeat(Bsz)
    cs = torch.cumsum((-dtf * Af[:, None]).reshape(-1, nc, Q), dim=2)   # [BH, nc, Q]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    chunk_rows = [slice(k * Q, (k + 1) * Q) for k in range(nc)]

    # 1. the chunks' carried-in states
    h = (torch.zeros((Bsz * H, Pd, N), dtype=x.dtype, device=x.device) if h0 is None
         else _wide(h0).reshape(Bsz * H, Pd, N))
    h_in = []
    for k, r in enumerate(chunk_rows):
        h_in.append(h)
        w = dtf[:, r] * torch.exp(cs[:, k, -1:] - cs[:, k])
        h = torch.exp(cs[:, k, -1])[:, None, None] * h + torch.einsum(
            "zjp,zjn->zpn", x[:, r] * w[:, :, None], b[:, r])

    # 2. dh carried from the last chunk to the first
    dh = (torch.zeros_like(h) if dh_final is None
          else _wide(dh_final).reshape(Bsz * H, Pd, N))
    dh_out = [None] * nc
    for k in reversed(range(nc)):
        r = chunk_rows[k]
        dh_out[k] = dh
        dh = torch.exp(cs[:, k, -1])[:, None, None] * dh + torch.einsum(
            "zip,zin->zpn", g[:, r] * torch.exp(cs[:, k])[:, :, None], c[:, r])
    dh0 = None if h0 is None else dh.reshape(Bsz, H, Pd, N)

    # 3. each chunk's gradients
    dx, db, dc, ddt = (torch.empty_like(t) for t in (x, b, c, dtf))
    dA = torch.zeros_like(Af)
    for k, r in enumerate(chunk_rows):
        csk, dtk = cs[:, k], dtf[:, r]
        cd = torch.cumsum(dtk, 1)                                 # running sum of dt
        e = torch.exp(csk[:, -1:] - csk)                          # [BH, Q]
        L = torch.where(mask, torch.exp(torch.where(mask, csk[:, :, None] - csk[:, None, :],
                                                    0.0)), 0.0)
        S = torch.einsum("zin,zjn->zij", c[:, r], b[:, r])
        D = torch.einsum("zip,zjp->zij", g[:, r], x[:, r])
        SL, LD = S * L, L * D
        xdh = torch.einsum("zjp,zpn->zjn", x[:, r], dh_out[k])    # x_j^T dh_out, [BH, Q, N]
        bdh = torch.einsum("zjn,zpn->zjp", b[:, r], dh_out[k])    # dh_out b_j, [BH, Q, P]
        dx[:, r] = dtk[:, :, None] * (torch.einsum("zij,zip->zjp", SL, g[:, r])
                                      + e[:, :, None] * bdh)
        db[:, r] = dtk[:, :, None] * (torch.einsum("zij,zin->zjn", LD, c[:, r])
                                      + e[:, :, None] * xdh)
        dc_h = torch.exp(csk)[:, :, None] * torch.einsum("zip,zpn->zin", g[:, r], h_in[k])
        dc[:, r] = torch.einsum("zij,zjn->zin", LD * dtk[:, None, :], b[:, r]) + dc_h
        d_state = e * (xdh * b[:, r]).sum(-1)                     # e_j x_j^T dh_out b_j
        ddt_dir = (SL * D).sum(1) + d_state
        W = dtk * d_state
        E = torch.exp(csk[:, -1]) * (dh_out[k] * h_in[k]).sum((1, 2))
        dcs = (c[:, r] * dc[:, r]).sum(-1) - dtk * ddt_dir
        dcs[:, -1] += E + W.sum(1)
        dl = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), 1), (1,))
        ddt[:, r] = ddt_dir - Af[:, None] * dl
        Tm = SL * D * dtk[:, None, :]
        dA -= ((Tm * (cd[:, :, None] - cd[:, None, :])).sum((1, 2))
               + ((c[:, r] * dc_h).sum(-1) * cd).sum(1)
               + (W * (cd[:, -1:] - cd)).sum(1) + E * cd[:, -1])

    unfold = lambda t: t.reshape(Bsz, H, T, -1).transpose(1, 2)  # noqa: E731
    group = lambda t: unfold(t).reshape(Bsz, T, G, rep, -1).sum(3)  # noqa: E731
    return (unfold(dx).to(xh.dtype), group(db).to(B_.dtype), group(dc).to(C_.dtype),
            ddt.reshape(Bsz, H, T).transpose(1, 2).contiguous(), dA.reshape(Bsz, H).sum(0),
            dh0)
