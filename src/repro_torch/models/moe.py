"""Mixture-of-Experts layer (the port of ``repro.models.moe``): top-k
routing with GShard-style capacity-bounded dispatch, plus DeepSeek-style
always-on shared experts.

Used by qwen3-moe-30b-a3b (128 experts, top-8).  The router, the dispatch
and the expert products are plain tensor work here, as in the JAX module
(no Pallas kernel computes them there).

Routing and drops are the JAX module's, token for token: the router
product in x's dtype, then fp32; softmax; the top k in descending order,
renormalised by ``max(sum, 1e-9)``; tokens split into groups of
``group_size(B*T)``; within a group each (token, k) assignment takes the
next slot of its expert in (t, k)-major order, and an assignment past the
expert's ``capacity`` is dropped (it adds nothing to the token's output).
So a token's output depends on the tokens dispatched with it: only a
call with the same rows in gives the same rows out.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, swiglu


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The layer's parameters under the JAX module's keys (nested under
    ``layers["moe"]`` by the decoder)."""
    m, d = cfg.moe, cfg.d_model
    defs = {
        "router": ParamDef((d, m.n_experts), scale=0.02, stacked=True),
        "w_gate": ParamDef((m.n_experts, d, m.d_ff_expert), stacked=True),
        "w_up": ParamDef((m.n_experts, d, m.d_ff_expert), stacked=True),
        "w_down": ParamDef((m.n_experts, m.d_ff_expert, d), stacked=True),
    }
    if m.n_shared:
        ff_sh = m.n_shared * (m.d_ff_shared or m.d_ff_expert)
        defs["sh_gate"] = ParamDef((d, ff_sh), stacked=True)
        defs["sh_up"] = ParamDef((d, ff_sh), stacked=True)
        defs["sh_down"] = ParamDef((ff_sh, d), stacked=True)
    return defs


def group_size(n_tokens: int, target: int = 1024) -> int:
    """Largest divisor of n_tokens that is <= target (dispatch group length)."""
    g = min(n_tokens, target)
    while n_tokens % g:
        g -= 1
    return g


def capacity(tg: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(tg * top_k * factor / n_experts))
    return max(4, -(-c // 4) * 4)  # >=4, rounded up to a multiple of 4


def route(m, router: torch.Tensor, xg: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xg [G, tg, d] -> (probs [G, tg, E] fp32, top_p [G, tg, k] fp32
    renormalised, top_i [G, tg, k] in descending order of probability)."""
    probs = torch.softmax((xg @ router).float(), dim=-1)
    top_p, top_i = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_i


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot of ``idx`` over ``n`` classes (an index outside them
    gives a zero row); unlike ``F.one_hot`` it never reads the device from
    the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.int32)


def slot_ranks(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, k) assignment's rank among its expert's assignments in
    (t, k)-major order, [G, tg, k]: the cumulative sum of the one-hot
    assignments, read at the chosen expert.  Ranks at or past the capacity
    are the dropped assignments."""
    G, tg, k = top_i.shape
    flat = top_i.reshape(G, tg * k, 1)
    counts = _one_hot(flat[..., 0], n_experts).cumsum(1, dtype=torch.int32)  # [G, tg*k, E]
    return (counts.gather(2, flat)[..., 0] - 1).reshape(G, tg, k)


def moe_forward(cfg: ModelConfig, params: Dict[str, torch.Tensor], x: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (out [B, T, d], load-balance aux loss, fp32 scalar).

    The two dispatches keep and drop the same assignments and differ only
    in how tokens reach their expert slot: ``einsum``, GShard's one-hot
    dispatch and combine matrices ``[G, tg, E, C]`` (built by a scatter of
    each assignment, so the ``[G, tg, k, E, C]`` one-hot of the JAX
    module never exists; the same values) through matrix products;
    ``gather``, a stable-sort ragged dispatch (data movement)."""
    m = cfg.moe
    B, T, d = x.shape
    N = B * T
    tg = group_size(N)
    G = N // tg
    xg = x.reshape(G, tg, d)
    probs, top_p, top_i = route(m, params["router"], xg)
    C = capacity(tg, m.top_k, m.n_experts, m.capacity_factor)
    dt = x.dtype

    if m.dispatch == "gather":
        xe, combine_idx, combine_w, f_e = _dispatch_gather(m, xg, top_i, top_p, C)
        ye = _experts(params, xe)
        yf = ye.reshape(G, m.n_experts * C, d)
        # combine: per (token, k) gather its slot's output and weight it
        gath = torch.gather(yf, 1, combine_idx.reshape(G, tg * m.top_k, 1).expand(-1, -1, d))
        y = (gath.reshape(G, tg, m.top_k, d) * combine_w[..., None].to(dt)).sum(dim=2)
    else:
        rank = slot_ranks(top_i, m.n_experts)
        # each kept assignment's flat slot e * (C + 1) + rank; a dropped one
        # lands in its expert's column C, cut off below
        col = top_i * (C + 1) + torch.where(rank < C, rank, C)
        shape = (G, tg, m.n_experts * (C + 1))
        ones = torch.ones_like(top_p)
        dispatch = probs.new_zeros(shape).scatter(2, col, ones)
        combine = probs.new_zeros(shape).scatter(2, col, top_p)
        dispatch = dispatch.view(G, tg, m.n_experts, C + 1)[..., :C]  # [G, tg, E, C]
        combine = combine.view(G, tg, m.n_experts, C + 1)[..., :C]
        xe = torch.einsum("gtec,gtd->gecd", dispatch.to(dt), xg)       # [G, E, C, d]
        ye = _experts(params, xe)
        y = torch.einsum("gtec,gecd->gtd", combine.to(dt), ye)
        f_e = dispatch.sum(dim=(1, 3)) / tg                            # [G, E]

    y = y.reshape(B, T, d)
    # switch-transformer load-balance loss
    p_e = probs.mean(dim=1)                                            # [G, E]
    aux = m.n_experts * (f_e * p_e).sum(-1).mean() * m.router_aux_weight

    if m.n_shared:
        y = y + swiglu(x, params["sh_gate"], params["sh_up"], params["sh_down"])
    return y, aux


def _experts(params: Dict[str, torch.Tensor], xe: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its slots: xe [G, E, C, d] -> [G, E, C, d]."""
    g = torch.einsum("gecd,edf->gecf", xe, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, params["w_up"])
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, params["w_down"])


def _dispatch_gather(m, xg: torch.Tensor, top_i: torch.Tensor, top_p: torch.Tensor,
                     C: int):
    """Stable-sort ragged dispatch with GShard-identical drop semantics.

    Returns (xe [G,E,C,d], combine_idx [G,tg,k] flat slot ids (E*C = dropped
    sentinel row), combine_w [G,tg,k] fp32, f_e [G,E] routed fraction)."""
    G, tg, d = xg.shape
    k, E = m.top_k, m.n_experts
    dev = xg.device
    e_flat = top_i.reshape(G, tg * k)                         # (t, k)-major
    e_sorted, order = torch.sort(e_flat, dim=1, stable=True)  # [G, tg*k]
    # rank of each sorted element within its expert segment
    idx = torch.arange(tg * k, device=dev)[None]
    is_start = torch.cat([torch.ones((G, 1), dtype=torch.bool, device=dev),
                          e_sorted[:, 1:] != e_sorted[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    rank_sorted = idx - seg_start                             # [G, tg*k]
    # scatter ranks back to (t, k) order
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < C
    slot = torch.where(keep, e_flat * C + rank, E * C)        # flat slot id
    # scatter tokens into the padded slot buffer (one sentinel drop row)
    tok = torch.arange(tg, device=dev).repeat_interleave(k).expand(G, -1)
    gidx = torch.arange(G, device=dev)[:, None]
    buf = xg.new_zeros((G, E * C + 1, d)).index_put((gidx, slot), xg[gidx, tok])
    xe = buf[:, :-1].reshape(G, E, C, d)
    combine_idx = torch.where(keep, slot, E * C - 1)          # safe gather id
    combine_w = torch.where(keep, top_p.reshape(G, tg * k), 0.0)
    # routed fraction per expert (kept assignments only), for the aux loss
    f_e = _one_hot(torch.where(keep, e_flat, E), E).sum(1).float() / tg
    return (xe, combine_idx.reshape(G, tg, k),
            combine_w.reshape(G, tg, k).float(), f_e)
