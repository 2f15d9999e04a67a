"""Block-table attention for the paged KV pool: the dispatcher and the plain
gather path (the port of ``repro.kernels.paged``).

The paged pool stores KV rows in fixed-size blocks shared by every slot:

    k_pool / v_pool : [NB, block_size, KVH, hd]
    pos             : [NB, block_size]   absolute position, -1 unwritten
    block_tables    : [B, max_blocks]    physical block ids, -1 unused

:func:`paged_verify_attn` dispatches by the device of the tensors: a CUDA
tensor goes to the hand-written kernels of ``csrc/paged_verify_attn.cu``,
K3 (ragged) when ``cu_blocks`` is given and K2 (dense) otherwise, which
launch or raise; a CPU tensor goes to :func:`gather_verify_attn`, which
rebuilds each slot's logical ``[MAXB * bs]`` view and runs the plain
verify attention over the copy.  Rows behind a ``-1`` table entry surface
with key position ``-1`` and are never attended, which is what the kernels'
skip of a dead entry computes.  Each path keeps a launch count.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.paged_verify_attn import (paged_verify_attn_cuda,
                                                   ragged_paged_verify_attn_cuda)
from repro_torch.kernels.spec_verify_attn import LaunchCount

PLAIN = LaunchCount()    # calls of the plain gather path


def gather_kv_blocks(k: torch.Tensor, v: torch.Tensor,
                     block_tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot logical KV views ``[B, MAXB * bs, KVH, hd]`` gathered from
    the pool ``[NB, bs, KVH, hd]``.  Rows behind -1 entries hold block 0's
    data; :func:`gather_key_positions` reports them as -1."""
    B, MAXB = block_tables.shape
    bs = k.shape[1]
    safe = block_tables.clamp(min=0).long()
    return (k[safe].reshape(B, MAXB * bs, *k.shape[2:]),
            v[safe].reshape(B, MAXB * bs, *v.shape[2:]))


def gather_key_positions(pos: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Per-slot logical key positions ``[B, MAXB * bs]``; -1 where the table
    has no block (or the pool row is unwritten)."""
    B, MAXB = block_tables.shape
    safe = block_tables.clamp(min=0).long()
    kp = torch.where((block_tables < 0)[:, :, None], -1, pos[safe])
    return kp.reshape(B, MAXB * pos.shape[1])


def gather_scales(scale: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """int8 dequant scales ``[NB, bs, KVH]`` -> per-slot ``[B, MAXB*bs, KVH]``."""
    B, MAXB = block_tables.shape
    safe = block_tables.clamp(min=0).long()
    return scale[safe].reshape(B, MAXB * scale.shape[1], scale.shape[2])


def gather_verify_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_pos: torch.Tensor, pos: torch.Tensor,
                       block_tables: torch.Tensor,
                       window: Optional[int] = None, prefix_len: int = 0,
                       scale: Optional[float] = None,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain paged path: gather each slot's logical view (int8 rows
    dequantized with their scales), then ``ref.gqa_masked_ref``.  A query row
    that sees nothing outputs zeros."""
    kg, vg = gather_kv_blocks(k, v, block_tables)
    kpos = gather_key_positions(pos, block_tables)
    if k_scale is not None:
        kg = _ref.dequant(kg, gather_scales(k_scale, block_tables), q.dtype)
        vg = _ref.dequant(vg, gather_scales(v_scale, block_tables), q.dtype)
    return _ref.gqa_masked_ref(q, kg, vg, q_pos, kpos, window, prefix_len, scale)


def paged_verify_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, pos: torch.Tensor,
                      block_tables: torch.Tensor,
                      window: Optional[int] = None, prefix_len: int = 0,
                      scale: Optional[float] = None,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      cu_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Verify-step attention against the paged pool
    (``repro.kernels.paged.paged_verify_attn``).  q: [B,T,H,hd]; k/v:
    [NB,bs,KVH,hd]; q_pos: [B,T]; pos: [NB,bs]; block_tables: [B,MAXB];
    optional k_scale/v_scale [NB,bs,KVH] for an int8 pool; ``cu_blocks
    [B+1]`` (``tuning.host_cu_blocks`` of the same tables, on the tables'
    device) selects K3 on the card.  Returns [B,T,H,hd]."""
    if q.is_cuda:
        if cu_blocks is not None:
            return ragged_paged_verify_attn_cuda(
                q, k, v, q_pos, pos, block_tables, cu_blocks, window,
                prefix_len, scale, k_scale, v_scale)
        return paged_verify_attn_cuda(q, k, v, q_pos, pos, block_tables, window,
                                      prefix_len, scale, k_scale, v_scale)
    PLAIN.launches += 1
    return gather_verify_attn(q, k, v, q_pos, pos, block_tables, window,
                              prefix_len, scale, k_scale, v_scale)
