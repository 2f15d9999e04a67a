"""Paged speculative-verify attention on Hopper: the wrappers of the
hand-written CUDA kernels K2 and K3 in ``csrc/paged_verify_attn.cu``.

They replace the TPU kernels ``paged_verify_attn_pallas`` (K2, the dense
``(B, MAXB)`` walk of the block table) and ``ragged_paged_verify_attn_pallas``
(K3, the walk of each slot's live blocks only) of
``src/repro/kernels/paged_verify_attn.py``.  Both read the shared pool in
place through each slot's block-table row; K3 reads ``cu_blocks`` on the
device, so its launch is sized from ``B``, ``KVH`` and ``T`` alone and the
host never reads a device value.  K3 is bit-identical to K2 on every pattern
of raggedness (same blocks, same order, same tile grouping).  On the card
both are bound by bytes: at the verify shapes each K/V byte feeds a handful
of dot products; see the source for the design.

The key range of a slot is split across blocks (split-KV) when the
``(slot, kv-head, row tile)`` blocks alone would not fill the card:
:func:`n_splits` picks the count from the shapes and the SM count only, the
same for K2 and K3, so the launch never depends on the data (and can be
captured in a CUDA graph).  With more than one split a call issues two
device kernels, the splits' partial results going through an fp32
workspace that the wrapper allocates; a launch count still counts calls.

Operands: q ``[B,T,H,hd]`` (float32 or bfloat16); the pool k/v
``[NB,bs,KVH,hd]`` of q's dtype, or int8 with ``k_scale``/``v_scale``
``[NB,bs,KVH]`` in q's dtype; int32 ``q_pos [B,T]``, ``pos [NB,bs]``,
``block_tables [B,MAXB]`` (-1 unused) and, for K3, ``cu_blocks [B+1]``
(``tuning.host_cu_blocks``).  hd is 64 or 128 and ``bs`` divides 64; k
and v start, and have their (block, row) strides, at multiples of 16
bytes (the kernels copy them in 16-byte pieces).  Anything else raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import aligned16, invoke, on_one_cuda_device, sm_count
from repro_torch.kernels.spec_verify_attn import LaunchCount

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
_BLOCK_DIVIDES = 64      # the block size must divide it
ROW_TILE = 8             # folded query rows (G * T) per block
STAGE_KEYS = 32          # keys per pipeline stage (max(32, bs))

DENSE = LaunchCount()    # launches of K2
RAGGED = LaunchCount()   # launches of K3

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("paged_verify_attn").paged_verify_attn
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, i, i] + [p] * 10 + [i] * 8 + [p] + [ll] * 11
                       + [ctypes.c_float, i, i, i, p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def occupancy(q_dtype: torch.dtype, kv_dtype: torch.dtype, hd: int, bs: int,
              MAXB: int) -> dict:
    """The partial kernel's blocks per SM of the current card and its dynamic
    shared memory per block at (q dtype, kv dtype, hd, bs, MAXB), as the CUDA
    runtime's occupancy calculator gives them (``chip_smoke.py`` prints them
    beside ptxas's registers)."""
    _check(q_dtype in (torch.float32, torch.bfloat16) and kv_dtype in (q_dtype, torch.int8)
           and hd in _HEAD_DIMS, f"no kernel for {q_dtype}/{kv_dtype}, hd {hd}")
    fn = build.load("paged_verify_attn").paged_verify_occupancy
    i, n, smem = ctypes.c_int, ctypes.c_int(0), ctypes.c_int(0)
    fn.argtypes = [i] * 5 + [ctypes.c_void_p] * 2
    fn.restype = i
    rc = fn(_DTYPE_CODE[q_dtype], _DTYPE_CODE[kv_dtype], hd, bs, MAXB, ctypes.byref(n),
            ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"paged_verify_attn occupancy query failed: cudaError {rc}")
    return {"blocks_per_sm": n.value, "smem_bytes": smem.value}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_verify_attn kernel: {msg}")


def row_tiles(rows: int) -> int:
    """Row tiles of ``rows = G * T`` folded query rows per (slot, kv-head)."""
    return -(-rows // ROW_TILE)


def n_splits(B: int, KVH: int, rows: int, MAXB: int, bs: int, sms: int) -> int:
    """How many blocks share one ``(slot, kv-head, row tile)``'s table row:
    1 when the ``B * KVH * row_tiles(rows)`` blocks already make two waves
    over ``sms`` SMs, else enough splits for two waves, at most ``MAXB``
    and no more than leaves each split one stage of keys.  A function of
    the shapes and the SM count only: K2 and K3 get the same count, and
    the launch shape never depends on the tables."""
    blocks = B * KVH * row_tiles(rows)
    if blocks >= 2 * sms:
        return 1
    cap = max(1, min(MAXB, MAXB * bs // STAGE_KEYS))
    return max(1, min(cap, -(-2 * sms // blocks)))


def workspace_floats(B: int, KVH: int, rows: int, hd: int, splits: int) -> int:
    """fp32 workspace of a call with ``splits > 1``: acc ``[parts, hd]``,
    then m and l ``[parts]``, parts = ``B * KVH * splits * row tiles *
    ROW_TILE``."""
    return B * KVH * splits * row_tiles(rows) * ROW_TILE * (hd + 2)


def _check_aligned(k, v, k_scale, v_scale) -> None:
    for name, t in (("k", k), ("v", v)):
        _check(aligned16(t),
               f"{name} must start and have (block, row) strides at multiples of 16 bytes")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(t is None or t.data_ptr() % 16 == 0,
               f"{name} must start at a multiple of 16 bytes")


def _launch(ragged: bool, q, k, v, q_pos, pos, block_tables, cu_blocks,
            window, prefix_len, scale, k_scale, v_scale) -> torch.Tensor:
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q/k/v must be 4-D")
    B, T, H, hd = q.shape
    NB, bs, KVH = k.shape[0], k.shape[1], k.shape[2]
    dev = q.device
    tensors = [q, k, v, q_pos, pos, block_tables]
    quant = k.dtype == torch.int8
    if quant:
        _check(k_scale is not None and v_scale is not None,
               "int8 k/v need k_scale and v_scale")
        tensors += [k_scale, v_scale]
    else:
        _check(k_scale is None and v_scale is None,
               "scales are only taken with int8 k/v")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"q dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == v.dtype and k.dtype in (q.dtype, torch.int8),
           f"k/v dtype {k.dtype}/{v.dtype} with q {q.dtype}")
    _check(hd in _HEAD_DIMS, f"head dim {hd} not in {_HEAD_DIMS}")
    _check(tuple(v.shape) == tuple(k.shape) and k.shape[3] == hd,
           f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} for q {tuple(q.shape)}")
    _check(KVH > 0 and H % KVH == 0, f"{H} heads over {KVH} kv-heads")
    _check(0 < bs <= _BLOCK_DIVIDES and _BLOCK_DIVIDES % bs == 0,
           f"block size {bs} must divide {_BLOCK_DIVIDES}")
    _check(B > 0 and T > 0 and NB > 0, "empty batch, query or pool")
    for name, t, n in (("q", q, H), ("k", k, KVH), ("v", v, KVH)):
        _check(t.stride(3) == 1 and t.stride(2) == hd,
               f"{name} must have contiguous [{n}, hd] rows")
    _check(tuple(q_pos.shape) == (B, T) and tuple(pos.shape) == (NB, bs),
           "q_pos [B,T] and pos [NB,bs]")
    _check(block_tables.dim() == 2 and block_tables.shape[0] == B
           and block_tables.shape[1] > 0, "block_tables [B,MAXB]")
    MAXB = block_tables.shape[1]
    for name, t in (("q_pos", q_pos), ("pos", pos), ("block_tables", block_tables)):
        _check(t.dtype == torch.int32 and t.stride(1) == 1,
               f"{name} must be int32, contiguous along its last axis")
    if ragged:
        _check(cu_blocks is not None and tuple(cu_blocks.shape) == (B + 1,)
               and cu_blocks.dtype == torch.int32 and cu_blocks.stride(0) == 1,
               "cu_blocks [B+1] int32")
        tensors.append(cu_blocks)
    if quant:
        for t in (k_scale, v_scale):
            _check(tuple(t.shape) == (NB, bs, KVH) and t.dtype == q.dtype
                   and t.stride(2) == 1, "scales [NB,bs,KVH] in q's dtype")
        _check(k_scale.stride() == v_scale.stride(),
               "k_scale and v_scale must share strides")
    _check(window is None or window >= 1, f"window {window}")
    _check(prefix_len >= 0, f"prefix_len {prefix_len}")
    _check_aligned(k, v, k_scale, v_scale)
    _check(on_one_cuda_device(tensors, dev), "every tensor must lie on one CUDA device")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    rows = (H // KVH) * T
    splits = n_splits(B, KVH, rows, MAXB, bs, sm_count(dev))
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
    ws = (torch.empty(workspace_floats(B, KVH, rows, hd, splits), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    s_sn, s_sl = (k_scale.stride(0), k_scale.stride(1)) if quant else (0, 0)
    rc = invoke(
        _kernel_fn, dev, int(ragged), _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        pos.data_ptr(), block_tables.data_ptr(),
        cu_blocks.data_ptr() if ragged else None,
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, out.data_ptr(),
        B, T, H, KVH, bs, MAXB, hd, splits,
        ws.data_ptr() if ws is not None else None, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), s_sn, s_sl,
        q_pos.stride(0), pos.stride(0), block_tables.stride(0),
        float(scale), int(window is not None), int(window or 0), int(prefix_len))
    if rc != 0:
        kind = "ragged" if ragged else "dense"
        raise RuntimeError(f"paged_verify_attn ({kind}) kernel launch failed: "
                           f"cudaError {rc}")
    (RAGGED if ragged else DENSE).launches += 1
    return out


def paged_verify_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, pos: torch.Tensor,
                           block_tables: torch.Tensor,
                           window: Optional[int] = None, prefix_len: int = 0,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: launch the dense walk on the current stream.  Returns
    ``[B,T,H,hd]`` in q's dtype."""
    return _launch(False, q, k, v, q_pos, pos, block_tables, None, window,
                   prefix_len, scale, k_scale, v_scale)


def ragged_paged_verify_attn_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, q_pos: torch.Tensor,
                                  pos: torch.Tensor, block_tables: torch.Tensor,
                                  cu_blocks: torch.Tensor,
                                  window: Optional[int] = None,
                                  prefix_len: int = 0,
                                  scale: Optional[float] = None,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None,
                                  ) -> torch.Tensor:
    """K3: launch the ragged walk on the current stream; ``cu_blocks`` must
    describe the same tables as ``block_tables``.  Returns ``[B,T,H,hd]`` in
    q's dtype."""
    return _launch(True, q, k, v, q_pos, pos, block_tables, cu_blocks, window,
                   prefix_len, scale, k_scale, v_scale)
