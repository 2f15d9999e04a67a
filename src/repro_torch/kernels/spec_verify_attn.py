"""Speculative-verify attention on Hopper: the wrapper of the hand-written
CUDA kernel ``csrc/spec_verify_attn.cu`` (K1).

It replaces the TPU kernel ``spec_verify_attn_pallas``
(``src/repro/kernels/spec_verify_attn.py``) together with the head folding
of its wrapper (``src/repro/kernels/ops.py``).  The kernel runs both
products on the tensor cores behind a 16-byte ``cp.async`` ring, reads the
cache in place in its ``[B, L, KVH, hd]`` layout through strides, reads
each K/V tile once for all query heads of a kv-head, and copies no tile
that no query can see; see the source for the design.

Two choices are made here, from the shapes alone, so that a launch never
depends on the data (and can be captured in a CUDA graph):

- :func:`row_tile`: calls of at most 16 folded rows ``G * T`` (the verify
  and decode steps of a G = 1 model) take blocks of one warp and 16 rows,
  the others blocks of four warps and 64 rows;
- :func:`n_splits`: when the ``(b, kv-head, row tile)`` blocks alone would
  not fill the card and the cache is long enough to pay for it, each
  one's visible key tiles are shared by several blocks (split-KV).  With
  more than one split a call issues two device kernels, the splits'
  partial results going through an fp32 workspace that the wrapper
  allocates; a launch count still counts calls.

The kernel takes q ``[B,T,H,hd]`` (float32 or bfloat16), k/v
``[B,L,KVH,hd]`` of the same dtype or int8 with ``k_scale``/``v_scale``
``[B,L,KVH]`` in q's dtype, int32 ``q_pos [B,T]`` / ``k_pos [B,L]``, and
hd in {64, 128, 256}.  q, k and v are copied 16 bytes at a time, so they must
start, and have their (b, t) / (b, l) strides, at multiples of 16 bytes.
Anything else raises.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import aligned16, invoke, on_one_cuda_device, sm_count

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128, 256)
ROW_TILES = (16, 64)     # folded rows per block: one warp, four warps
KEY_TILE = 32            # keys per tile of the kernel's ring
# key tiles of the cache a split must have at least, by row tile: a split
# of a 64-row tile writes 64 rows of fp32 partials that the combine reads
# back, so it pays only over longer caches than a 16-row one.  At hd 256 a
# tile carries twice hd 128's bytes and products, and a block (one an SM in
# fp32) walks it slower, so splits pay over shorter caches
SPLIT_MIN_TILES = {16: 8, 64: 16}
SPLIT_MIN_TILES_HD256 = {16: 4, 64: 4}


@dataclass
class LaunchCount:
    """Calls that reached one implementation (a plain integer per wrapper)."""
    launches: int = 0


KERNEL = LaunchCount()        # calls of the CUDA kernel
KERNEL_INT8 = LaunchCount()   # those of them over int8 k/v with scales

_fns = {}


def _lib():
    if not _fns:
        lib = build.load("spec_verify_attn")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.spec_verify_attn.argtypes = ([i, i] + [p] * 8 + [i] * 8 + [p] + [ll] * 10
                                         + [ctypes.c_float, i, i, i, p])
        lib.spec_verify_attn.restype = ctypes.c_int
        lib.spec_verify_occupancy.argtypes = [i] * 5 + [ctypes.POINTER(i)] * 2
        lib.spec_verify_occupancy.restype = ctypes.c_int
        _fns.update(launch=lib.spec_verify_attn, occupancy=lib.spec_verify_occupancy)
    return _fns


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"spec_verify_attn kernel: {msg}")


def row_tile(rows: int) -> int:
    """Folded rows per block for ``rows = G * T``: 16 (one warp) when they
    fit, else 64 (four warps)."""
    return ROW_TILES[0] if rows <= ROW_TILES[0] else ROW_TILES[1]


def row_tiles(rows: int) -> int:
    """Row tiles of ``rows = G * T`` folded query rows per (b, kv-head)."""
    rt = row_tile(rows)
    return -(-rows // rt)


def n_splits(B: int, KVH: int, rows: int, L: int, sms: int, hd: int) -> int:
    """How many blocks share one ``(b, kv-head, row tile)``'s visible key
    tiles: 1 when the ``B * KVH * row_tiles(rows)`` blocks already give
    every one of ``sms`` SMs a block, else enough splits for two blocks an
    SM, at most one per ``SPLIT_MIN_TILES`` key tiles of the cache
    (``SPLIT_MIN_TILES_HD256`` at head dim 256).  A function of the shapes
    and the SM count only.

    Set from ``tools/verify_attn_variants.py``'s sweep of forced split
    counts on the card: from 64 blocks up over a 256-row cache, and at the
    B = 1 prefills into a 512-row ring, every split made the call slower,
    the combine costing more than the shorter chain of tiles saves; a
    B = 1 decode over 512-4096 rows or a prefill over 1024-4096 rows gains
    from it.  At hd 256 (paligemma-3b's one kv-head, ``--pali``) the B
    4-16, s 3 verifies over 512 rows ran 1.8x (bf16) and 2.7x (fp32)
    faster at 4 splits than unsplit, the B 1 prefill of 384 rows 1.2x and
    1.9x, and a B 16 prefill (768 blocks) fastest unsplit."""
    rt = row_tile(rows)
    blocks = B * KVH * row_tiles(rows)
    if blocks >= sms:
        return 1
    cap = (-(-L // KEY_TILE)) // (SPLIT_MIN_TILES_HD256 if hd == 256 else SPLIT_MIN_TILES)[rt]
    return max(1, min(cap, -(-2 * sms // blocks)))


def workspace_floats(B: int, KVH: int, rows: int, hd: int, splits: int) -> int:
    """fp32 workspace of a call with ``splits > 1``: acc ``[parts, hd]``,
    then m and l ``[parts]``, parts = ``B * KVH * splits * row tiles *
    row_tile``."""
    return B * KVH * splits * row_tiles(rows) * row_tile(rows) * (hd + 2)


def _launch_fn():
    return _lib()["launch"]


def occupancy(q_dtype: torch.dtype, kv_dtype: torch.dtype, hd: int, rows: int,
              L: int) -> dict:
    """The kernel's blocks per SM of the current card and its dynamic shared
    memory per block at (q dtype, kv dtype, hd, the row tile of ``rows``
    folded rows, a cache of L rows), as the CUDA runtime's occupancy
    calculator gives them (``chip_smoke.py`` prints them beside ptxas's
    registers)."""
    _check(q_dtype in (torch.float32, torch.bfloat16) and kv_dtype in (q_dtype, torch.int8)
           and hd in _HEAD_DIMS, f"no kernel for {q_dtype}/{kv_dtype}, hd {hd}")
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib()["occupancy"](_DTYPE_CODE[q_dtype], _DTYPE_CODE[kv_dtype], hd,
                             row_tile(rows), L, ctypes.byref(n), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"spec_verify_attn occupancy query failed: cudaError {rc}")
    return {"blocks_per_sm": n.value, "smem_bytes": smem.value}


def spec_verify_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, k_pos: torch.Tensor,
                          window: Optional[int] = None, prefix_len: int = 0,
                          scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          ) -> torch.Tensor:
    """Launch the kernel on the current stream.  Returns ``[B,T,H,hd]`` in
    q's dtype."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q/k/v must be 4-D")
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    dev = q.device
    tensors = [q, k, v, q_pos, k_pos]
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
    _check(tuple(k.shape) == (B, L, KVH, hd) and tuple(v.shape) == (B, L, KVH, hd),
           f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} for q {tuple(q.shape)}")
    _check(KVH > 0 and H % KVH == 0, f"{H} heads over {KVH} kv-heads")
    _check(B > 0 and T > 0 and L > 0, "empty batch, query or cache")
    for name, t, n in (("q", q, H), ("k", k, KVH), ("v", v, KVH)):
        _check(t.stride(3) == 1 and t.stride(2) == hd,
               f"{name} must have contiguous [{n}, hd] rows")
    _check(tuple(q_pos.shape) == (B, T) and tuple(k_pos.shape) == (B, L),
           "q_pos [B,T] and k_pos [B,L]")
    _check(q_pos.dtype == torch.int32 and k_pos.dtype == torch.int32,
           "positions must be int32")
    _check(q_pos.stride(1) == 1 and k_pos.stride(1) == 1,
           "positions must be contiguous along t / l")
    if quant:
        for t in (k_scale, v_scale):
            _check(tuple(t.shape) == (B, L, KVH) and t.dtype == q.dtype
                   and t.stride(2) == 1, "scales [B,L,KVH] in q's dtype")
        _check(k_scale.stride() == v_scale.stride(),
               "k_scale and v_scale must share strides")
    _check(window is None or window >= 1, f"window {window}")
    _check(prefix_len >= 0, f"prefix_len {prefix_len}")
    _check(on_one_cuda_device(tensors, dev), "every tensor must lie on one CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(aligned16(t), f"{name} must start and have its two outer strides at "
                             "multiples of 16 bytes")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    rows = (H // KVH) * T
    splits = n_splits(B, KVH, rows, L, sm_count(dev), hd)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
    ws = (torch.empty(workspace_floats(B, KVH, rows, hd, splits), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    s_sb, s_sl = (k_scale.stride(0), k_scale.stride(1)) if quant else (0, 0)
    rc = invoke(
        _launch_fn, dev, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, out.data_ptr(),
        B, T, H, KVH, L, hd, row_tile(rows), splits,
        ws.data_ptr() if ws is not None else None, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), s_sb, s_sl,
        q_pos.stride(0), k_pos.stride(0), float(scale),
        int(window is not None), int(window or 0), int(prefix_len))
    if rc != 0:
        raise RuntimeError(f"spec_verify_attn kernel launch failed: cudaError {rc}")
    KERNEL.launches += 1
    KERNEL_INT8.launches += int(quant)
    return out
