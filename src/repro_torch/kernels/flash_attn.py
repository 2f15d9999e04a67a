"""Position-masked flash attention on Hopper: the wrappers of the
hand-written CUDA kernels in ``csrc/flash_attn.cu`` (K4, forward and
backward).

They replace the TPU kernel ``flash_attn_pallas``
(``src/repro/kernels/flash_attn.py``) and the head folding of its wrapper
(``src/repro/kernels/ops.py``), and compute what the JAX model trains and
prefills with (``flash_attention_train`` and ``flash_attention_tri``): GQA
attention masked by absolute positions (causal, window, prefix; ``-1`` rows
never attended), fp32 softmax, a fully masked row giving zeros.  The
forward optionally writes the fp32 logsumexp ``lse [B, H, T]``; the backward
recomputes the probabilities from it and returns ``dq``, ``dk``, ``dv``
(dK and dV of a kv-head summed over its query heads) without atomics.

The kernels take q ``[B,T,H,hd]`` and k/v ``[B,L,KVH,hd]`` of one dtype,
float32 or bfloat16, read in place through their (b, t) strides with heads
and hd contiguous; int32 ``q_pos [B,T]`` / ``k_pos [B,L]``; hd in {64, 128}.
The forward copies q, k and v rows 16 bytes at a time, so their addresses
and (b, t) strides must be multiples of 16 bytes.  Anything else raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.spec_verify_attn import LaunchCount

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

FWD = LaunchCount()   # launches of the forward kernel
BWD = LaunchCount()   # calls of the backward (the dQ kernel, then the dK/dV kernel)

_fns = {}


def _lib():
    if not _fns:
        lib = build.load("flash_attn")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i] * 6 + [ll] * 8 + [ctypes.c_float, i, i, i, p]
        lib.flash_attn_fwd.argtypes = [i] + [p] * 7 + tail
        lib.flash_attn_bwd.argtypes = [i] + [p] * 12 + tail
        lib.flash_attn_fwd_occupancy.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.flash_attn_fwd.restype = lib.flash_attn_bwd.restype = ctypes.c_int
        lib.flash_attn_fwd_occupancy.restype = ctypes.c_int
        _fns.update(fwd=lib.flash_attn_fwd, bwd=lib.flash_attn_bwd,
                    occupancy=lib.flash_attn_fwd_occupancy)
    return _fns


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attn kernel: {msg}")


def _check_inputs(q, k, v, q_pos, k_pos, window, prefix_len, extra=()):
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q/k/v must be 4-D")
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    _check(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           f"k/v dtype {k.dtype}/{v.dtype} with q {q.dtype}")
    _check(hd in _HEAD_DIMS, f"head dim {hd} not in {_HEAD_DIMS}")
    _check(tuple(k.shape) == (B, L, KVH, hd) and tuple(v.shape) == (B, L, KVH, hd),
           f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} for q {tuple(q.shape)}")
    _check(KVH > 0 and H % KVH == 0, f"{H} heads over {KVH} kv-heads")
    _check(B > 0 and T > 0 and L > 0, "empty batch, query or key rows")
    for name, t, n in (("q", q, H), ("k", k, KVH), ("v", v, KVH)):
        _check(t.stride(3) == 1 and t.stride(2) == hd,
               f"{name} must have contiguous [{n}, hd] rows")
    _check(tuple(q_pos.shape) == (B, T) and tuple(k_pos.shape) == (B, L),
           "q_pos [B,T] and k_pos [B,L]")
    _check(q_pos.dtype == torch.int32 and k_pos.dtype == torch.int32,
           "positions must be int32")
    _check(q_pos.stride(1) == 1 and k_pos.stride(1) == 1,
           "positions must be contiguous along t / l")
    _check(window is None or window >= 1, f"window {window}")
    _check(prefix_len >= 0, f"prefix_len {prefix_len}")
    dev = q.device
    _check(dev.type == "cuda"
           and all(t.device == dev for t in (k, v, q_pos, k_pos, *extra)),
           "every tensor must lie on one CUDA device")


def _geometry(q, k, v, q_pos, k_pos, scale, window, prefix_len):
    """The arguments both entry points share, after the pointers."""
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    return (B, T, H, KVH, L, hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), q_pos.stride(0), k_pos.stride(0), float(scale),
            int(window is not None), int(window or 0), int(prefix_len))


def _check_aligned(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        es = t.element_size()
        _check(t.data_ptr() % 16 == 0
               and all(t.shape[d] == 1 or (t.stride(d) * es) % 16 == 0 for d in (0, 1)),
               f"{name} must start and have (b, t) strides at multiples of 16 bytes")


def fwd_occupancy(dtype: torch.dtype, hd: int) -> dict:
    """The forward kernel's blocks per SM of the current card and its
    dynamic shared memory per block, at (dtype, hd), as the CUDA runtime's
    occupancy calculator gives them.  ``chip_smoke.py`` prints them beside
    ptxas's registers: registers and shared memory alone do not give the
    blocks per SM (register allocation granularity, the carveout)."""
    _check(dtype in _DTYPE_CODE and hd in _HEAD_DIMS, f"no forward for {dtype}, hd {hd}")
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib()["occupancy"](_DTYPE_CODE[dtype], hd, ctypes.byref(n), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"flash_attn occupancy query failed: cudaError {rc}")
    return {"blocks_per_sm": n.value, "smem_bytes": smem.value}


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int] = None, prefix_len: int = 0,
                        scale: Optional[float] = None, save_lse: bool = False):
    """Launch the forward on the current stream.  Returns ``(out [B,T,H,hd]``
    in q's dtype, ``lse [B,H,T]`` fp32 when ``save_lse`` else None)."""
    _check_inputs(q, k, v, q_pos, k_pos, window, prefix_len)
    _check_aligned(q, k, v)
    B, T, H, hd = q.shape
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if save_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()["fwd"](
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
            lse.data_ptr() if save_lse else None,
            *_geometry(q, k, v, q_pos, k_pos, scale, window, prefix_len), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn forward launch failed: cudaError {rc}")
    FWD.launches += 1
    return out, lse


def flash_attn_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int] = None, prefix_len: int = 0,
                        scale: Optional[float] = None):
    """Launch the backward (two kernels) on the current stream.  ``o`` is
    the forward's output and ``lse`` its logsumexp; ``do`` is taken
    contiguous.  Returns ``(dq, dk, dv)`` in q's dtype."""
    _check_inputs(q, k, v, q_pos, k_pos, window, prefix_len, (o, do, lse))
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    do = do.contiguous()
    _check(o.is_contiguous() and tuple(o.shape) == (B, T, H, hd) and o.dtype == q.dtype,
           "o must be the contiguous forward output")
    _check(tuple(do.shape) == (B, T, H, hd) and do.dtype == q.dtype, "do must match o")
    _check(lse.is_contiguous() and tuple(lse.shape) == (B, H, T)
           and lse.dtype == torch.float32, "lse must be [B,H,T] fp32")
    dq = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, L, KVH, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dsum = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib()["bwd"](
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
            dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_geometry(q, k, v, q_pos, k_pos, scale, window, prefix_len), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn backward launch failed: cudaError {rc}")
    BWD.launches += 1
    return dq, dk, dv
