"""Speculative-verify attention on Hopper: the wrapper of the hand-written
CUDA kernel ``csrc/spec_verify_attn.cu``.

It replaces the TPU kernel ``spec_verify_attn_pallas``
(``src/repro/kernels/spec_verify_attn.py``) together with the head folding
of its wrapper (``src/repro/kernels/ops.py``).  On the card the kernel is
bound by bytes: at the verify shapes it reads every K/V row of the cache for
a handful of dot products (33.5 MB per target layer at B = 8, L = 256).  It
therefore reads the cache in place in its ``[B, L, KVH, hd]`` layout through
strides, reads each K/V tile once for all query heads of a kv-head, and
skips tiles that no query can see; see the source for the design.

The kernel takes q ``[B,T,H,hd]`` (float32 or bfloat16), k/v
``[B,L,KVH,hd]`` of the same dtype or int8 with ``k_scale``/``v_scale``
``[B,L,KVH]`` in q's dtype, int32 ``q_pos [B,T]`` / ``k_pos [B,L]``, and
hd in {64, 128}.  Anything else raises.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)


@dataclass
class LaunchCount:
    """Calls that reached one implementation (a plain integer per wrapper)."""
    launches: int = 0


KERNEL = LaunchCount()   # launches of the CUDA kernel

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("spec_verify_attn").spec_verify_attn
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i, i] + [p] * 8 + [i] * 6 + [ll] * 10
                       + [ctypes.c_float, i, i, i, p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"spec_verify_attn kernel: {msg}")


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
    _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
           "every tensor must lie on one CUDA device")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
    s_sb, s_sl = (k_scale.stride(0), k_scale.stride(1)) if quant else (0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_fn()(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], q.data_ptr(),
            k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, out.data_ptr(),
            B, T, H, KVH, L, hd, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), s_sb, s_sl,
            q_pos.stride(0), k_pos.stride(0), float(scale),
            int(window is not None), int(window or 0), int(prefix_len), stream)
    if rc != 0:
        raise RuntimeError(f"spec_verify_attn kernel launch failed: cudaError {rc}")
    KERNEL.launches += 1
    return out
