"""Mamba-2 SSD chunked scan on Hopper: the wrapper of the hand-written CUDA
kernel ``csrc/ssd_chunk.cu`` (K6).

It replaces the TPU kernel ``ssd_chunk_pallas``
(``src/repro/kernels/ssd_chunk.py``) and the chunk loop the JAX model runs
around it (``Mamba2LM._ssd_chunked``, ``src/repro/models/mamba2.py``): one
launch scans every chunk of a layer's prefill, one block per (batch, head)
carrying the state from chunk to chunk.  On the card it is bound by
operations (about 21 MFLOP per (batch, head) and 256-row chunk at
mamba2-1.3b's widths); see the source for the design.

``ssd_chunked_cuda`` takes the model's layout: xh ``[B,T,H,P]`` and B/C
``[B,T,G,N]`` (float32 or bfloat16, innermost dim contiguous, read in place
through strides), dt ``[B,T,H]`` float32, A ``[H]`` float32 and h0
``[B,H,P,N]`` float32 contiguous, with P and N at most 128.
``ssd_chunk_cuda`` is the one-chunk contract of ``repro.kernels.ops.ssd_chunk``
(``[BH, Q, ...]``, Q at most 256, an explicit log-decay l).  Anything else
raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunk_len
from repro_torch.kernels.spec_verify_attn import LaunchCount

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_P = MAX_N = 128
MAX_Q = 256

KERNEL = LaunchCount()   # launches of the CUDA kernel

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("ssd_chunk").ssd_chunk_scan
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i] + [p] * 9 + [i] * 7 + [ll] * 12 + [p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_chunk kernel: {msg}")


def ssd_chunked_cuda(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                     dt: torch.Tensor, A: Optional[torch.Tensor], h0: torch.Tensor,
                     chunk: int, l: Optional[torch.Tensor] = None):
    """Launch the scan on the current stream: chunks of Q =
    ``ssd_chunk_len(T, chunk)`` rows in order, log-decay ``l`` [B,T,H] when
    given, else ``-dt * A``.  Returns (y [B,T,H,P] fp32, h_final [B,H,P,N]
    fp32)."""
    _check(xh.dim() == 4 and B_.dim() == 4 and C_.dim() == 4,
           "xh must be [B,T,H,P] and B/C [B,T,G,N]")
    Bsz, T, H, P = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    dev = xh.device
    _check(xh.dtype in _DTYPE_CODE, f"dtype {xh.dtype} (float32 or bfloat16)")
    _check(B_.dtype == xh.dtype and C_.dtype == xh.dtype,
           f"B/C dtype {B_.dtype}/{C_.dtype} with xh {xh.dtype}")
    _check(tuple(B_.shape) == (Bsz, T, G, N) and tuple(C_.shape) == (Bsz, T, G, N),
           f"B/C shape {tuple(B_.shape)}/{tuple(C_.shape)} for xh {tuple(xh.shape)}")
    _check(Bsz > 0 and T > 0 and G > 0 and H % G == 0, f"{H} heads over {G} groups, T {T}")
    _check(0 < P <= MAX_P and 0 < N <= MAX_N, f"P {P}, N {N} (at most {MAX_P})")
    _check(all(t.stride(3) == 1 for t in (xh, B_, C_)),
           "xh and B/C must be contiguous along their last dim")
    _check(dt.dtype == torch.float32 and tuple(dt.shape) == (Bsz, T, H),
           "dt must be [B,T,H] float32")
    if l is None:
        _check(A is not None and A.dtype == torch.float32 and tuple(A.shape) == (H,)
               and A.is_contiguous(), "A must be [H] float32, contiguous")
    else:
        _check(l.dtype == torch.float32 and l.shape == dt.shape and l.stride() == dt.stride(),
               "l must be float32 with dt's shape and strides")
    _check(h0.dtype == torch.float32 and tuple(h0.shape) == (Bsz, H, P, N)
           and h0.is_contiguous(), "h0 must be [B,H,P,N] float32, contiguous")
    tensors = [xh, B_, C_, dt, h0] + [t for t in (A, l) if t is not None]
    _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
           "every tensor must lie on one CUDA device")
    Q = ssd_chunk_len(T, chunk)
    _check(Q <= MAX_Q, f"chunk {chunk} gives Q {Q} > {MAX_Q}")
    y = torch.empty((Bsz, T, H, P), dtype=torch.float32, device=dev)
    h_out = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_fn()(
            _DTYPE_CODE[xh.dtype], xh.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            dt.data_ptr(), l.data_ptr() if l is not None else None,
            A.data_ptr() if l is None else None, h0.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), Bsz, T, H, G, P, N, Q,
            xh.stride(0), xh.stride(1), xh.stride(2),
            B_.stride(0), B_.stride(1), B_.stride(2),
            C_.stride(0), C_.stride(1), C_.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError {rc}")
    KERNEL.launches += 1
    return y, h_out


def ssd_chunk_cuda(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   dt: torch.Tensor, l: torch.Tensor, h0: torch.Tensor):
    """One chunk for a batch of (batch*head) slices: x [BH,Q,P]; b/c
    [BH,Q,N]; dt/l [BH,Q] float32; h0 [BH,P,N] float32.  Returns (y
    [BH,Q,P], h_new [BH,P,N]) in fp32, as ``ssd_chunk_pallas``."""
    _check(x.dim() == 3 and b.dim() == 3 and c.dim() == 3 and dt.dim() == 2
           and l.dim() == 2 and h0.dim() == 3, "x/b/c [BH,Q,.], dt/l [BH,Q], h0 [BH,P,N]")
    Q = x.shape[1]
    _check(Q <= MAX_Q, f"Q {Q} > {MAX_Q}")
    y, h = ssd_chunked_cuda(x[:, :, None], b[:, :, None], c[:, :, None], dt[:, :, None],
                            None, h0[:, None], chunk=Q, l=l[:, :, None])
    return y[:, :, 0], h[:, 0]
