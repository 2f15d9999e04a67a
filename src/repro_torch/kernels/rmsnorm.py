"""RMSNorm on Hopper: the wrappers of the hand-written CUDA kernels in
``csrc/rmsnorm.cu`` (K5, forward and backward).

They replace the TPU kernel ``rmsnorm_pallas``
(``src/repro/kernels/rmsnorm.py``), which computes the model's ``rms_norm``:
an fp32 row reduction, the normalized row cast to x's dtype, then the
multiply by gamma in that dtype.  The kernels are bound by bytes (a few
operations per element); see the source for the design.

Both take contiguous rows ``x [n, d]`` and ``gamma [d]`` of one dtype,
float32 or bfloat16, with d <= 8192.  Anything else raises.  The forward
writes the fp32 ``rstd [n]`` the backward reads only when asked to; the
backward returns ``dx`` and ``dgamma``, the latter summed over the rows
without atomics (the same result from run to run).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.spec_verify_attn import LaunchCount

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192

FWD = LaunchCount()   # launches of the forward kernel
BWD = LaunchCount()   # calls of the backward (dx kernel, then the dgamma reduction)

_fns = {}


def _lib():
    if not _fns:
        lib = build.load("rmsnorm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_fwd.argtypes = [i, p, p, p, p, i, i, ctypes.c_float, p]
        lib.rmsnorm_bwd.argtypes = [i, p, p, p, p, p, p, p, i, i, p]
        lib.rmsnorm_bwd_blocks.argtypes = [i]
        for f in (lib.rmsnorm_fwd, lib.rmsnorm_bwd, lib.rmsnorm_bwd_blocks):
            f.restype = ctypes.c_int
        _fns.update(fwd=lib.rmsnorm_fwd, bwd=lib.rmsnorm_bwd, blocks=lib.rmsnorm_bwd_blocks)
    return _fns


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm kernel: {msg}")


def _check_rows(x: torch.Tensor, gamma: torch.Tensor, *others: torch.Tensor) -> None:
    _check(x.dim() == 2, "x must be [n, d]")
    n, d = x.shape
    _check(x.dtype in _DTYPE_CODE, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(gamma.dtype == x.dtype and tuple(gamma.shape) == (d,),
           f"gamma {tuple(gamma.shape)} {gamma.dtype} for x [{n}, {d}] {x.dtype}")
    _check(0 < d <= MAX_D and n > 0, f"x [{n}, {d}] (0 < d <= {MAX_D})")
    _check(all(t.is_contiguous() for t in (x, gamma, *others)), "tensors must be contiguous")
    _check(x.device.type == "cuda"
           and all(t.device == x.device for t in (gamma, *others)),
           "every tensor must lie on one CUDA device")


def rmsnorm_fwd_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
                     save_rstd: bool = False):
    """``y [n, d]`` in x's dtype, and ``rstd [n]`` fp32 when ``save_rstd``
    (else None)."""
    _check_rows(x, gamma)
    n, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device) if save_rstd else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib()["fwd"](_DTYPE_CODE[x.dtype], x.data_ptr(), gamma.data_ptr(),
                           y.data_ptr(), rstd.data_ptr() if save_rstd else None, n, d,
                           float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm forward launch failed: cudaError {rc}")
    FWD.launches += 1
    return y, rstd


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     rstd: torch.Tensor):
    """``(dx [n, d], dgamma [d])`` in x's dtype from the forward's ``rstd``."""
    _check_rows(x, gamma, dy, rstd)
    n, d = x.shape
    _check(tuple(dy.shape) == (n, d) and dy.dtype == x.dtype, "dy must match x")
    _check(tuple(rstd.shape) == (n,) and rstd.dtype == torch.float32, "rstd must be [n] fp32")
    fns = _lib()
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    part = torch.empty((fns["blocks"](n), d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fns["bwd"](_DTYPE_CODE[x.dtype], x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                        rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), part.data_ptr(),
                        n, d, stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: cudaError {rc}")
    BWD.launches += 1
    return dx, dgamma
