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
without atomics (the same result from run to run).  Two choices are made
here, from the shapes alone: :func:`fwd_plan` and :func:`bwd_plan`, the
forward's and the backward's grids (the backward's also from the SM count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import invoke, on_one_cuda_device, sm_count
from repro_torch.kernels.spec_verify_attn import LaunchCount

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192
# accesses a thread makes of a row, as the backward's rows kernel is built
# for them: of 16 bytes (fp32, bf16), or of one value (d or a base not
# 16-byte aligned)
CHUNKS = {4: (1, 2, 4, 8), 8: (1, 2, 4), 1: (2, 8, 32)}
# ... and as the forward kernel is built for them: every plan fwd_plan can
# give for d <= MAX_D names one of these
FWD_CHUNKS = {4: (1, 2, 4, 8), 8: (1, 2, 4), 1: (1, 2, 4, 8, 16, 32)}
FWD_THREADS = 256      # threads of a forward block at most (groups x lanes)
FWD_BLOCK = 128        # threads of a forward block the rule aims at
BF16_ONE_ACCESS = 128  # bf16 rows of at most this many 16-byte accesses: one a lane
FWD_MIN_LANES = 8      # lanes a group at least
BLOCK_WARPS = 8        # warps of a rows block at most (units x warps a unit)
COMBINE_THREADS = 256  # threads of a dgamma combine block

# the plans' entries rmsnorm_fwd (after eps) and rmsnorm_bwd (after n and
# d) take, in their order
FWD_ARGS = ("vec", "lanes", "chunks", "gpb")
BWD_ARGS = ("vec", "wpr", "chunks", "upb", "rpu", "units", "blocks", "ldp", "strip")

FWD = LaunchCount()   # launches of the forward kernel
BWD = LaunchCount()   # calls of the backward (the rows kernel, then the dgamma combine)

_fns = {}


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_fwd.argtypes = [i, p, p, p, p, i, i, ctypes.c_float] + [i] * 4 + [p]
    lib.rmsnorm_bwd.argtypes = [i] + [p] * 7 + [i] * 11 + [p]
    lib.rmsnorm_fwd_occupancy.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    lib.rmsnorm_bwd_occupancy.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    for f in (lib.rmsnorm_fwd, lib.rmsnorm_bwd, lib.rmsnorm_fwd_occupancy,
              lib.rmsnorm_bwd_occupancy):
        f.restype = ctypes.c_int
    _fns.update(fwd=lib.rmsnorm_fwd, bwd=lib.rmsnorm_bwd,
                fwd_occupancy=lib.rmsnorm_fwd_occupancy, occupancy=lib.rmsnorm_bwd_occupancy)


def _lib():
    if not _fns:
        _bind(build.load("rmsnorm"))
    return _fns


def _fwd_fn():
    return _lib()["fwd"]


def _bwd_fn():
    return _lib()["bwd"]


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
    _check(on_one_cuda_device((x, gamma, *others), x.device),
           "every tensor must lie on one CUDA device")


@functools.lru_cache(maxsize=None)
def fwd_grid(d: int, elem_bytes: int, aligned: bool = True, lanes: int = 0,
             gpb: int = 0) -> tuple:
    """``(vec, lanes, chunks, gpb)``: :func:`fwd_plan`'s entries that
    ``rmsnorm_fwd`` takes (``FWD_ARGS``), which do not depend on n;
    memoised, so the wrapper's host cost is one lookup a call."""
    vw = 16 // elem_bytes
    vec = vw if aligned and d % vw == 0 else 1
    nacc = -(-d // vec)
    if lanes:
        _check(lanes & (lanes - 1) == 0 and 1 <= lanes <= FWD_THREADS,
               f"lanes {lanes} (a power of two up to {FWD_THREADS})")
    else:
        # 16-byte accesses a lane: fp32 4; bf16 1, 2 for rows of more than
        # 128 accesses; one-value accesses: all 256 lanes
        per = 4 if vec == 4 else 1 if vec == 1 or nacc <= BF16_ONE_ACCESS else 2
        lanes = FWD_MIN_LANES if vec > 1 else FWD_THREADS
        while lanes < FWD_THREADS and lanes * per < nacc:
            lanes *= 2
    chunks = next((c for c in FWD_CHUNKS[vec] if c * lanes >= nacc), None)
    _check(chunks is not None, f"no forward kernel for d {d} at {lanes} lanes (vec {vec})")
    if gpb:
        _check(1 <= gpb and lanes * gpb <= FWD_THREADS and lanes * gpb % 32 == 0,
               f"{gpb} groups of {lanes} lanes a block (whole warps, at most "
               f"{FWD_THREADS} threads)")
    else:
        gpb = max(1, FWD_BLOCK // lanes)
    return vec, lanes, chunks, gpb


def fwd_plan(n: int, d: int, elem_bytes: int, aligned: bool = True, lanes: int = 0,
             gpb: int = 0) -> dict:
    """The forward's grid, from the shapes alone.

    ``vec``: values an access, 16 bytes' worth when d and the bases allow
    (else 1).  ``lanes``: threads that share a row (a group), a power of two
    from 8 to 256: with 16-byte accesses the fewest that leave each lane 4
    accesses of an fp32 row, 1 of a bf16 row of up to 128 accesses (d up to
    1024) and 2 of a longer one, with one-value accesses 256; ``chunks`` the
    accesses a lane makes, rounded up to a count the kernel is built for.
    A row's summation order follows from these two alone, and they follow
    from d, the dtype and the alignment: a row gives the same bits in a call
    of any n.  A group owns one row (in the sweep, several rows a group with
    the next row's loads ahead won at no shape, up to 65536 rows).  ``gpb``:
    groups a block, ``FWD_BLOCK // lanes`` (one where a group is wider); the
    rule reads no SM count (in the sweep, smaller blocks that spread a small
    call over more SMs lost); ``blocks = ceil(n / gpb)``.  Nonzero ``lanes``
    or ``gpb`` force that choice, and a forced entry the kernel cannot take
    raises (``tools/rmsnorm_variants.py --fwd``'s sweep, which set this
    rule: PERF.md §6).  ``instance``: the kernel's template (vec, chunks
    from ``FWD_CHUNKS``); ``device_kernels``: 1."""
    vec, lanes, chunks, gpb = fwd_grid(d, elem_bytes, aligned, lanes, gpb)
    return {"vec": vec, "lanes": lanes, "chunks": chunks, "gpb": gpb,
            "blocks": -(-n // gpb), "threads": lanes * gpb, "instance": (vec, chunks),
            "device_kernels": 1}


def fwd_occupancy(dtype: torch.dtype, plan: dict) -> int:
    """Blocks per SM of the forward kernel at ``plan`` on the current card
    (the CUDA runtime's occupancy calculator); raises for an instance the
    library was not built with."""
    _check(dtype in _DTYPE_CODE, f"dtype {dtype}")
    out = ctypes.c_int(0)
    rc = _lib()["fwd_occupancy"](_DTYPE_CODE[dtype], *(plan[k] for k in (
        "vec", "chunks", "lanes", "gpb")), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"rmsnorm forward occupancy query failed: cudaError {rc}")
    return out.value


def rmsnorm_fwd_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
                     save_rstd: bool = False):
    """``y [n, d]`` in x's dtype, and ``rstd [n]`` fp32 when ``save_rstd``
    (else None)."""
    _check_rows(x, gamma)
    n, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty((n,), dtype=torch.float32, device=x.device) if save_rstd else None
    aligned = x.data_ptr() % 16 == 0 and gamma.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    rc = invoke(_fwd_fn, x.device, _DTYPE_CODE[x.dtype], x.data_ptr(), gamma.data_ptr(),
                y.data_ptr(), rstd.data_ptr() if save_rstd else None, n, d, float(eps),
                *fwd_grid(d, x.element_size(), aligned))
    if rc != 0:
        raise RuntimeError(f"rmsnorm forward launch failed: cudaError {rc}")
    FWD.launches += 1
    return y, rstd


def _chunks(need: int, vec: int):
    """The fewest accesses a thread the rows kernel is built for that cover
    ``need``, or None."""
    return next((c for c in CHUNKS[vec] if c >= need), None)


def bwd_plan(n: int, d: int, sms: int, elem_bytes: int, aligned: bool = True,
             wpr: int = 0, rpu: int = 0, strip: int = 0) -> dict:
    """The backward's grid, from the shapes and the SM count alone.

    ``vec``: values an access, 16 bytes' worth when d and the bases allow
    (else 1).  ``wpr``: warps a unit (the threads that share a row): 8,
    fewer where a row has fewer accesses than the unit threads; ``chunks``
    the accesses a thread makes of a row, rounded up to a count the kernel
    is built for.  ``rpu``: rows a unit, so that there are about two units
    an SM (four where d <= 1024: a partial row is cheap there); each unit
    owns rows ``[u * rpu, (u + 1) * rpu)`` and writes one partial row, so
    ``units = ceil(n / rpu)`` is also the scratch's rows, ``ldp`` its row
    stride (d rounded up to 4).  ``upb``: units a block, one unless a
    forced ``rpu`` leaves more than two units an SM, at most 8 warps a
    block.  ``strip``: 4-column groups a combine block, 2.  Nonzero
    ``wpr``, ``rpu`` or ``strip`` force that choice
    (``tools/rmsnorm_variants.py``'s sweep, which set this rule: PERF.md
    §6)."""
    vw = 16 // elem_bytes
    vec = vw if aligned and d % vw == 0 else 1
    nacc = -(-d // vec)
    if not wpr:
        wpr = BLOCK_WARPS
        while wpr > 1 and 32 * wpr > nacc:
            wpr //= 2
    chunks = _chunks(-(-nacc // (32 * wpr)), vec)
    while chunks is None:                     # a forced wpr too small for d
        wpr *= 2
        chunks = _chunks(-(-nacc // (32 * wpr)), vec)
    rpu = rpu or max(1, -(-n // ((2 if d > 1024 else 4) * sms)))
    units = -(-n // rpu)
    upb = min(max(1, units // (2 * sms)), BLOCK_WARPS // wpr)
    ldp = -(-d // 4) * 4
    strip = strip or 2
    return {"vec": vec, "wpr": wpr, "chunks": chunks, "upb": upb, "rpu": rpu,
            "units": units, "blocks": -(-units // upb), "threads": 32 * wpr * upb,
            "ldp": ldp, "strip": strip, "combine_blocks": -(-(ldp // 4) // strip),
            "partial_rows": units, "device_kernels": 2}


def occupancy(dtype: torch.dtype, plan: dict) -> int:
    """Blocks per SM of the rows kernel at ``plan`` on the current card (the
    CUDA runtime's occupancy calculator)."""
    _check(dtype in _DTYPE_CODE, f"dtype {dtype}")
    out = ctypes.c_int(0)
    rc = _lib()["occupancy"](_DTYPE_CODE[dtype], *(plan[k] for k in (
        "vec", "chunks", "wpr", "upb")), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"rmsnorm occupancy query failed: cudaError {rc}")
    return out.value


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                     rstd: torch.Tensor):
    """``(dx [n, d], dgamma [d])`` in x's dtype from the forward's ``rstd``."""
    _check_rows(x, gamma, dy, rstd)
    n, d = x.shape
    _check(tuple(dy.shape) == (n, d) and dy.dtype == x.dtype, "dy must match x")
    _check(tuple(rstd.shape) == (n,) and rstd.dtype == torch.float32, "rstd must be [n] fp32")
    dev = x.device
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, gamma, dy, dx))
    plan = bwd_plan(n, d, sm_count(dev), x.element_size(), aligned)
    part = torch.empty((plan["units"], plan["ldp"]), dtype=torch.float32, device=dev)
    rc = invoke(_bwd_fn, dev, _DTYPE_CODE[x.dtype], x.data_ptr(), gamma.data_ptr(),
                dy.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                part.data_ptr(), n, d, *(plan[k] for k in BWD_ARGS))
    if rc != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: cudaError {rc}")
    BWD.launches += 1
    return dx, dgamma
