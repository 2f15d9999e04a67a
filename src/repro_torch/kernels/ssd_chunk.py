"""Mamba-2 SSD chunked scan on Hopper: the wrapper of the hand-written CUDA
kernel ``csrc/ssd_chunk.cu`` (K6).

It replaces the TPU kernel ``ssd_chunk_pallas``
(``src/repro/kernels/ssd_chunk.py``) and the chunk loop the JAX model runs
around it (``Mamba2LM._ssd_chunked``, ``src/repro/models/mamba2.py``).  Its
four products run on the tensor cores.  A scan of one chunk (every serving
prefill: Q = T when T <= 256) is one device kernel, whose output blocks and
state blocks run side by side; a scan of several chunks is three (each
chunk's state from zero, the ordered carry of the states over the chunks,
then each chunk's outputs), however many chunks.  One choice is made here,
from the shapes alone: :func:`ssd_plan`, the grid.  See the source for the
design.

``ssd_chunked_cuda`` takes the model's layout: xh ``[B,T,H,P]`` and B/C
``[B,T,G,N]`` (float32 or bfloat16, innermost dim contiguous, read in place
through strides that are multiples of 16 bytes), dt ``[B,T,H]`` float32, A
``[H]`` float32 and h0 ``[B,H,P,N]`` float32 contiguous or None (a zero
state), with P and N multiples of 8 up to 128.  ``ssd_chunk_cuda`` is the
one-chunk contract of ``repro.kernels.ops.ssd_chunk`` (``[BH, Q, ...]``, Q
at most 256, an explicit log-decay l).  Anything else raises; nothing falls
back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import aligned16, invoke, on_one_cuda_device, sm_count
from repro_torch.kernels.ref import ssd_chunk_len
from repro_torch.kernels.spec_verify_attn import LaunchCount

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_P = MAX_N = 128
MAX_Q = 256
ROW_TILE = 16       # rows of an output warp's tile, keys of its key tile
WARPS = 4           # warps a block

KERNEL = LaunchCount()   # calls of the scan (one device kernel, or three with several chunks)

_fns = {}


def _lib():
    if not _fns:
        lib = build.load("ssd_chunk")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_scan.argtypes = [i] + [p] * 12 + [i] * 7 + [ll] * 12 + [i] * 2 + [p]
        lib.ssd_chunk_occupancy.argtypes = [i] * 9 + [ctypes.POINTER(i)] * 4
        for fn in (lib.ssd_chunk_scan, lib.ssd_chunk_occupancy):
            fn.restype = ctypes.c_int
        _fns.update(scan=lib.ssd_chunk_scan, occupancy=lib.ssd_chunk_occupancy)
    return _fns


def _scan_fn():
    return _lib()["scan"]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_chunk kernel: {msg}")


def ssd_plan(B: int, T: int, H: int, G: int, P: int, N: int, Q: int, sms: int) -> dict:
    """The grid of a scan, from the shapes and the SM count alone.

    ``wr``: row tiles of 16 rows an output block takes, a warp each; the
    block's other ``4 / wr`` warps go along the heads, so it covers
    ``heads_per_block = 4 / wr`` heads of one group (which must divide
    ``H / G``), a warp per (row tile, head): 4 row tiles from 64 rows on,
    else 2.  ``nspl``: how many state blocks share one (batch, head, chunk)
    state, split over N: 2 where the states alone would not give every SM
    a block.  Also the block counts of each role and the device kernels a
    call issues.  Set from ``tools/ssd_variants.py``'s sweep of forced
    grids (PERF.md §6)."""
    nq = -(-Q // ROW_TILE)
    wr = 4 if nq >= 4 else 2
    while (H // G) % (WARPS // wr):
        wr *= 2
    nc = T // Q
    n8 = -(-N // 16) * 2
    nspl = 1 if P <= 64 else 2
    if B * nc * H * nspl < sms:
        nspl = min(n8, 2 * nspl)
    hb = WARPS // wr
    return {"wr": wr, "nspl": nspl, "heads_per_block": hb,
            "out_blocks": B * nc * -(-nq // wr) * (H // hb),
            "state_blocks": B * nc * H * nspl, "device_kernels": ssd_device_kernels(nc)}


def ssd_device_kernels(nchunks: int) -> int:
    """Device kernels one call issues: one for a single chunk (output and
    state blocks in one grid); with several, the chunk states, the ordered
    carry and the outputs."""
    return 1 if nchunks == 1 else 3


def ssd_workspace_floats(B: int, T: int, H: int, G: int, P: int, N: int, Q: int) -> int:
    """fp32 workspace of a call with several chunks: the chunk states ``[B,
    T/Q, H, P, N]``, each chunk's decay ``[B, T/Q, H]`` and each chunk's c
    b^T ``[B, T/Q, G, QP, QP]`` (QP = Q rounded up to 16); none for a single
    chunk."""
    nc, qp = T // Q, -(-Q // ROW_TILE) * ROW_TILE
    return 0 if nc == 1 else B * nc * (H * (P * N + 1) + G * qp * qp) + 3


def occupancy(dtype: torch.dtype, P: int, N: int, T: int, Q: int, H: int, G: int,
              plan: dict) -> dict:
    """Blocks per SM of the current card for the output and the state role
    of a scan at ``plan`` with a zero state, in the kernels that run them
    (one kernel for one chunk, else the outputs and the states kernel),
    and each role's dynamic shared memory, as the CUDA runtime's occupancy
    calculator gives them."""
    _check(dtype in _DTYPE_CODE, f"dtype {dtype}")
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = _lib()["occupancy"](_DTYPE_CODE[dtype], P, N, T, Q, H, G, plan["wr"], plan["nspl"],
                             *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk occupancy query failed: cudaError {rc}")
    return {"out_blocks_per_sm": vals[0].value, "state_blocks_per_sm": vals[1].value,
            "out_smem_bytes": vals[2].value, "state_smem_bytes": vals[3].value}


def ssd_chunked_cuda(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                     dt: torch.Tensor, A: Optional[torch.Tensor], h0: Optional[torch.Tensor],
                     chunk: int, l: Optional[torch.Tensor] = None):
    """Launch the scan on the current stream: chunks of Q =
    ``ssd_chunk_len(T, chunk)`` rows, log-decay ``l`` [B,T,H] when given,
    else ``-dt * A``; h0 None is a zero state.  Returns (y [B,T,H,P] fp32,
    h_final [B,H,P,N] fp32)."""
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
    _check(0 < P <= MAX_P and 0 < N <= MAX_N and P % 8 == 0 and N % 8 == 0,
           f"P {P}, N {N} (multiples of 8 up to {MAX_P})")
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
    _check(h0 is None or (h0.dtype == torch.float32 and tuple(h0.shape) == (Bsz, H, P, N)
                          and h0.is_contiguous()), "h0 must be [B,H,P,N] float32, contiguous")
    tensors = [t for t in (xh, B_, C_, dt, h0, A, l) if t is not None]
    _check(on_one_cuda_device(tensors, dev), "every tensor must lie on one CUDA device")
    _check(all(aligned16(t) and (t.shape[2] == 1 or t.stride(2) * t.element_size() % 16 == 0)
               for t in (xh, B_, C_)) and (h0 is None or h0.data_ptr() % 16 == 0),
           "xh and B/C must start and have (b, t, head) strides at multiples of 16 bytes, "
           "and h0 start at one")
    Q = ssd_chunk_len(T, chunk)
    _check(Q <= MAX_Q, f"chunk {chunk} gives Q {Q} > {MAX_Q}")
    plan = ssd_plan(Bsz, T, H, G, P, N, Q, sm_count(dev))
    y = torch.empty((Bsz, T, H, P), dtype=torch.float32, device=dev)
    h_out = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    nws = ssd_workspace_floats(Bsz, T, H, G, P, N, Q)
    ws = torch.empty((nws,), dtype=torch.float32, device=dev) if nws else None
    n_state, n_dec = Bsz * (T // Q) * H * P * N, Bsz * (T // Q) * H
    # the c b^T part starts at a 16-byte boundary (n_state is a multiple of 64)
    ptrs = ((ws.data_ptr(), ws[n_state:].data_ptr(), ws[n_state + n_dec + (-n_dec) % 4:]
             .data_ptr()) if nws else (None, None, None))
    rc = invoke(_scan_fn, dev,
                _DTYPE_CODE[xh.dtype], xh.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                dt.data_ptr(), l.data_ptr() if l is not None else None,
                A.data_ptr() if l is None else None,
                h0.data_ptr() if h0 is not None else None, y.data_ptr(), h_out.data_ptr(),
                *ptrs, Bsz, T, H, G, P, N, Q,
                xh.stride(0), xh.stride(1), xh.stride(2),
                B_.stride(0), B_.stride(1), B_.stride(2),
                C_.stride(0), C_.stride(1), C_.stride(2),
                dt.stride(0), dt.stride(1), dt.stride(2),
                plan["wr"], plan["nspl"])
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
