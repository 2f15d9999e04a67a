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

``ssd_chunked_bwd_cuda`` is the backward of ``ssd_chunked_cuda`` (log-decay
-dt * A only): the gradients of xh, B, C, dt, A and h0 from dy and the final
state's gradient, every product on the tensor cores (fp32 as three tf32
products), six device kernels a call, five with one chunk and no h0 (S =
c b^T once a group and the chunk-parallel states of dh, the ordered reverse
carry, the key blocks, the query blocks, the log-decay's reverse cumsum, the
ordered sums over each group's head slabs and over the batch).  It reads
each chunk's carried-in state, which the forward returns.  Its plan (the
heads a block takes) is a function of the shapes alone: :func:`ssd_bwd_plan`.  See the source for the design.
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
KERNEL_BWD = LaunchCount()   # calls of the backward (five device kernels, or six)
BWD_TILE = 64            # backward rows of a key or a query tile
BWD_THREADS = 256        # threads of the backward's reduce blocks
BWD_MIN_BLOCKS = 512     # key blocks a backward plan keeps, heads a block permitting

_fns = {}


def _lib():
    if not _fns:
        lib = build.load("ssd_chunk")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_chunk_scan.argtypes = [i] + [p] * 12 + [i] * 7 + [ll] * 12 + [i] * 2 + [p]
        lib.ssd_chunk_occupancy.argtypes = [i] * 9 + [ctypes.POINTER(i)] * 4
        lib.ssd_chunk_scan_bwd.argtypes = [i] + [p] * 26 + [i] * 9 + [ll] * 12 + [p]
        lib.ssd_chunk_bwd_occupancy.argtypes = [i] * 4 + [ctypes.POINTER(i)] * 6
        for fn in (lib.ssd_chunk_scan, lib.ssd_chunk_occupancy, lib.ssd_chunk_scan_bwd,
                   lib.ssd_chunk_bwd_occupancy):
            fn.restype = ctypes.c_int
        _fns.update(scan=lib.ssd_chunk_scan, occupancy=lib.ssd_chunk_occupancy,
                    bwd=lib.ssd_chunk_scan_bwd, bwd_occupancy=lib.ssd_chunk_bwd_occupancy)
    return _fns


def _scan_fn():
    return _lib()["scan"]


def _bwd_fn():
    return _lib()["bwd"]


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
    T/Q, H, P, N]`` (a tensor of their own, returned), each chunk's decay
    ``[B, T/Q, H]`` and each chunk's c b^T ``[B, T/Q, G, QP, QP]`` (QP = Q
    rounded up to 16); none for a single chunk."""
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


def _check_scan(xh, B_, C_, dt, A, h0, l=None):
    """The checks the scan and its backward share; returns (B, T, H, P, G, N)."""
    _check(xh.dim() == 4 and B_.dim() == 4 and C_.dim() == 4,
           "xh must be [B,T,H,P] and B/C [B,T,G,N]")
    Bsz, T, H, P = xh.shape
    G, N = B_.shape[2], B_.shape[3]
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
    return Bsz, T, H, P, G, N


def ssd_chunked_cuda(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                     dt: torch.Tensor, A: Optional[torch.Tensor], h0: Optional[torch.Tensor],
                     chunk: int, l: Optional[torch.Tensor] = None):
    """Launch the scan on the current stream: chunks of Q =
    ``ssd_chunk_len(T, chunk)`` rows, log-decay ``l`` [B,T,H] when given,
    else ``-dt * A``; h0 None is a zero state.  Returns (y [B,T,H,P] fp32,
    h_final [B,H,P,N] fp32, states): ``states`` is each chunk's carried-in
    state [B, T/Q, H, P, N] fp32 (chunk 0's is h0, or zeros), a tensor of
    its own apart from the rest of the workspace, or None with one chunk:
    what :func:`ssd_chunked_bwd_cuda` reads.  A caller that drops it frees
    it."""
    Bsz, T, H, P, G, N = _check_scan(xh, B_, C_, dt, A, h0, l)
    dev = xh.device
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
    n_state, n_dec = Bsz * (T // Q) * H * P * N, Bsz * (T // Q) * H
    states = (torch.empty((Bsz, T // Q, H, P, N), dtype=torch.float32, device=dev)
              if nws else None)
    ws = torch.empty((nws - n_state,), dtype=torch.float32, device=dev) if nws else None
    # the c b^T part starts at a 16-byte boundary
    ptrs = ((states.data_ptr(), ws.data_ptr(), ws[n_dec + (-n_dec) % 4:].data_ptr())
            if nws else (None, None, None))
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
    return y, h_out, states


def ssd_chunk_cuda(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   dt: torch.Tensor, l: torch.Tensor, h0: torch.Tensor):
    """One chunk for a batch of (batch*head) slices: x [BH,Q,P]; b/c
    [BH,Q,N]; dt/l [BH,Q] float32; h0 [BH,P,N] float32.  Returns (y
    [BH,Q,P], h_new [BH,P,N]) in fp32, as ``ssd_chunk_pallas``."""
    _check(x.dim() == 3 and b.dim() == 3 and c.dim() == 3 and dt.dim() == 2
           and l.dim() == 2 and h0.dim() == 3, "x/b/c [BH,Q,.], dt/l [BH,Q], h0 [BH,P,N]")
    Q = x.shape[1]
    _check(Q <= MAX_Q, f"Q {Q} > {MAX_Q}")
    y, h, _ = ssd_chunked_cuda(x[:, :, None], b[:, :, None], c[:, :, None], dt[:, :, None],
                               None, h0[:, None], chunk=Q, l=l[:, :, None])
    return y[:, :, 0], h[:, 0]


# ---------------------------------------------------------------------------
# the backward


def ssd_bwd_device_kernels(nchunks: int, has_h0: bool) -> int:
    """Device kernels one backward call issues: S (with several chunks or an
    h0 beside the chunk-parallel states of dh), the ordered reverse carry
    (several chunks or an h0 only), the key blocks, the query blocks, the
    log-decay's reverse cumsum and the ordered sums."""
    return 6 if nchunks > 1 or has_h0 else 5


def ssd_bwd_plan(B: int, T: int, H: int, G: int, P: int, N: int, Q: int,
                 has_h0: bool = False) -> dict:
    """The backward's plan, from the shapes alone.

    ``heads_per_block``: the heads of one group a key or query block walks
    in order, summing their db or dc in its registers (so the partials are
    ``[B, T, H / heads_per_block, N]``): the most of 4, 2 and 1 that
    divides a group's heads and still gives ``BWD_MIN_BLOCKS`` key blocks
    (about two waves of two blocks an SM), else 1.  ``tools/ssd_variants.py
    --bwd``'s sweep at three shapes (PERF.md §6): where 2 and 4 heads a
    block both keep 512 key blocks or more they tie within 1.3%, ahead of
    one head a block by 2-5%; every plan left with 256 key blocks or fewer
    lost 12-77%.  Between 256 and 512 blocks the threshold is not measured.

    Also the blocks of each kernel: a key and a query block per (batch,
    chunk, slab, 64-row tile), the S role's bands of 64 rows per (batch,
    chunk, group) beside the states of dh (per (batch, chunk, head), two
    column splits for P over 64), and the device kernels a call issues."""
    nc, nt, nq, rep = T // Q, -(-Q // BWD_TILE), -(-Q // ROW_TILE), H // G
    hb = next(h for h in (4, 2, 1)
              if rep % h == 0 and (h == 1 or B * nc * nt * (H // h) >= BWD_MIN_BLOCKS))
    states = nc > 1 or has_h0
    dspl = 1 if P <= 64 else 2
    return {"tiles": nt, "heads_per_block": hb,
            "key_blocks": B * nc * nt * (H // hb), "query_blocks": B * nc * nt * (H // hb),
            "s_blocks": B * nc * G * -(-nq // WARPS),
            "state_blocks": B * nc * H * dspl if states else 0, "finish_blocks": B * nc * H,
            "reduce_blocks": -(-B * T * G * N // BWD_THREADS) + 1,
            "device_kernels": ssd_bwd_device_kernels(nc, has_h0)}


def _bwd_parts(B: int, T: int, H: int, G: int, P: int, N: int, Q: int, has_h0: bool,
               plan: dict) -> list:
    """The backward's workspace as (name, floats) in the order the C entry
    takes them, each part rounded up to 4 floats (a 16-byte boundary); 0
    for a part the call does not use."""
    nc, nt, qp = T // Q, -(-Q // BWD_TILE), -(-Q // ROW_TILE) * ROW_TILE
    states = nc > 1 or has_h0
    rows, slab_rows = B * T * H, B * T * (H // plan["heads_per_block"])
    parts = [("dhs", B * nc * H * P * N if states else 0), ("dec", B * nc * H if states else 0),
             ("sws", B * nc * G * qp * qp),
             ("lds", B * nc * H * nt * (nt + 1) // 2 * BWD_TILE ** 2),
             ("dbp", slab_rows * N), ("dcp", slab_rows * N), ("rrow", rows), ("ddir", rows),
             ("wst", rows), ("urow", rows), ("dAt", B * nc * H * nt), ("dAp", B * nc * H)]
    return [(n, -(-f // 4) * 4) for n, f in parts]


def ssd_bwd_workspace_floats(B: int, T: int, H: int, G: int, P: int, N: int, Q: int,
                             has_h0: bool = False, plan: Optional[dict] = None) -> int:
    """fp32 workspace of a backward call at ``plan`` (default: the shapes'
    own), each part at a 16-byte boundary: with several chunks or an h0, the
    states of dh ``[B, T/Q, H, P, N]`` and each chunk's decay ``[B, T/Q,
    H]``; always S ``[B, T/Q, G, QP, QP]`` (QP = Q rounded up to 16), L o D
    o dt of each causal pair of 64-row tiles ``[B, T/Q, H, tiles (tiles +
    1) / 2, 64, 64]``, each head slab's db and dc ``[B, T, H /
    heads_per_block, N]``, four per-row values ``[B, T, H]`` (c . dc, ddt's
    direct part, the dh_out term W and the h_in term U of dcs), each key
    tile's part of dA ``[B, T/Q, H, tiles]`` and each chunk's ``[B, T/Q,
    H]``."""
    plan = plan or ssd_bwd_plan(B, T, H, G, P, N, Q, has_h0)
    return sum(f for _, f in _bwd_parts(B, T, H, G, P, N, Q, has_h0, plan))


def bwd_occupancy(dtype: torch.dtype, P: int, N: int = MAX_N, Q: int = MAX_Q) -> dict:
    """Blocks per SM of the current card for ``ssd_bwd_keys``,
    ``ssd_bwd_queries`` and ``ssd_bwd_states`` at head width P, state width
    N and chunks of Q rows, and their dynamic shared memory, as the CUDA runtime's
    occupancy calculator gives them."""
    _check(dtype in _DTYPE_CODE, f"dtype {dtype}")
    vals = [ctypes.c_int(0) for _ in range(6)]
    rc = _lib()["bwd_occupancy"](_DTYPE_CODE[dtype], P, N, Q, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk backward occupancy query failed: cudaError {rc}")
    return {"key_blocks_per_sm": vals[0].value, "query_blocks_per_sm": vals[1].value,
            "state_blocks_per_sm": vals[2].value, "key_smem_bytes": vals[3].value,
            "query_smem_bytes": vals[4].value, "state_smem_bytes": vals[5].value}


def ssd_chunked_bwd_cuda(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                         dt: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor],
                         chunk: int, dy: torch.Tensor, dh_final: Optional[torch.Tensor] = None,
                         states: Optional[torch.Tensor] = None):
    """Launch the backward of ``ssd_chunked_cuda(xh, B_, C_, dt, A, h0,
    chunk)`` on the current stream: ``dy`` [B,T,H,P] fp32 contiguous, the
    gradient of y; ``dh_final`` [B,H,P,N] fp32 contiguous, that of the final
    state, or None (zero); ``states``, each chunk's carried-in state as the
    forward returns it (None with one chunk).  Returns (dxh,
    dB, dC in xh's dtype, ddt [B,T,H] fp32, dA [H] fp32, dh0 [B,H,P,N] fp32,
    or None when h0 is None)."""
    Bsz, T, H, P, G, N = _check_scan(xh, B_, C_, dt, A, h0)
    dev = xh.device
    Q = ssd_chunk_len(T, chunk)
    _check(Q <= MAX_Q, f"chunk {chunk} gives Q {Q} > {MAX_Q}")
    nc = T // Q
    _check(dy.dtype == torch.float32 and tuple(dy.shape) == (Bsz, T, H, P)
           and dy.is_contiguous(), "dy must be [B,T,H,P] float32, contiguous")
    _check(dh_final is None or (dh_final.dtype == torch.float32 and dh_final.is_contiguous()
                                and tuple(dh_final.shape) == (Bsz, H, P, N)),
           "dh_final must be [B,H,P,N] float32, contiguous")
    if nc > 1:
        _check(states is not None and states.dtype == torch.float32 and states.is_contiguous()
               and tuple(states.shape) == (Bsz, nc, H, P, N),
               "states must be the forward's [B,T/Q,H,P,N] float32 chunk states")
    tensors = [t for t in (xh, B_, C_, dt, A, h0, dy, dh_final, states) if t is not None]
    _check(on_one_cuda_device(tensors, dev), "every tensor must lie on one CUDA device")
    _check(all(aligned16(t) and (t.shape[2] == 1 or t.stride(2) * t.element_size() % 16 == 0)
               for t in (xh, B_, C_)) and all(t.data_ptr() % 16 == 0 for t in (
                   dy, h0, dh_final, states) if t is not None),
           "xh and B/C must start and have (b, t, head) strides at multiples of 16 bytes, "
           "and dy, h0, dh_final and states start at one")
    has_h0 = h0 is not None
    plan = ssd_bwd_plan(Bsz, T, H, G, P, N, Q, has_h0)
    hin = states if nc > 1 else h0
    dxh = torch.empty((Bsz, T, H, P), dtype=xh.dtype, device=dev)
    dB = torch.empty((Bsz, T, G, N), dtype=xh.dtype, device=dev)
    dC = torch.empty((Bsz, T, G, N), dtype=xh.dtype, device=dev)
    ddt = torch.empty((Bsz, T, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev) if has_h0 else None
    sizes = _bwd_parts(Bsz, T, H, G, P, N, Q, has_h0, plan)
    ws = torch.empty((sum(f for _, f in sizes),), dtype=torch.float32, device=dev)
    parts, off = [], 0
    for _, n in sizes:
        parts.append(ws[off:].data_ptr() if n else None)
        off += n
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = invoke(_bwd_fn, dev,
                _DTYPE_CODE[xh.dtype], xh.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                dt.data_ptr(), A.data_ptr(), ptr(hin), ptr(dh_final), dy.data_ptr(),
                dxh.data_ptr(), dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                ptr(dh0), *parts, Bsz, T, H, G, P, N, Q, int(has_h0),
                plan["heads_per_block"],
                xh.stride(0), xh.stride(1), xh.stride(2),
                B_.stride(0), B_.stride(1), B_.stride(2),
                C_.stride(0), C_.stride(1), C_.stride(2),
                dt.stride(0), dt.stride(1), dt.stride(2))
    if rc != 0:
        raise RuntimeError(f"ssd_chunk backward launch failed: cudaError {rc}")
    KERNEL_BWD.launches += 1
    return dxh, dB, dC, ddt, dA, dh0
