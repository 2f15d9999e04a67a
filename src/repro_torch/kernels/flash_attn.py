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

The backward is a dQ kernel and a dK/dV kernel on the tensor cores.  One
choice is made here, from the shapes alone: :func:`bwd_n_splits`, how many
blocks share the folded query rows of one ``(b, kv-head, key tile)`` of the
dK/dV kernel.  With more than one split a call issues a third device
kernel, which sums the splits' fp32 partials from a workspace that the
wrapper allocates, in split order; a launch count still counts calls.

The kernels take q ``[B,T,H,hd]`` and k/v ``[B,L,KVH,hd]`` of one dtype,
float32 or bfloat16, read in place through their (b, t) strides with heads
and hd contiguous; int32 ``q_pos [B,T]`` / ``k_pos [B,L]``; hd in {64, 128}.
Both directions copy q, k and v rows 16 bytes at a time (and the backward
o and do), so their addresses and (b, t) strides must be multiples of 16
bytes.  Anything else raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import aligned16, invoke, on_one_cuda_device, sm_count
from repro_torch.kernels.spec_verify_attn import LaunchCount

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
BWD_ROWS = 64      # backward: folded query rows of a dQ block, keys of a dK/dV block
BWD_Q_TILE = 32    # dK/dV kernel: folded query rows per tile of its ring

FWD = LaunchCount()   # launches of the forward kernel
BWD = LaunchCount()   # calls of the backward (dQ, dK/dV, and the combine when split)

_fns = {}


def _lib():
    if not _fns:
        lib = build.load("flash_attn")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = [i] * 6 + [ll] * 8 + [ctypes.c_float, i, i, i, p]
        lib.flash_attn_fwd.argtypes = [i] + [p] * 7 + tail
        lib.flash_attn_bwd.argtypes = [i] + [p] * 13 + [i] + tail
        lib.flash_attn_fwd_occupancy.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.flash_attn_bwd_occupancy.argtypes = [i, i, i, ctypes.POINTER(i),
                                                 ctypes.POINTER(i)]
        for fn in (lib.flash_attn_fwd, lib.flash_attn_bwd, lib.flash_attn_fwd_occupancy,
                   lib.flash_attn_bwd_occupancy):
            fn.restype = ctypes.c_int
        _fns.update(fwd=lib.flash_attn_fwd, bwd=lib.flash_attn_bwd,
                    occupancy=lib.flash_attn_fwd_occupancy,
                    bwd_occupancy=lib.flash_attn_bwd_occupancy)
    return _fns


def _fwd_fn():
    return _lib()["fwd"]


def _bwd_fn():
    return _lib()["bwd"]


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
    _check(on_one_cuda_device((q, k, v, q_pos, k_pos, *extra), q.device),
           "every tensor must lie on one CUDA device")


def _geometry(q, k, v, q_pos, k_pos, scale, window, prefix_len):
    """The arguments both entry points share, after the pointers."""
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    return (B, T, H, KVH, L, hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), q_pos.stride(0), k_pos.stride(0), float(scale),
            int(window is not None), int(window or 0), int(prefix_len))


def _check_aligned(**tensors):
    for name, t in tensors.items():
        _check(aligned16(t),
               f"{name} must start and have (b, t) strides at multiples of 16 bytes")


def bwd_n_splits(B: int, KVH: int, rows: int, L: int, sms: int) -> int:
    """How many blocks of the dK/dV kernel share the ``rows = G * T`` folded
    query rows of one ``(b, kv-head, key tile of BWD_ROWS keys)``: 1 when
    those blocks fill at least half of the ``sms`` SMs, else about one
    block an SM (``sms / blocks``, rounded), at most one split per two
    query tiles.  A function of the shapes and the SM count only.

    Set from ``tools/flash_bwd_variants.py``'s sweep of forced split counts
    on the card: the trainer's 128 blocks ran fastest unsplit (a split
    costs a count of the visible tiles, a K/V prologue and the combine's
    pass over fp32 partials); at 16, 32, 48 and 64 blocks (GQA, B 1-4) the
    fastest fp32 counts were 8, 4, 3 and 2, which this rounding gives."""
    blocks = B * KVH * -(-L // BWD_ROWS)
    if 2 * blocks >= sms:
        return 1
    q_tiles = -(-rows // BWD_Q_TILE)
    return max(1, min(q_tiles // 2, (sms + blocks // 2) // blocks))


def bwd_workspace_floats(B: int, KVH: int, L: int, hd: int, splits: int) -> int:
    """fp32 workspace of a backward call: the dK partials, then the dV
    partials, ``[splits, B, L, KVH, hd]`` each; none when not split."""
    return 0 if splits == 1 else 2 * splits * B * L * KVH * hd


def bwd_device_kernels(splits: int) -> int:
    """Device kernels one backward call issues: dQ, dK/dV, and the combine
    when the query rows are split."""
    return 2 if splits == 1 else 3


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


def bwd_occupancy(dtype: torch.dtype, hd: int) -> dict:
    """The backward kernels' blocks per SM of the current card and dynamic
    shared memory per block at (dtype, hd): ``{"dq": ..., "dkv": ...}``, as
    :func:`fwd_occupancy` gives them for the forward."""
    _check(dtype in _DTYPE_CODE and hd in _HEAD_DIMS, f"no backward for {dtype}, hd {hd}")
    out = {}
    for which, name in enumerate(("dq", "dkv")):
        n, smem = ctypes.c_int(0), ctypes.c_int(0)
        rc = _lib()["bwd_occupancy"](_DTYPE_CODE[dtype], hd, which, ctypes.byref(n),
                                     ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"flash_attn backward occupancy query failed: cudaError {rc}")
        out[name] = {"blocks_per_sm": n.value, "smem_bytes": smem.value}
    return out


def flash_attn_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int] = None, prefix_len: int = 0,
                        scale: Optional[float] = None, save_lse: bool = False):
    """Launch the forward on the current stream.  Returns ``(out [B,T,H,hd]``
    in q's dtype, ``lse [B,H,T]`` fp32 when ``save_lse`` else None)."""
    _check_inputs(q, k, v, q_pos, k_pos, window, prefix_len)
    _check_aligned(q=q, k=k, v=v)
    B, T, H, hd = q.shape
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if save_lse else None)
    rc = invoke(_fwd_fn, q.device, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
                lse.data_ptr() if save_lse else None,
                *_geometry(q, k, v, q_pos, k_pos, scale, window, prefix_len))
    if rc != 0:
        raise RuntimeError(f"flash_attn forward launch failed: cudaError {rc}")
    FWD.launches += 1
    return out, lse


def flash_attn_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int] = None, prefix_len: int = 0,
                        scale: Optional[float] = None):
    """Launch the backward (two kernels, three when split) on the current
    stream.  ``o`` is the forward's output and ``lse`` its logsumexp; ``do``
    is taken contiguous.  Returns ``(dq, dk, dv)`` in q's dtype."""
    _check_inputs(q, k, v, q_pos, k_pos, window, prefix_len, (o, do, lse))
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    do = do.contiguous()
    _check(o.is_contiguous() and tuple(o.shape) == (B, T, H, hd) and o.dtype == q.dtype,
           "o must be the contiguous forward output")
    _check(tuple(do.shape) == (B, T, H, hd) and do.dtype == q.dtype, "do must match o")
    _check(lse.is_contiguous() and tuple(lse.shape) == (B, H, T)
           and lse.dtype == torch.float32, "lse must be [B,H,T] fp32")
    _check_aligned(q=q, k=k, v=v, o=o, do=do)
    dev = q.device
    splits = bwd_n_splits(B, KVH, (H // KVH) * T, L, sm_count(dev))
    dq = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((B, L, KVH, hd), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    dsum = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    ws = (torch.empty(bwd_workspace_floats(B, KVH, L, hd, splits), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    rc = invoke(_bwd_fn, dev, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), do.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), ws.data_ptr() if ws is not None else None, splits,
                *_geometry(q, k, v, q_pos, k_pos, scale, window, prefix_len))
    if rc != 0:
        raise RuntimeError(f"flash_attn backward launch failed: cudaError {rc}")
    BWD.launches += 1
    return dq, dk, dv
