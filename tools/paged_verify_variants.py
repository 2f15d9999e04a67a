#!/usr/bin/env python3
"""What limits the paged verify kernels K2/K3 on the card: variants of
``src/repro_torch/kernels/csrc/paged_verify_attn.cu`` timed in one process.

    python3 tools/paged_verify_variants.py          # from the repository root, on a GPU
    python3 tools/paged_verify_variants.py --mixed  # the mixed launch's shapes

Each variant is a copy of the source with one text substitution, built with
the same ``nvcc`` flags into ``build/variants/`` (gitignored):

- ``base``       the source as it is;
- ``nocompute``  no stage is computed (copies, prologue and epilogue only);
- ``nocopy``     no K/V byte is copied (compute on whatever the ring holds);
- ``ns4``        a ring of 4 stages instead of 3;
- ``kc64``       64 keys a stage instead of 32;
- ``noexit``     no early exit for a row tile of padding rows only (they
                 load Q, walk the table and scan the positions, as before
                 the mixed verify+chunk launch).

K3's wrapper is pointed at each library in turn and timed with
``chip_smoke.device_ms`` at phase 2b's verify shapes (OPT-6.7B widths,
bf16 and fp32), ``base`` first and last.  The variants compute wrong
results: only their times mean anything (``noexit`` computes right ones).
With ``--mixed``, ``base`` and ``noexit`` at phase 2b's mixed cases
(``chip_smoke.MIXED_CASES``), beside the two-launch order the mixed call
replaces (``chip_smoke.run_mixed_case``: the verify's K3 call plus the
chunk's, on ``base``).  One JSON line per case, the card's name and power
limit first; everything also goes to
``chiprun_out/paged_verify_variants.log``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", "paged_verify_attn.cu")
VARIANTS = {
    "base": [],
    "nocompute": [("for (int g0 = warp * GK; g0 < nk; g0 += NW * GK)",
                   "for (int g0 = warp * GK; g0 < (nk & 0); g0 += NW * GK)")],
    "nocopy": [("for (int e = tid; e < nkeys * NCH; e += NT)",
                "for (int e = tid; e < 0; e += NT)")],
    "ns4": [("constexpr int NS = 3;", "constexpr int NS = 4;")],
    "kc64": [("constexpr int STAGE_KEYS = 32;", "constexpr int STAGE_KEYS = 64;")],
    "noexit": [("  if (p.prefix_len == 0) {\n    bool dead = true;",
                "  if (false) {\n    bool dead = true;")],
}


def build_variants(build) -> dict:
    """Write and compile every variant, all at once; name -> library path."""
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    text = open(SOURCE).read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def point_wrapper_at(K23, lib: str) -> None:
    fn = ctypes.CDLL(lib).paged_verify_attn
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([i, i, i] + [p] * 10 + [i] * 8 + [p] + [ll] * 11
                   + [ctypes.c_float, i, i, i, p])
    fn.restype = ctypes.c_int
    K23._fn = fn


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("paged_verify_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import build, paged
    from repro_torch.kernels import paged_verify_attn as K23

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "paged_verify_variants.log"), "w")
    sys.stdout = cs.Tee(sys.stdout, log)
    print(cs.smi(), flush=True)
    libs = build_variants(build)
    if "--mixed" in sys.argv[1:]:
        return mixed(cs, np, torch, build, K23, paged, libs)
    rng = np.random.default_rng(17)
    opt = dict(H=32, KVH=32, hd=128, bs=16, MAXB=32)

    def ragged_ctx(B, T):
        return [0] + [int(x) for x in rng.integers(16, 512 - T, size=B - 1)]
    specs = [(f"opt_verify_t{T}", dict(B=16, T=T, ctx=ragged_ctx(16, T),
                                        holes=((1, 2), (5, 0)), **opt)) for T in (1, 4, 7)]
    specs += [("opt_pool_full_t1", dict(B=16, T=1, ctx=[192] * 16, **opt)),
              ("opt_pool_9_blocks_t1", dict(B=16, T=1, ctx=[140] * 16, **opt)),
              ("gqa_g7_t4", dict(B=8, T=4, H=56, KVH=8, hd=128, bs=16, MAXB=32,
                                 ctx=[300] * 8))]

    def k3(q, k, v, qp, pos, bt, cu):
        return K23.ragged_paged_verify_attn_cuda(q, k, v, qp, pos, bt, cu)
    for dtype in ("bfloat16", "float32"):
        for i, (name, kw) in enumerate(specs):
            c = cs.make_paged_case(torch, np, name, dtype=dtype, seed=100 + i, **kw)
            args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["bt"], c["cu"])
            sets = [tuple(x.clone() for x in args) for _ in range(16)]   # out of L2
            row = {}
            for variant in ["base", *[v for v in VARIANTS if v != "base"], "base"]:
                point_wrapper_at(K23, libs[variant])
                key = variant if variant not in row else "base_again"
                row[key] = cs.device_ms(torch, k3, sets, iters=40)
            print(json.dumps({"case": name, "dtype": dtype, "shape": c["shape"], "ms": row,
                              "bound_ms": cs.paged_bound(torch, paged, c)[0]}), flush=True)
    return 0


def mixed(cs, np, torch, build, K23, paged, libs) -> int:
    """``base`` and ``noexit`` at phase 2b's mixed cases, ``base`` first and
    last, beside the two-launch order (on ``base``)."""
    from repro_torch.kernels import ref

    def k3(q, k, v, qp, pos, bt, cu):
        return K23.ragged_paged_verify_attn_cuda(q, k, v, qp, pos, bt, cu)
    for dtype in ("bfloat16", "float32"):
        for i, (name, kw) in enumerate(cs.MIXED_CASES):
            kw = dict(kw)
            slot = kw.pop("mixed_slot")
            c = cs.make_paged_case(torch, np, name, dtype=dtype, seed=100 + i, **kw)
            args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["bt"], c["cu"])
            sets = [tuple(x.clone() for x in args) for _ in range(4)]   # out of L2
            row = {}
            for variant in ("base", "noexit", "base"):
                point_wrapper_at(K23, libs[variant])
                key = variant if variant not in row else "base_again"
                row[key] = cs.device_ms(torch, k3, sets, iters=40)
            point_wrapper_at(K23, libs["base"])
            r = cs.run_mixed_case(torch, K23, paged, ref, c, slot)
            print(json.dumps({"case": name, "dtype": dtype, "shape": c["shape"], "ms": row,
                              "verify_call_ms": r["verify_call_ms"],
                              "chunk_call_ms": r["chunk_call_ms"],
                              "two_launch_ms": r["two_launch_ms"], "ok": r["ok"],
                              "bound_ms": r["bound_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
