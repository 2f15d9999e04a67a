#!/usr/bin/env python3
"""What limits K4's backward on the card: variants of
``src/repro_torch/kernels/csrc/flash_attn.cu`` timed in one process.

    python3 tools/flash_bwd_variants.py      # from the repository root, on a GPU

Each source variant is a copy of the source with text substitutions,
built with the same ``nvcc`` flags into ``build/variants/`` (gitignored):

- ``base``       the source as it is;
- ``nocompute``  no tile is computed in either kernel (copies, scans,
                 prologue, epilogue and combine);
- ``nocopy``     only the first tile of each ring is copied, later tiles
                 compute on what the ring holds;
- ``dq_only``    the dQ kernel alone;
- ``dkv_only``   the dK/dV kernel (and the combine) alone;
- ``round``      fp32 operands split with ``cvt.rna`` rounding (the
                 forward's split) instead of the backward's bit mask;
- ``qscan32``    the dK/dV kernel tests 32 query tiles a round trip, not 8;
- ``nopdl``      the dK/dV kernel and the combine launched after the kernel
                 before them has finished, not as dependent launches;
- ``pdl_combine`` the combine alone a dependent launch;
- ``late_trigger`` the kernels let their dependents launch only when they
                 reach their epilogue, not when they start;
- ``dq3``, ``dkv3`` the bf16 dQ (dK/dV) kernel bounded to 3 blocks an SM's
                 registers (170 a thread) instead of 2;
- ``bq16``       16-row query tiles in the dK/dV kernel (two fp32 hd 128
                 blocks an SM instead of one);
- ``w2``, ``w8``  blocks of 2 or 8 warps in both kernels (32 or 128 rows
                 and keys a block) instead of 4.

The wrapper is pointed at each library in turn, and its backward is timed
with ``chip_smoke.device_ms`` at phase 2c's grads cases, ``base`` first and
last, beside K4's forward and SDPA's forward plus backward in the same
process.  The variants other than ``base`` and ``round`` compute wrong
gradients: only their times mean anything.  Then a sweep: ``base`` with
``bwd_n_splits`` forced to 1, 2, 3, 4, 6, 8 and 12 at the same cases and at
a few more GQA shapes, which is what the wrapper's split rule is set from;
those results are right.  One JSON line per case, the card's name and
power limit first; everything also goes to
``chiprun_out/flash_bwd_variants.log``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SOURCE = os.path.join(CSRC, "flash_attn.cu")
ROUND = '''__device__ __forceinline__ void bwd_split(float x, uint32_t& big, uint32_t& small) {
  split_tf32(x, big, small);
}'''
DKV_LAUNCH = ("  e = launch_dependent(flash_bwd_dkv<T, HD>, gkv, dim3(BWD_NT), "
              "dkv_smem<T, HD>(), s, p);")
VARIANTS = {
    "base": [],
    "nocompute": [
        ("    two_products<T, HD, BK, R>(s, dp, qw, ow, ks, vs, lane);",
         "    if (true) { jt = jn; full = full_n; continue; }\n"
         "    two_products<T, HD, BK, R>(s, dp, qw, ow, ks, vs, lane);"),
        ("    two_products<T, HD, BQ, R>(sT, dpT, kw, vw, qs, os, lane);",
         "    if (true) { it = in; full = full_n; continue; }\n"
         "    two_products<T, HD, BQ, R>(sT, dpT, kw, vw, qs, os, lane);")],
    "nocopy": [("    if (jn < ntiles) load_tile(jn, st ^ 1);\n    cp_async_commit();\n"
                "    const T* ks = Ks + st * BK * R;",
                "    cp_async_commit();\n    const T* ks = Ks + st * BK * R;"),
               ("    if (in < ntq) load_qtile(in, st ^ 1);", "")],
    "dq_only": [("  const dim3 gkv(", "  return e;\n  const dim3 gkv(")],
    "dkv_only": [("  flash_bwd_dq<T, HD><<<gq, BWD_NT, dq_smem<T, HD>(), s>>>(p);", "")],
    "qscan32": [("constexpr int QSCAN = 8;", "constexpr int QSCAN = 32;")],
    "nopdl": [("programmaticStreamSerializationAllowed = 1;",
               "programmaticStreamSerializationAllowed = 0;")],
    "pdl_combine": [(DKV_LAUNCH,
                     "  flash_bwd_dkv<T, HD><<<gkv, BWD_NT, dkv_smem<T, HD>(), s>>>(p);\n"
                     "  e = cudaGetLastError();")],
    "late_trigger": [("  allow_dependents();\n  const int tid", "  const int tid", 2),
                     ("  T* dqg = static_cast<T*>(p.dq);",
                      "  allow_dependents();\n  T* dqg = static_cast<T*>(p.dq);"),
                     ("  // dK (scaled) and dV, or this split's fp32 partials",
                      "  allow_dependents();\n"
                      "  // dK (scaled) and dV, or this split's fp32 partials")],
    "dq3": [("__launch_bounds__(BWD_NT, 2) flash_bwd_dq",
             "__launch_bounds__(BWD_NT, sizeof(T) == 2 ? 3 : 2) flash_bwd_dq")],
    "dkv3": [("__launch_bounds__(BWD_NT, 2) flash_bwd_dkv",
              "__launch_bounds__(BWD_NT, sizeof(T) == 2 ? 3 : 2) flash_bwd_dkv")],
    "bq16": [("constexpr int BWD_BQ = 32;", "constexpr int BWD_BQ = 16;")],
    "w2": [("constexpr int BWD_WARPS = 4;", "constexpr int BWD_WARPS = 2;")],
    "w8": [("constexpr int BWD_WARPS = 4;", "constexpr int BWD_WARPS = 8;")],
}
CASES = ("internlm2_train", "internlm2_train_bf16", "opt125m_distill", "gqa_g8", "gqa_g8_bf16",
         "gqa_g10", "gqa_g10_bf16", "gqa_g7", "gqa_g7_bf16", "window_48")
MORE = [("gqa_g4_b4", dict(B=4, T=128, H=32, KVH=8, hd=128)),      # yi-9b-like, B 4
        ("gqa_g8_b1_t512", dict(B=1, T=512, H=32, KVH=4, hd=128)),
        ("g1_b2_t512", dict(B=2, T=512, H=16, KVH=16, hd=128)),
        ("g2_b1_t1024", dict(B=1, T=1024, H=16, KVH=8, hd=128))]
SPLITS = (1, 2, 3, 4, 6, 8, 12)


def variant_sources() -> dict:
    """name -> source text of every variant (``round`` replaces the
    backward's split helper by the forward's)."""
    text = open(SOURCE).read()
    out = {}
    for name, subs in dict(VARIANTS, round=[]).items():
        src = text
        if name == "round":
            start = src.index("__device__ __forceinline__ void bwd_split(")
            end = src.index("}\n", start) + 1
            subs = [(src[start:end], ROUND)]
        for old, new, *count in subs:
            if src.count(old) != (count[0] if count else 1):
                raise RuntimeError(f"variant {name}: the source does not have {old!r} "
                                   f"{count[0] if count else 1} time(s)")
            src = src.replace(old, new)
        out[name] = src
    return out


def build_variants(build, report) -> dict:
    """Write and compile every variant, all at once; name -> library path.
    ``report`` turns a compiler log into one line per kernel (registers,
    spills), printed for each variant's backward kernels."""
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in variant_sources().items():
        cu = os.path.join(out_dir, f"flash_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"libflash_{name}.so")
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o", lib,
                                         cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        for ln in report(log):
            if "flash_bwd" in ln:
                print(f"ptxas {name}: {ln}", flush=True)
        libs[name] = lib
    return libs


def point_wrapper_at(K4, lib: str) -> None:
    fn = ctypes.CDLL(lib).flash_attn_bwd
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i] + [p] * 13 + [i] + [i] * 6 + [ll] * 8 + [ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    K4._fns["bwd"] = fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as K4

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "flash_bwd_variants.log"), "w")
    sys.stdout = cs.Tee(sys.stdout, log)
    print(cs.smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_variants(build, cs.ptxas_report)
    build.build(["flash_attn"])
    K4._lib()
    n_splits = K4.bwd_n_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def inputs(name, kw, seed):
        c = cs.make_flash_case(torch, name, seed=seed, **kw)
        kwm = dict(window=c["window"], prefix_len=c["prefix_len"])
        out, lse = K4.flash_attn_fwd_cuda(c["q"], c["k"], c["v"], c["pos"], c["pos"],
                                          save_lse=True, **kwm)
        args = (c["q"], c["k"], c["v"], c["pos"], out, c["do"], lse)
        sets = [tuple(x.clone() for x in args) for _ in range(8)]      # out of L2
        B, T, H, _ = c["q"].shape
        KVH = c["k"].shape[2]
        return c, kwm, sets, n_splits(B, KVH, (H // KVH) * T, T, sms)

    def bwd_of(kwm):
        def bwd(q, k, v, p, o, d, l):
            return K4.flash_attn_bwd_cuda(q, k, v, o, d, l, p, p, **kwm)
        return bwd

    def sdpa_fwd_bwd(q, k, v, m, d):
        leaf = [x.detach().requires_grad_(True) for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaf, attn_mask=m,
                                           enable_gqa=q.shape[1] != k.shape[1])
        return torch.autograd.grad(o, leaf, d)

    specs = dict(cs.FLASH_CASES)
    order = ["base", *[v for v in libs if v != "base"], "base"]
    for i, name in enumerate(CASES):
        c, kwm, sets, rule = inputs(name, specs[name], i)
        row = {}
        for variant in order:
            point_wrapper_at(K4, libs[variant])
            key = variant if variant not in row else "base_again"
            row[key] = cs.device_ms(torch, bwd_of(kwm), sets, iters=40)
        point_wrapper_at(K4, libs["base"])
        fwd = cs.device_ms(torch, lambda q, k, v, p, *_: K4.flash_attn_fwd_cuda(
            q, k, v, p, p, save_lse=True, **kwm), sets, iters=40)
        lib_sets = [(s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
                     cs.visible(torch, dict(c, q_pos=s[3], k_pos=s[3]))[:, None],
                     s[5].transpose(1, 2)) for s in sets]
        sdpa = cs.device_ms(torch, sdpa_fwd_bwd, lib_sets, iters=10)   # within the sleep
        print(json.dumps({"case": name, "dtype": c["dtype"], "shape": c["shape"],
                          "bwd_ms": row, "fwd_ms": fwd, "sdpa_fwd_bwd_ms": sdpa,
                          "n_splits": rule,
                          "bwd_bound_ms": cs.flash_bound(torch, c, True)["bwd_bound_ms"]}),
              flush=True)
    for i, (name, kw) in enumerate([(n, specs[n]) for n in CASES] + [
            (n, dict(dtype=dt, **kw)) for n, kw in MORE for dt in ("float32", "bfloat16")]):
        c, kwm, sets, rule = inputs(name, kw, 100 + i)
        q_tiles = -(-c["q"].shape[1] * c["q"].shape[2] // c["k"].shape[2] // K4.BWD_Q_TILE)
        row = {}
        for n in SPLITS:
            if n <= q_tiles:
                K4.bwd_n_splits = lambda *a, n=n: n  # noqa: E731
                row[str(n)] = cs.device_ms(torch, bwd_of(kwm), sets, iters=40)
        K4.bwd_n_splits = n_splits
        B, T, H, _ = c["q"].shape
        print(json.dumps({"sweep": name, "dtype": c["dtype"], "shape": c["shape"],
                          "blocks": B * c["k"].shape[2] * -(-T // K4.BWD_ROWS),
                          "ms_by_splits": row, "rule": rule}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
