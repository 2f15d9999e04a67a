#!/usr/bin/env python3
"""What limits the verify-attention kernel K1 on the card: variants of
``src/repro_torch/kernels/csrc/spec_verify_attn.cu`` timed in one process.

    python3 tools/verify_attn_variants.py      # from the repository root, on a GPU

Each source variant is a copy of the source with one text substitution,
built with the same ``nvcc`` flags into ``build/variants/`` (gitignored):

- ``base``       the source as it is;
- ``nocompute``  no tile is computed (copies, prologue, epilogue and combine);
- ``nocombine``  the split kernel alone, without the combine;
- ``stg3``       a ring of 3 stages for the four-warp blocks too.

Beside them ``nosplit`` runs ``base`` with the wrapper's ``n_splits``
forced to 1.  K1's wrapper is pointed at each library in turn and timed
with ``chip_smoke.device_ms`` at phase 2's serving shapes in bf16, ``base``
first and last, with SDPA's time (mask made outside the timed call) in the
same process.  The variants compute wrong results: only their times mean
anything.  Then a sweep: ``base`` with ``n_splits`` forced to 1, 2, 3, 4,
6, 8, 12 and 16 at the serving shapes and at longer caches (1024-4096
rows), bf16, which is what the wrapper's split rule is set from; those
results are right.  One JSON line per case, the card's name and power
limit first; everything also goes to ``chiprun_out/verify_attn_variants.log``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SOURCE = os.path.join(CSRC, "spec_verify_attn.cu")
VARIANTS = {
    "base": [],
    "nocompute": [("if (!active) continue;", "if (true) continue;")],
    "nocombine": [("if (e != cudaSuccess || p.n_splits == 1) return e;", "return e;")],
    "stg3": [("static constexpr int NSTG = NW == 1 ? 3 : 2;",
              "static constexpr int NSTG = 3;")],
}
CASES = ("cont_target_prefill_t64", "cont_target_prefill_t128", "cont_target_prefill_t256",
         "cont_draft_prefill_t256", "target_prefill_b8", "target_verify_s3_b8",
         "cont_draft_decode_t1_b16", "gqa_g4", "gqa_g7_prefill_t100")
OPT = dict(H=32, KVH=32, hd=128)        # opt-6.7b attention
SWEEP = CASES + ("target_verify_s0_b8", "b1_decode_l512", "draft_decode_t1_b8",
                 "draft_decode_t2_b8", "window_64_wrapped", "masked_rows",
                 "mamba_draft_decode_t1_b8", "mamba_draft_decode_t4_b8")
DRAFT = dict(H=12, KVH=12, hd=64)       # opt-125m attention
MAMBA_DRAFT = dict(H=8, KVH=8, hd=64, window=4096)   # mamba2-1.3b's dense_draft
LONG = [("draft_decode_t1_b8_full", dict(B=8, T=1, L=256, n_ctx=250, **DRAFT)),
        ("target_verify_t1_b4_full", dict(B=4, T=1, L=256, n_ctx=250, **OPT)),
        ("mamba_draft_decode_t1_b8_full", dict(B=8, T=1, L=512, n_ctx=500, **MAMBA_DRAFT)),
        ("mamba_draft_decode_t1_b3_l544", dict(B=3, T=1, L=544, n_ctx=300, **MAMBA_DRAFT))
        ] + [(f"b1_decode_l{L}", dict(B=1, T=1, L=L, n_ctx=L - 8, **OPT)) for L in (1024, 4096)] + [
    (f"b8_verify_t4_l{L}", dict(B=8, T=4, L=L, n_ctx=L - 8, **OPT)) for L in (1024, 4096)] + [
    (f"b1_prefill_t256_l{L}", dict(B=1, T=256, L=L, n_ctx=L - 256, **OPT)) for L in (1024, 4096)]
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


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
        cu = os.path.join(out_dir, f"verify_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"libverify_{name}.so")
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o", lib,
                                         cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def point_wrapper_at(K1, lib: str) -> None:
    fn = ctypes.CDLL(lib).spec_verify_attn
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i, i] + [p] * 8 + [i] * 8 + [p] + [ll] * 10 + [ctypes.c_float, i, i, i, p]
    fn.restype = ctypes.c_int
    K1._fns["launch"] = fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("verify_attn_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import spec_verify_attn as K1

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "verify_attn_variants.log"), "w")
    sys.stdout = cs.Tee(sys.stdout, log)
    print(cs.smi(), flush=True)
    libs = build_variants(build)
    n_splits = K1.n_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def splits_of(c):
        B, T, H, _ = c["q"].shape
        return n_splits(B, c["k"].shape[2], (H // c["k"].shape[2]) * T, c["k"].shape[1], sms)

    def k1_of(c):   # K1 with the case's window and prefix
        def k1(q, k, v, qp, kp):
            return K1.spec_verify_attn_cuda(q, k, v, qp, kp, window=c["window"],
                                            prefix_len=c["prefix_len"])
        return k1

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=mask,
                                              enable_gqa=q.shape[2] != k.shape[2])

    def inputs(name, kw, seed):
        c = cs.make_case(torch, name, dtype="bfloat16", seed=seed, **kw)
        args = (c["q"], c["k"], c["v"], c["q_pos"], c["k_pos"])
        return c, [tuple(x.clone() for x in args) for _ in range(16)]   # out of L2
    specs = dict(cs.k1_specs())
    for i, name in enumerate(CASES):
        c, sets = inputs(name, specs[name], i)
        row = {}
        for variant in ["base", *[v for v in VARIANTS if v != "base"], "nosplit", "base"]:
            point_wrapper_at(K1, libs["base" if variant == "nosplit" else variant])
            K1.n_splits = (lambda *a: 1) if variant == "nosplit" else n_splits
            key = variant if variant not in row else "base_again"
            row[key] = cs.device_ms(torch, k1_of(c), sets, iters=40)
        K1.n_splits = n_splits
        row["sdpa"] = cs.device_ms(torch, sdpa, [
            (*st[:3], cs.visible(torch, dict(q_pos=st[3], k_pos=st[4], window=None,
                                             prefix_len=0))[:, None]) for st in sets], iters=40)
        print(json.dumps({"case": name, "dtype": "bfloat16", "shape": c["shape"], "ms": row,
                          "n_splits": splits_of(c), "bound_ms": cs.bound(torch, c)["bound_ms"]}),
              flush=True)
    point_wrapper_at(K1, libs["base"])
    for i, (name, kw) in enumerate([(n, specs[n]) for n in SWEEP] + LONG):
        c, sets = inputs(name, kw, 100 + i)
        ntiles = -(-c["k"].shape[1] // K1.KEY_TILE)
        row = {}
        for n in SPLITS:
            if n <= ntiles:
                K1.n_splits = lambda *a, n=n: n  # noqa: E731
                row[str(n)] = cs.device_ms(torch, k1_of(c), sets, iters=40)
        K1.n_splits = n_splits
        print(json.dumps({"sweep": name, "dtype": "bfloat16", "shape": c["shape"],
                          "ms_by_splits": row, "rule": splits_of(c),
                          "bound_ms": cs.bound(torch, c)["bound_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
