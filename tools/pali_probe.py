#!/usr/bin/env python3
"""paligemma-3b's kernels and phase 12 on the card, without the rest of
``chip_smoke.py``.

    python3 tools/pali_probe.py            # from the repository root, on a GPU

Builds every kernel, prints the ptxas report of the head-dim-256 instances
and their occupancy (K1, K2/K3, K4's forward), runs the ``pali_*`` rows of phases 2, 2b and 2c
(``run_kernel_case``, ``run_paged_case``, ``run_flash_case``), K1's split
sweep at head dim 256 (``tools/verify_attn_variants.py --pali``), K3's
forced split counts at paligemma's paged verify (B 8-16, T 1 and 4, bf16
and fp32), then phases 12a and 12b.  One JSON line per row; everything also
goes to ``chiprun_out/pali_probe.log``.  Exits 1 if a phase fails.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pali_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tools import verify_attn_variants
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log_path = os.path.join(ROOT, "chiprun_out", "pali_probe.log")
    sys.stdout = cs.Tee(sys.__stdout__, open(log_path, "w"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cs.assemble()
    K1, K23, K4 = m.K1, m.K23, m.K4
    print(cs.smi(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    libs = m.build.build(["spec_verify_attn", "paged_verify_attn", "flash_attn", "rmsnorm",
                          "ssd_chunk"])
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for name in ("spec_verify_attn", "paged_verify_attn", "flash_attn"):
        for ln in cs.ptxas_report(libs[name].with_suffix(".log").read_text()):
            if "256" in ln.split(":")[0]:
                print(f"  ptxas: {name}: {ln}", flush=True)
    occ = {}
    for dt in ("float32", "bfloat16"):
        for q8 in (False, True):
            kv = torch.int8 if q8 else getattr(torch, dt)
            tag = f"{dt}{'_int8' if q8 else ''}"
            for rt in K1.ROW_TILES:
                occ[f"k1_{tag}_rt{rt}"] = K1.occupancy(getattr(torch, dt), kv, 256, rt, 512)
            occ[f"k23_{tag}"] = K23.occupancy(getattr(torch, dt), kv, 256, 16, 32)
        occ[f"k4_{dt}"] = K4.fwd_occupancy(getattr(torch, dt), 256)
    print("  occupancy hd256: " + json.dumps(occ), flush=True)
    failed = []

    def attempt(name, fn):
        t = time.perf_counter()
        try:
            fn()
            ok = True
        except Exception:
            failed.append(name)
            traceback.print_exc()
            ok = False
        print(json.dumps({"phase": name, "ok": ok, "s": time.perf_counter() - t}), flush=True)

    def show(r):
        print("  " + json.dumps(r), flush=True)
        return r["ok"]

    def k1_rows():
        oks = [show(cs.run_kernel_case(torch, K1, m.ref, cs.make_case(
            torch, f"{name}_{'f32' if dt == 'float32' else 'bf16'}", dtype=dt, seed=i, **kw)))
            for i, (name, kw) in enumerate(cs.k1_specs()) if "pali" in name
            for dt in ("float32", "bfloat16")]
        assert all(oks)

    def paged_rows():
        kw = dict(B=16, T=4, bs=16, MAXB=32, ctx=[272 + 8 * b for b in range(16)],
                  holes=((3, 17),), prefix_len=256, **cs.PALI_HEADS)
        assert all(show(cs.run_paged_case(torch, K23, m.paged, m.ref, cs.make_paged_case(
            torch, np, f"pali_b16_t4_bs16_prefix256_{dt}", dtype=dt, seed=7, **kw)))
            for dt in ("float32", "bfloat16"))

    def flash_rows():
        assert all(show(cs.run_flash_case(torch, K4, m.ref, cs.make_flash_case(
            torch, "flash_" + name, seed=200 + i, **kw)))
            for i, (name, kw) in enumerate(cs.FLASH_CASES) if "pali" in name)

    def k3_sweep():
        rule = K23.n_splits

        def ragged(q, k, v, qp, pos, bt, cu):
            return K23.ragged_paged_verify_attn_cuda(q, k, v, qp, pos, bt, cu, prefix_len=256)
        try:
            for B, T in ((16, 4), (16, 1), (8, 4)):
                kw = dict(B=B, T=T, bs=16, MAXB=32, ctx=[272 + 8 * b for b in range(B)],
                          prefix_len=256, **cs.PALI_HEADS)
                for dt in ("bfloat16", "float32"):
                    c = cs.make_paged_case(torch, np, f"pali_b{B}_t{T}", dtype=dt, seed=7, **kw)
                    args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["bt"], c["cu"])
                    sets = [tuple(x.clone() for x in args) for _ in range(8)]
                    want = ragged(*args)
                    row = {}
                    for n in (1, 2, 3, 4, 5, 6, 8, 12, 16):
                        K23.n_splits = lambda *a, n=n: n  # noqa: E731
                        err = float((ragged(*args).float() - want.float()).abs().max())
                        row[str(n)] = (cs.device_ms(torch, ragged, sets, iters=40), err)
                    K23.n_splits = rule
                    print(json.dumps({"k3_sweep": f"pali_b{B}_t{T}", "dtype": dt,
                                      "shape": c["shape"], "ms_err_by_splits": row,
                                      "rule": rule(B, 1, 8 * T, 32, 16, 132, 256)}), flush=True)
        finally:
            K23.n_splits = rule

    def tree_to(tree, device):
        return cs.tree_map(lambda t: t.to(device), tree)

    attempt("k1_pali", k1_rows)
    attempt("paged_pali", paged_rows)
    attempt("flash_pali", flash_rows)
    attempt("k1_split_sweep", lambda: verify_attn_variants.main(["--pali"]))
    sys.stdout = cs.Tee(sys.__stdout__, open(log_path, "a"))
    attempt("k3_split_sweep", k3_sweep)
    attempt("pali_parity", lambda: cs.phase_pali_parity(torch, np, m.R, m, tree_to))
    torch.cuda.empty_cache()
    attempt("pali_serve", lambda: cs.phase_pali_serve(torch, np, m.R, m))
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
