#!/usr/bin/env python3
"""What limits K6 (the Mamba-2 SSD scan) on the card: variants of
``src/repro_torch/kernels/csrc/ssd_chunk.cu`` and forced grids, timed in one
process.

    python3 tools/ssd_variants.py [--serve]   # from the repository root, on a GPU

``--serve``: the serving prefills only, and no sweep.

Each source variant is a copy of the source with text substitutions, built
with the same ``nvcc`` flags into ``build/variants/`` (gitignored):

- ``base``        the source as it is;
- ``noproducts``  every ``mma.sync`` replaced by one add (copies, prefix
                  sums, decays, operand splits and stores stay);
- ``nocopy``      only the first stage of each ring is copied, later tiles
                  compute on what the ring holds;
- ``nostates``    the state blocks return at once (one chunk: the output
                  blocks alone; several: no chunk state);
- ``nocarry``     no ordered pass over the chunks (several chunks only);
- ``nooff``       no carried-in state's term in the output blocks;
- ``rounded``     bf16: the fp32 intermediates rounded once to bf16, not
                  split into hi + lo (one product where the kernel runs two);
- ``noscores``    the output blocks compute no c b^T tile (a constant);
- ``noexp``       no decay exponentials in the output blocks;
- ``nomx``        no product of the decayed scores with x;
- ``stages4``, ``stages2``  the output blocks' ring one stage deeper (4 in
                  bf16, 3 in fp32), or 2 stages in both;
- ``divcopy``     every tile copy indexed by a division per 16-byte chunk
                  (the general path) instead of per-thread pointer steps.

The wrapper is pointed at each library in turn and timed with
``chip_smoke.device_ms`` at phase 2d's cases, ``base`` first and last,
and ``base``'s device time is split by kernel (``torch.profiler``).
The variants other than ``base`` and ``rounded`` compute wrong results:
only their times mean anything.  Then a sweep: ``base`` with ``ssd_plan``
forced to every legal (``wr``, ``nspl``) at the serving prefills
and the T 2048 prefill, which is what the wrapper's rule is set from; those
results are right.  One JSON line per case, the card's name and power limit
first; everything also goes to ``chiprun_out/ssd_variants.log``.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
SOURCE = os.path.join(CSRC, "ssd_chunk.cu")
MMA_BF16 = ('  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "\n'
            '      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n'
            '      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])\n'
            '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));')
MMA_TF32 = MMA_BF16.replace("m16n8k16", "m16n8k8").replace("bf16.bf16", "tf32.tf32")
NO_MMA = "  c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);"
# (file, old, new): file "cu" is the source, "cuh" the tile header copied beside it
VARIANTS = {
    "base": [],
    "noproducts": [("cuh", MMA_BF16, NO_MMA), ("cuh", MMA_TF32, NO_MMA)],
    "nocopy": [("cu", "    if (sg + OSTAGES - 1 < nst) load_stage(sg + OSTAGES - 1);\n", ""),
               ("cu", "      load_stage(ks + 1, st ^ 1);\n", "")],
    "nostates": [("cu", "  constexpr int SN8 = 16 / SMT;    // n8 tiles of N a warp, at most\n",
                  "  constexpr int SN8 = 16 / SMT;    // n8 tiles of N a warp, at most\n"
                  "  if (p.nc > 0) return;\n")],
    "nocarry": [("cu", "  ssd_carry<<<", "  if (false) ssd_carry<<<")],
    "nooff": [("cu", "  if (hbase != nullptr) {", "  if (false) {")],
    "rounded": [("cu", "constexpr bool kSplitBf16 = true;", "constexpr bool kSplitBf16 = false;")],
    "noscores": [("cu", "        scores<T>(s, Cs + wrow * TR * RC, Bs + st * SE, RC, p.np, lane);",
                  "        for (int q = 0; q < 16; ++q) (&s[0][0][0])[q] = 0.5f;")],
    "noexp": [("cu", "s[u][n][e] * ex2(c2[i] - c2[jj]) * d[jj]", "s[u][n][e] * d[jj]")],
    "divcopy": [("cu", "  if (NT % cpr == 0) {\n    const int rpp", "  if (false) {\n    const int rpp")],
    "stages4": [("cu", "return sizeof(T) == 2 ? 3 : 2; }", "return sizeof(T) == 2 ? 4 : 3; }")],
    "stages2": [("cu", "return sizeof(T) == 2 ? 3 : 2; }", "return 2; }")],
    "nomx": [("cu", "        mx_product<T, PMAX>(acc, m, Xs + ((st * hb + wh) * KT + u * TR) * RX, RX, "
                     "p.pp, lane);",
              "        acc[0][0] += m[0][0] + m[1][3];")],
}
SERVE = ["serve_b8_t16", "serve_b1_t64", "serve_b1_t128", "serve_b1_t256", "serve_b1_t256_g8"]
LONG = ["prefill_b4_t2048_ragged", "t300_q150", "t257_q1"]


def variant_dirs() -> dict:
    """name -> directory holding its ssd_chunk.cu and attn_tile.cuh."""
    src = open(SOURCE).read()
    hdr = open(os.path.join(CSRC, "attn_tile.cuh")).read()
    out = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(ROOT, "build", "variants", "ssd_" + name)
        os.makedirs(d, exist_ok=True)
        texts = {"cu": src, "cuh": hdr}
        for which, old, new in subs:
            if old not in texts[which]:
                raise RuntimeError(f"variant {name}: substitution target not found: {old!r}")
            texts[which] = texts[which].replace(old, new)
        open(os.path.join(d, "ssd_chunk.cu"), "w").write(texts["cu"])
        open(os.path.join(d, "attn_tile.cuh"), "w").write(texts["cuh"])
        out[name] = d
    return out


def build_variants(build, report) -> dict:
    """Compile every variant at once; name -> library path."""
    dirs = variant_dirs()
    procs = {}
    for name, d in dirs.items():
        lib = os.path.join(d, "libssd_chunk.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, "ssd_chunk.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{text[-4000:]}")
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln
                         and not ln.strip().startswith("0 bytes spill")})
        regs = sorted({int(ln.split("Used ")[1].split(" registers")[0])
                       for ln in text.splitlines() if "Used " in ln and " registers" in ln})
        report({"variant": name, "registers": regs, "spills": spills or "none"})
        libs[name] = lib
    return libs


def point_wrapper_at(K6, lib: str) -> None:
    fn = ctypes.CDLL(lib).ssd_chunk_scan
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i] + [p] * 12 + [i] * 7 + [ll] * 12 + [i] * 2 + [p]
    fn.restype = ctypes.c_int
    K6._lib()
    K6._fns["scan"] = fn


def legal_plans(K6, B, T, H, G, P, N, Q):
    nc, nq = T // Q, -(-Q // 16)
    n8 = -(-N // 16) * 2
    for wr in (1, 2, 4):
        hb = 4 // wr
        if (H // G) % hb:
            continue
        for nspl in (1, 2, 4):
            if nspl > n8 or -(-n8 // nspl) > (16 if P <= 64 else 8):
                continue
            yield {"wr": wr, "nspl": nspl, "heads_per_block": hb,
                   "out_blocks": B * nc * -(-nq // wr) * (H // hb),
                   "state_blocks": B * nc * H * nspl,
                   "device_kernels": K6.ssd_device_kernels(nc)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_chunk as K6
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "ssd_variants.log"), "w")

    def report(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()
    report({"nvidia_smi": cs.smi(), "kind": torch.cuda.get_device_name(0)})
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(build, report)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = dict(cs.SSD_CASES)
    seeds = {name: 400 + i for i, (name, _) in enumerate(cs.SSD_CASES)}

    def case(name, dtype):
        return cs.make_ssd_case(torch, name, dtype=dtype, seed=seeds[name], **cases[name])

    def timed(c):
        args = (c["xh"], c["B"], c["C"], c["dt"], c["A"], c["h0"])
        sets = [tuple(None if t is None else t.clone() for t in args) for _ in range(4)]
        return cs.device_ms(torch, lambda *a: K6.ssd_chunked_cuda(*a, c["chunk"]), sets)

    def by_kernel(c, calls=5):
        """Device ms per call of each kernel the scan issues."""
        from torch.profiler import ProfilerActivity, profile
        args = (c["xh"], c["B"], c["C"], c["dt"], c["A"], c["h0"])
        K6.ssd_chunked_cuda(*args, c["chunk"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                K6.ssd_chunked_cuda(*args, c["chunk"])
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            m = re.search(r"[A-Za-z_]\w*(?=[<(])", e.key)
            if t and m and m.group(0).startswith("ssd_"):
                out[m.group(0)] = out.get(m.group(0), 0.0) + t / 1e3 / calls
        return out

    # source variants
    serve_only = "--serve" in sys.argv[1:]
    order = ["base"] + [n for n in VARIANTS if n != "base"] + ["base"]
    for name in SERVE + ([] if serve_only else LONG):
        for dtype in ("float32", "bfloat16"):
            c = case(name, dtype)
            row = {"case": name, "dtype": dtype, "shape": c["shape"]}
            for v in order:
                if v == "nocarry" and c["xh"].shape[1] <= 256:
                    continue
                if v == "rounded" and dtype == "float32":
                    continue
                point_wrapper_at(K6, libs[v])
                row[v if v not in row else v + "_again"] = timed(c)
            row["bound_ms"] = cs.ssd_bound(torch, ref, c)["bound_ms"]
            point_wrapper_at(K6, libs["base"])
            row["base_by_kernel"] = by_kernel(c)
            report(row)
            del c
    # forced grids
    if serve_only:
        return 0
    point_wrapper_at(K6, libs["base"])
    rule = K6.ssd_plan
    for name in SERVE + ["prefill_b4_t2048_ragged"]:
        for dtype in ("bfloat16", "float32"):
            c = case(name, dtype)
            B, T, H, P = c["xh"].shape
            G, N = c["B"].shape[2], c["B"].shape[3]
            Q = ref.ssd_chunk_len(T, c["chunk"])
            chosen = rule(B, T, H, G, P, N, Q, sms)
            times = {}
            for plan in legal_plans(K6, B, T, H, G, P, N, Q):
                K6.ssd_plan = lambda *a, plan=plan: plan  # noqa: E731
                key = f"wr{plan['wr']}_nspl{plan['nspl']}"
                times[key] = timed(c)
            K6.ssd_plan = rule
            best = min(times, key=times.get)
            report({"sweep": name, "dtype": dtype, "rule": {k: chosen[k] for k in (
                "wr", "nspl")}, "best": best, "ms": times})
            del c
    shutil.rmtree(os.path.join(ROOT, "build", "variants"), ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
