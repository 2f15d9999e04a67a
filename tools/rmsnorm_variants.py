#!/usr/bin/env python3
"""What limits K5 (RMSNorm) on the card: the backward's device kernels one
by one, variants of ``src/repro_torch/kernels/csrc/rmsnorm.cu`` and forced
plans of either direction, timed in one process.

    python3 tools/rmsnorm_variants.py [--profile] [--root DIR]   # on a GPU
    python3 tools/rmsnorm_variants.py --fwd [--old FILE] [--prev FILE]   # on a GPU
    python3 tools/rmsnorm_variants.py --write-old REV [--old FILE]

``--fwd``: the forward at every one of phase 2c's cases
(``chip_smoke.NORM_CASES``), each timed in turns (old, new, ``F.rms_norm``,
new, old) against an older source of the kernel (``--old``, by default
``build/variants/rmsnorm_old.cu``, which ``--write-old REV`` writes from
``git show REV:src/repro_torch/kernels/csrc/rmsnorm.cu`` before a card run:
the copy on the card has no git), called through its own C entry point;
with ``--prev FILE`` (written the same way: ``--write-old REV --old
FILE``), also a source whose ``rmsnorm_fwd`` takes the plan with rows a
group (``vec, lanes, chunks, gpb, rpg, groups, blocks``), called at this
rule's plan with one row a group, in turns with the new one; then ablations of the new forward that only time (``fwd_nostores``: no y
stores; ``fwd_oneload``: every group reads row 0 (hits in L2: what the
loads from device memory cost); ``fwd_nogamma``: no gamma loads or
product; ``fwd_gammalate``: gamma read where it is used, not kept in
registers; ``fwd_row32``: the row index in 32 bits; ``fwd_gammafirst``:
gamma's registers pinned before the sum of squares, so its loads cannot
sink below it); then ``fwd_plan`` forced to every legal lanes and groups a
block (``legal_fwd_plans``), each result held against the plain version:
what the forward's rule is set from.  Two more shapes join phase 2c's there
(``FWD_EXTRA``: qwen3-8b's q rows at a 2048-token prefill and at a B 16
decode step).  Each library's forward kernels' instruction counts
(``cuobjdump -sass``) are reported, the listings written to
``chiprun_out/rmsnorm_fwd_sass.txt``.

First, at phase 2c's K5 grads cases: the backward's time a call
(``chip_smoke.device_ms``), the forward's, ``F.rms_norm``'s forward +
backward, and the backward's device kernels one by one (``torch.profiler``:
each kernel's time, the gap inside a call and between calls, the call's
span).  ``--root DIR`` does only that, for the port of another checkout
(unpack a parent commit there with ``git archive``; its kernels are built
under ``DIR/build/``); ``--profile`` does only that for this one.  Then the
source variants, copies of the source with text substitutions, built
with the same ``nvcc`` flags into ``build/variants/`` (gitignored):

- ``base``       the source as it is;
- ``noreduce``   no row sum across a unit's warps (each warp uses its own);
- ``noprefetch`` the next row's x and dy loaded after this row's stores,
                 into one register set, not before its sum into a second;
- ``noloads``    every row of a unit read from its first row's address
                 (hits in L1/L2: what the loads from device memory cost);
- ``nodgamma``   no dgamma partials and no combine launch;
- ``nostores``   no dx stores (the values are still computed);
- ``nopdl``      the combine launched plainly, not as a dependent launch;
- ``early``      the combine's blocks allowed to start (and wait) when the
                 rows kernel starts, not when its units leave their rows.

The wrapper is pointed at each library in turn, ``base`` first and last.
``noreduce``, ``noloads``, ``nodgamma`` and ``nostores`` compute wrong
results: only their times mean anything.  Then the sweep: ``base`` with
``bwd_plan`` forced to every warps a unit, rows a unit and combine strip
(``legal_plans``) at the cases, which is what the wrapper's rule is
set from; those results are right.  One JSON line per case, the card's
name and power limit first; everything also goes to
``chiprun_out/rmsnorm_variants.log``.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
from statistics import median

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, n, d, dtype): phase 2c's grads cases
CASES = [("internlm2_train", 1024, 2048, "float32"),
         ("opt125m_distill", 1024, 768, "float32"),
         ("internlm2_train_bf16", 1024, 2048, "bfloat16"),
         ("small_n128", 128, 2048, "float32"),
         ("odd_d1000", 257, 1000, "float32")]
# (old, new) substitutions of the source's text
VARIANTS = {
    "base": [],
    "noreduce": [("if (a.wpr > 1) {  // the row's warps", "if (false) {  // the row's warps")],
    "noprefetch": [("if constexpr (C * sizeof(R) <= 64) {\n    // rows in pairs, two register "
                    "sets in turn (a copy",
                    "if constexpr (false) {\n    // rows in pairs, two register sets in turn "
                    "(a copy")],
    "noloads": [("const long long off = static_cast<long long>(r) * a.d;\n    rs = ",
                 "const long long off = static_cast<long long>(r0) * a.d;\n    rs = ")],
    "nodgamma": [("dg[k][e] = fmaf(dyv, round_to<T>(xh), dg[k][e]);", ""),
                 ("  allow_dependents();\n  float* pr", "  return;\n  float* pr"),
                 ("  if (e != cudaSuccess) return e;\n  const dim3 grid(",
                  "  if (true) return e;\n  const dim3 grid(")],
    "nostores": [("        A::store(dx + off + j * VEC, o);",
                  "        if (o[0] == 1234.5f) A::store(dx + off + j * VEC, o);")],
    "nopdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    "early": [("  if (u >= a.units) return;\n  const T* x",
               "  allow_dependents();\n  if (u >= a.units) return;\n  const T* x"),
              ("  allow_dependents();\n  float* pr", "  float* pr")],
}


# the forward's ablations: substitutions of the source's text (timing only)
FWD_VARIANTS = {
    "fwd_nostores": [("      A::store(y + off + j * VEC, o);",
                      "      if (o[0] == 1234.5f) A::store(y + off + j * VEC, o);")],
    "fwd_oneload": [("      if (j < nacc) xv[k] = A::load(x + off + j * VEC);",
                     "      if (j < nacc) xv[k] = A::load(x + j * VEC);")],
    "fwd_nogamma": [("      gm[k] = j < nacc && live ? A::load(gamma + j * VEC) : R{};\n    }\n  }\n"
                     "  auto gam",
                     "      gm[k] = R{};\n    }\n  }\n  auto gam"),
                    ("o[e] = round_to<T>(A::get(xv[k], e) * rs) * A::get(gk, e);",
                     "o[e] = round_to<T>(A::get(xv[k], e) * rs);")],
    "fwd_gammalate": [("  constexpr bool keep_gamma = VEC > 1 || C <= 8;\n  const T* gamma = "
                       "static_cast<const T*>(a.gamma);\n  R gm[keep_gamma ? C : 1];\n  if constexpr",
                       "  constexpr bool keep_gamma = false;\n  const T* gamma = "
                       "static_cast<const T*>(a.gamma);\n  R gm[keep_gamma ? C : 1];\n  if constexpr")],
    "fwd_row32": [("  const long long r = static_cast<long long>(blockIdx.x) * a.gpb + gi;",
                   "  const long long r = static_cast<long long>(blockIdx.x * a.gpb + gi);")],
    "fwd_gammafirst": [("\n  double ss = 0.0;\n  if (live) {",
                        "\n  if constexpr (keep_gamma && VEC > 1) {\n#pragma unroll\n"
                        "    for (int k = 0; k < C; ++k)\n      asm volatile(\"\" :: \"r\"(gm[k].x), "
                        "\"r\"(gm[k].y), \"r\"(gm[k].z), \"r\"(gm[k].w));\n  }\n"
                        "  double ss = 0.0;\n  if (live) {")],
}
# shapes the forward sweep adds to phase 2c's: qwen3-8b's q rows at a
# 2048-token prefill and at a B 16 decode step (bf16)
FWD_EXTRA = [("qwen3_8b_q_prefill_t2048", 65536, 128, "bfloat16", False),
             ("qwen3_8b_q_decode_b16", 512, 128, "bfloat16", False)]
OLD_SOURCE = os.path.join(ROOT, "build", "variants", "rmsnorm_old.cu")


def kernel_name(name: str) -> str:
    m = re.search(r"[A-Za-z_]\w*(?=[<(])", name)
    return m.group(0) if m else name


def split_by_kernel(torch, fn, arg_sets, calls=20):
    """Each device kernel's mean time a call, the median gap from one
    kernel's end to the next one's start inside a call and between calls,
    and the median span of a call (first start to last end), in ms, from
    ``torch.profiler`` over ``calls`` calls queued behind a sleeping
    kernel, the inputs rotated as ``chip_smoke.device_ms`` rotates them
    (out of the L2)."""
    from torch.profiler import ProfilerActivity, profile
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and ("rmsnorm" in e.name or "dgamma" in e.name)),
                 key=lambda e: e.time_range.start)
    names = list(dict.fromkeys(kernel_name(e.name) for e in evs))
    per = len(names)
    if per == 0 or len(evs) != per * calls:
        return {"kernels": names, "events": len(evs), "complete": False}
    out = {"kernels": names, "complete": True}
    for k in names:
        ts = [e.time_range.end - e.time_range.start for e in evs if kernel_name(e.name) == k]
        out[k + "_ms"] = sum(ts) / len(ts) / 1e3
    gaps, spans, between = [], [], []
    for c in range(calls):
        call = evs[c * per:(c + 1) * per]
        gaps += [b.time_range.start - a.time_range.end for a, b in zip(call, call[1:])]
        spans.append(call[-1].time_range.end - call[0].time_range.start)
        if c:
            between.append(call[0].time_range.start - evs[c * per - 1].time_range.end)
    out["gap_in_call_ms"] = median(gaps) / 1e3 if gaps else 0.0
    out["span_ms"] = median(spans) / 1e3
    out["gap_between_calls_ms"] = median(between) / 1e3 if between else 0.0
    return out


def make_case(torch, n, d, dtype, seed):
    """phase 2c's inputs (``chip_smoke.run_norm_case``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (3 * torch.randn((n, d), generator=g, device="cuda")).to(dt)
    gamma = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")).to(dt)
    dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
    return x, gamma, dy


def profile_cases(torch, cs, K5, report, label):
    import torch.nn.functional as F
    for i, (name, n, d, dtype) in enumerate(CASES):
        x, gamma, dy = make_case(torch, n, d, dtype, 300 + i)
        _, rstd = K5.rmsnorm_fwd_cuda(x, gamma, save_rstd=True)
        copies = min(64, max(2, math.ceil(2 * 50e6 / (3 * n * d * x.element_size()))))
        sets = [tuple(t.clone() for t in (x, gamma, dy, rstd)) for _ in range(copies)]

        def lib(x, gm, d_, r):
            leaf = [x.detach().requires_grad_(True), gm.detach().requires_grad_(True)]
            return torch.autograd.grad(F.rms_norm(leaf[0], (d,), leaf[1], 1e-6), leaf, d_)
        row = {"checkout": label, "case": name, "shape": f"n{n} d{d}", "dtype": dtype,
               "fwd_ms": cs.device_ms(torch, lambda x, gm, *_: K5.rmsnorm_fwd_cuda(
                   x, gm, save_rstd=True), sets),
               "bwd_ms": cs.device_ms(torch, K5.rmsnorm_bwd_cuda, sets),
               "library_fwd_bwd_ms": cs.device_ms(torch, lib, sets),
               "bwd_by_kernel": split_by_kernel(torch, K5.rmsnorm_bwd_cuda, sets)}
        row["fwd_plus_bwd_ms"] = row["fwd_ms"] + row["bwd_ms"]
        report(row)
        del sets


def variant_source(src: str, name: str, subs) -> str:
    """``src`` with each (old, new) substitution made; each target must
    occur exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: substitution target found "
                               f"{src.count(old)} times, not once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(build, report, variants=VARIANTS, extra=None, kind="bwd") -> dict:
    """Every variant's library, compiled at once; name -> path.  ``extra``:
    name -> the full text of another source to build beside them."""
    src = open(os.path.join(build.CSRC, "rmsnorm.cu")).read()
    texts = {name: variant_source(src, name, subs) for name, subs in variants.items()}
    texts.update(extra or {})
    procs = {}
    for name, text in texts.items():
        d = os.path.join(ROOT, "build", "variants", "rmsnorm_" + name)
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, "rmsnorm.cu"), "w").write(text)
        lib = os.path.join(d, "librmsnorm.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", lib, os.path.join(d, "rmsnorm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{text[-4000:]}")
        regs = {}
        kern = None
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                kern = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and kern and kind in kern:
                regs[kern[-60:]] = int(m.group(1))
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln
                         and not ln.strip().startswith("0 bytes spill")})
        report({"variant": name, f"{kind}_registers": regs, "spills": spills or "none"})
        libs[name] = lib
    return libs


def legal_plans(K5, n: int, d: int, sms: int, elem_bytes: int):
    """Every plan the sweep forces: warps a unit 1-8 (where the kernel has
    a build for the accesses that leaves), rows a unit 1-16, strips 1-8."""
    vw = 16 // elem_bytes
    vec = vw if d % vw == 0 else 1
    nacc = -(-d // vec)
    for wpr in (1, 2, 4, 8):
        if K5._chunks(-(-nacc // (32 * wpr)), vec) is None:
            continue
        for rpu in (1, 2, 4, 8, 16):
            if rpu <= n:
                for strip in (1, 2, 4, 8):
                    yield K5.bwd_plan(n, d, sms, elem_bytes, True, wpr, rpu, strip)


def point_wrapper_at(K5, lib: str) -> None:
    K5._lib()
    K5._bind(ctypes.CDLL(lib))


def main() -> int:
    argv = sys.argv[1:]
    old_src = os.path.abspath(argv[argv.index("--old") + 1]) if "--old" in argv else OLD_SOURCE
    if "--write-old" in argv:
        return write_old(argv[argv.index("--write-old") + 1], old_src)
    root = os.path.abspath(argv[argv.index("--root") + 1]) if "--root" in argv else ROOT
    import torch
    if not torch.cuda.is_available():
        print("rmsnorm_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import chip_smoke as cs
    build = importlib.import_module("repro_torch.kernels.build")
    K5 = importlib.import_module("repro_torch.kernels.rmsnorm")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    label = os.path.relpath(root, ROOT) if root != ROOT else "this"
    log = open(os.path.join(ROOT, "chiprun_out", "rmsnorm_variants.log"), "a")

    def report(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()
    report({"nvidia_smi": cs.smi(), "kind": torch.cuda.get_device_name(0),
            "checkout": label, "torch": torch.__version__})
    lib = build.build(["rmsnorm"])["rmsnorm"]
    report({"checkout": label, "ptxas": cs.ptxas_report(lib.with_suffix(".log").read_text())})
    if "--fwd" in argv:
        prev_src = (os.path.abspath(argv[argv.index("--prev") + 1]) if "--prev" in argv
                    else None)
        fwd_sweep(torch, cs, K5, build, report, old_src, prev_src)
        return 0
    profile_cases(torch, cs, K5, report, label)
    if "--profile" in argv or root != ROOT:
        return 0
    sweep(torch, cs, K5, build, report)
    return 0


def sweep(torch, cs, K5, build, report) -> None:
    """The source variants at the cases, then forced plans."""
    libs = build_variants(build, report)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    order = ["base"] + [v for v in VARIANTS if v != "base"] + ["base"]
    for i, (name, n, d, dtype) in enumerate(CASES):
        x, gamma, dy = make_case(torch, n, d, dtype, 300 + i)
        _, rstd = K5.rmsnorm_fwd_cuda(x, gamma, save_rstd=True)
        copies = min(64, max(2, math.ceil(2 * 50e6 / (3 * n * d * x.element_size()))))
        sets = [tuple(t.clone() for t in (x, gamma, dy, rstd)) for _ in range(copies)]
        row = {"case": name, "shape": f"n{n} d{d}", "dtype": dtype}
        for v in order:
            point_wrapper_at(K5, libs[v])
            row[v if v not in row else v + "_again"] = cs.device_ms(
                torch, K5.rmsnorm_bwd_cuda, sets)
        point_wrapper_at(K5, libs["base"])
        report(row)
        rule = K5.bwd_plan
        chosen = rule(n, d, sms, x.element_size())
        times = {}
        for plan in list(legal_plans(K5, n, d, sms, x.element_size())):
            K5.bwd_plan = lambda *a, plan=plan, **k: plan  # noqa: E731
            key = f"wpr{plan['wpr']}_rpu{plan['rpu']}_sw{plan['strip']}"
            try:
                times[key] = cs.device_ms(torch, K5.rmsnorm_bwd_cuda, sets)
            except RuntimeError as e:          # a plan the card refuses: say which
                report({"sweep": name, "refused": plan, "error": str(e)})
        K5.bwd_plan = rule
        best = min(times, key=times.get)
        report({"sweep": name, "dtype": dtype, "rule": {k: chosen[k] for k in (
            "wpr", "rpu", "strip")}, "best": best, "ms": times})
        del sets
    for lib in libs.values():
        shutil.rmtree(os.path.dirname(lib), ignore_errors=True)


# ---------------------------------------------------------------------------
# the forward


def write_old(rev: str, path: str) -> int:
    """The kernel's source at ``rev``, written to ``path`` for ``--fwd``."""
    text = subprocess.run(["git", "show", f"{rev}:src/repro_torch/kernels/csrc/rmsnorm.cu"],
                          cwd=ROOT, check=True, capture_output=True, text=True).stdout
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").write(text)
    print(f"wrote {path} ({len(text)} bytes) from {rev}")
    return 0


def legal_fwd_plans(K5, n: int, d: int, elem_bytes: int):
    """Every plan the forward sweep forces: each lanes a group, a power of
    two, from the fewest the kernel has a build for at d up to the fewest
    that give each lane at most one access; blocks of 64, 128 or 256
    threads (one group where it is wider)."""
    vw = 16 // elem_bytes
    vec = vw if d % vw == 0 else 1
    nacc = -(-d // vec)
    lanes = 1
    while True:
        if any(c * lanes >= nacc for c in K5.FWD_CHUNKS[vec]):
            for gpb in sorted({max(1, t // lanes) for t in (64, 128, 256)}):
                yield K5.fwd_plan(n, d, elem_bytes, True, lanes, gpb)
        if lanes >= nacc or lanes >= K5.FWD_THREADS:
            return
        lanes *= 2


def old_entry(torch, path: str):
    """The older source's forward through its own C entry point
    (``rmsnorm_fwd(dtype, x, gamma, y, rstd, n, d, eps, stream)``): a
    function of (x, gamma) giving (y, rstd)."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_fwd.argtypes = [i, p, p, p, p, i, i, ctypes.c_float, p]
    lib.rmsnorm_fwd.restype = i
    code = {torch.float32: 0, torch.bfloat16: 1}

    def fwd(x, gamma):
        n, d = x.shape
        y = torch.empty_like(x)
        rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
        rc = lib.rmsnorm_fwd(code[x.dtype], x.data_ptr(), gamma.data_ptr(), y.data_ptr(),
                             rstd.data_ptr(), n, d, 1e-6,
                             torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"old rmsnorm forward failed: cudaError {rc}")
        return y, rstd
    return fwd


def prev_entry(torch, K5, path: str):
    """A source's forward whose C entry point takes the plan with rows a
    group (``rmsnorm_fwd(dtype, x, gamma, y, rstd, n, d, eps, vec, lanes,
    chunks, gpb, rpg, groups, blocks, stream)``), called at ``fwd_grid``'s
    plan with one row a group: a function of (x, gamma) giving (y, rstd)."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_fwd.argtypes = [i, p, p, p, p, i, i, ctypes.c_float] + [i] * 7 + [p]
    lib.rmsnorm_fwd.restype = i
    code = {torch.float32: 0, torch.bfloat16: 1}

    def fwd(x, gamma):
        n, d = x.shape
        y = torch.empty_like(x)
        rstd = torch.empty((n,), dtype=torch.float32, device=x.device)
        vec, lanes, chunks, gpb = K5.fwd_grid(d, x.element_size(), True)
        rc = lib.rmsnorm_fwd(code[x.dtype], x.data_ptr(), gamma.data_ptr(), y.data_ptr(),
                             rstd.data_ptr(), n, d, 1e-6, vec, lanes, chunks, gpb, 1, n,
                             -(-n // gpb), torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"prev rmsnorm forward failed: cudaError {rc}")
        return y, rstd
    return fwd


def sass_sizes(build, libs: dict) -> dict:
    """Instructions of each forward kernel in each library
    (``cuobjdump -sass``); the listings go to
    ``chiprun_out/rmsnorm_fwd_sass.txt``."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sizes = {}
    with open(os.path.join(ROOT, "chiprun_out", "rmsnorm_fwd_sass.txt"), "w") as f:
        for name, lib in libs.items():
            text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
            for part in text.split("Function : ")[1:]:
                fn = part.split("\n", 1)[0].strip()
                if "rmsnorm_fwd_kernel" not in fn:
                    continue
                sizes[f"{name}:{fn[-48:]}"] = len(re.findall(r"/\*[0-9a-f]{4,}\*/", part))
                f.write(f"==== {name}: {fn}\n{part}\n")
    return sizes


def fwd_sweep(torch, cs, K5, build, report, old_src: str, prev_src=None) -> None:
    """The forward at phase 2c's cases: the older source and the new one in
    turns beside ``F.rms_norm`` and a one-value fill (the launch floor),
    ``prev_src``'s forward in turns with the new one, the ablations, then
    every forced plan."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    extra = {"fwd_old": open(old_src).read()}
    if prev_src:
        extra["fwd_prev"] = open(prev_src).read()
    libs = build_variants(build, report, {"fwd_base": [], **FWD_VARIANTS}, extra, kind="fwd")
    old = old_entry(torch, libs["fwd_old"])
    prev = prev_entry(torch, K5, libs["fwd_prev"]) if prev_src else None
    report({"fwd_code": sass_sizes(build, {k: libs[k] for k in (
        "fwd_base", "fwd_old", "fwd_prev", "fwd_row32", "fwd_gammafirst") if k in libs})})
    floor_t = torch.empty(1, device="cuda")
    for i, (name, n, d, dtype, _) in enumerate(cs.NORM_CASES + FWD_EXTRA):
        x, gamma, _ = make_case(torch, n, d, dtype, 300 + i)
        tol = cs.TOL[dtype]
        copies = min(64, max(2, math.ceil(2 * 50e6 / (3 * n * d * x.element_size()))))
        sets = [tuple(t.clone() for t in (x, gamma)) for _ in range(copies)]
        point_wrapper_at(K5, libs["fwd_base"])
        new = lambda x_, gm: K5.rmsnorm_fwd_cuda(x_, gm, save_rstd=True)  # noqa: E731
        want = ref.rmsnorm_ref(x, gamma)
        row = {"case": name, "shape": f"n{n} d{d}", "dtype": dtype,
               "plan": {k: v for k, v in K5.fwd_plan(n, d, x.element_size()).items()
                        if k in K5.FWD_ARGS},
               "new_err": cs.within(torch, new(x, gamma)[0], want, tol)[0],
               "old_err": cs.within(torch, old(x, gamma)[0], want, tol)[0]}
        for key, fn in (("old", old), ("new", new),
                        ("library", lambda x_, gm: F.rms_norm(x_, (d,), gm, 1e-6)),
                        ("floor", lambda x_, gm: floor_t.fill_(0.0)),
                        ("new_again", new), ("old_again", old)):
            row[key + "_ms"] = cs.device_ms(torch, fn, sets)
        if prev is not None:
            row["prev_err"] = cs.within(torch, prev(x, gamma)[0], want, tol)[0]
            for key, fn in (("prev", prev), ("new_turn", new), ("prev_again", prev),
                            ("new_turn_again", new)):
                row[key + "_ms"] = cs.device_ms(torch, fn, sets)
        for v in FWD_VARIANTS:
            point_wrapper_at(K5, libs[v])
            row[v + "_ms"] = cs.device_ms(torch, new, sets)
        point_wrapper_at(K5, libs["fwd_base"])
        t_bytes = ((2 * n * d + d) * x.element_size() + 4 * n) / cs.HBM_BYTES_PER_S
        row["bound_ms"] = 1e3 * max(t_bytes, 4 * n * d / cs.PEAK_OPS["float32"])
        report(row)
        rule = K5.fwd_grid
        times, bad = {}, []
        for plan in list(legal_fwd_plans(K5, n, d, x.element_size())):
            grid = tuple(plan[k] for k in K5.FWD_ARGS)
            K5.fwd_grid = lambda *a, grid=grid, **k: grid  # noqa: E731
            key = f"l{plan['lanes']}_c{plan['chunks']}_t{plan['threads']}"
            try:
                if not cs.within(torch, new(x, gamma)[0], want, tol)[1]:
                    bad.append(key)
                times[key] = cs.device_ms(torch, new, sets)
            except RuntimeError as e:          # a plan the card refuses: say which
                report({"fwd_sweep": name, "refused": key, "error": str(e)})
        K5.fwd_grid = rule
        best = min(times, key=times.get)
        report({"fwd_sweep": name, "dtype": dtype, "rule": row["plan"], "best": best,
                "best_ms": times[best], "wrong": bad, "ms": times})
        del sets
    for lib in libs.values():
        shutil.rmtree(os.path.dirname(lib), ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
