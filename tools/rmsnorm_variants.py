#!/usr/bin/env python3
"""What limits K5's backward (RMSNorm dx + dgamma) on the card: its device
kernels one by one, variants of ``src/repro_torch/kernels/csrc/rmsnorm.cu``
and forced plans, timed in one process.

    python3 tools/rmsnorm_variants.py [--profile] [--root DIR]   # on a GPU

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
    "noprefetch": [("if constexpr (C * sizeof(R) <= 64) {", "if constexpr (false) {")],
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


def build_variants(build, report) -> dict:
    """Every variant's library, compiled at once; name -> path."""
    src = open(os.path.join(build.CSRC, "rmsnorm.cu")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: substitution target not found: {old!r}")
            text = text.replace(old, new)
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
            if m and kern and "bwd" in kern:
                regs[kern[-60:]] = int(m.group(1))
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln
                         and not ln.strip().startswith("0 bytes spill")})
        report({"variant": name, "bwd_registers": regs, "spills": spills or "none"})
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
    import torch
    if not torch.cuda.is_available():
        print("rmsnorm_variants: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    root = os.path.abspath(argv[argv.index("--root") + 1]) if "--root" in argv else ROOT
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
    shutil.rmtree(os.path.join(ROOT, "build", "variants"), ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
