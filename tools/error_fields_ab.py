#!/usr/bin/env python3
"""Phase 2, 2b and 2c's kernel rows of another checkout, held field by field
against a ``chip_smoke.py`` log of this one: whether a change left every
old row's error fields bit for bit as they were.

    python3 tools/error_fields_ab.py --other build/parent --log chiprun_out/chip_smoke.log

Unpack the other checkout first (``git archive REV | tar -x -C build/parent``,
here where git is); it is run in its own directory, with its own sources
and build, and its rows go to ``chiprun_out/error_fields_other.log``.  The
cases' seeds are their indices, so the rows both logs hold ran on the same
inputs.  Prints one JSON object: the rows compared, the error fields
compared, the rows only one side has, and every row whose fields differ.
Exits 1 if any differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_OTHER = """
import os, sys
sys.path.insert(0, os.path.join(os.getcwd(), "src")); sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
m = cs.assemble()
m.build.build(["spec_verify_attn", "paged_verify_attn", "flash_attn", "rmsnorm"])
cs.phase_kernels(torch, m.K1, m.ref)
cs.phase_paged_kernels(torch, np, m.K23, m.paged, m.ref)
cs.phase_train_kernels(torch, m.K4, m.K5, m.ref)
"""


def error_fields(path: str) -> dict:
    out = {}
    for ln in open(path):
        if ln.startswith('  {"case"'):
            r = json.loads(ln)
            out[r["case"]] = {k: v for k, v in r.items() if "err" in k}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the other checkout's directory")
    ap.add_argument("--log", required=True, help="this checkout's chip_smoke.py log")
    args = ap.parse_args(argv)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    other_log = os.path.join(ROOT, "chiprun_out", "error_fields_other.log")
    with open(other_log, "w") as f:
        rc = subprocess.call([sys.executable, "-c", RUN_OTHER], cwd=args.other, stdout=f,
                             stderr=subprocess.STDOUT)
    new, old = error_fields(args.log), error_fields(other_log)
    common = sorted(set(new) & set(old))
    diff = [(c, new[c], old[c]) for c in common if new[c] != old[c]]
    print(json.dumps({"other_rc": rc, "rows_compared": len(common),
                      "error_fields_compared": sum(len(old[c]) for c in common),
                      "only_this": sorted(set(new) - set(old)),
                      "only_other": sorted(set(old) - set(new)), "differ": diff}))
    return 1 if diff or rc else 0


if __name__ == "__main__":
    sys.exit(main())
