#!/usr/bin/env python3
"""Why a chunked prefill's bf16 rows differ from a whole prefill's on the
card, apart from the attention kernels: whether the row-wise operations of
a decoder layer give a row the same bits when it is computed among 64 rows
(a chunk) as among 512 (a whole prompt padded to its bucket).

    python3 tools/chunk_rows_probe.py   # on a GPU

For OPT-6.7B's four products (d 4096, d_ff 16384, the padded vocabulary)
in bf16: rows 384..447 of ``x[512] @ W`` against ``x[384:448] @ W``, with
PyTorch's bf16 reduced-precision reduction allowed (its default) and not;
and K5 (``rms_norm``) on the same rows.  One JSON line each, the card's
name and power limit first; everything also goes to
``chiprun_out/chunk_rows_probe.log``.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chunk_rows_probe: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import common as cm
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    sys.stdout = cs.Tee(sys.__stdout__,
                        open(os.path.join(ROOT, "chiprun_out", "chunk_rows_probe.log"), "w"))
    print(cs.smi(), flush=True)
    build.build(["rmsnorm"])
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    rows = slice(384, 448)
    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        for K, N in ((4096, 4096), (4096, 16384), (16384, 4096), (4096, 50304)):
            x = torch.randn(1, 512, K, generator=g, device="cuda").to(bf)
            W = (torch.randn(K, N, generator=g, device="cuda") * K ** -0.5).to(bf)
            whole, chunk = (x @ W)[:, rows], x[:, rows] @ W
            d = (whole.float() - chunk.float()).abs()
            print(json.dumps(dict(op="matmul", K=K, N=N, reduced_precision_reduction=reduced,
                                  equal=bool(torch.equal(whole, chunk)), max_abs_diff=float(d.max()),
                                  share_differing=float((d > 0).float().mean()))), flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    x = torch.randn(1, 512, 4096, generator=g, device="cuda").to(bf)
    gamma = torch.randn(4096, generator=g, device="cuda").to(bf)
    print(json.dumps(dict(op="rms_norm", d=4096, equal=bool(torch.equal(
        cm.rms_norm(x, gamma)[:, rows], cm.rms_norm(x[:, rows].contiguous(), gamma))))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
