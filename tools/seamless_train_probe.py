#!/usr/bin/env python3
"""seamless-m4t-large-v2's trainer at full size (24 + 24 layers, fp32) on
the card: the per-step loss of ten ``make_train_step`` steps at B 4, T 128
with 32 source frames, for a few learning rates, with frames drawn afresh
each step or one set of frames for every step; then the training launcher
(``launch.train``), whose batches carry zero frames, as JAX's launcher's.

    python3 tools/seamless_train_probe.py

What ``chip_smoke.py``'s phase 11c trains on is set from it.  Each run is
one JSON line after the card's name and power limit; everything also goes
to ``chiprun_out/seamless_train_probe.log``.  About 55 s of command time.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = ((3e-4, False), (3e-4, True), (1e-3, False), (1e-4, False))   # (lr, one set of frames)


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("seamless_train_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "seamless_train_probe.log"), "w")
    sys.stdout = cs.Tee(sys.__stdout__, log)
    print(cs.smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    m = cs.assemble()
    m.build.build(["flash_attn", "rmsnorm", "spec_verify_attn"])
    cfg = m.R.get_config(cs.SEAMLESS_ARCH)
    model = m.EncDecLM(cfg)
    B, T, S = cs.SEAMLESS_TRAIN_B, cs.SEAMLESS_TRAIN_T, cs.SEAMLESS_TRAIN_SRC
    dc = m.DataConfig(vocab_size=cfg.vocab_size, batch=B, seq_len=T, seed=0)
    for lr, fixed in RUNS:
        params = model.init(torch.Generator(device="cuda").manual_seed(61), torch.float32, "cuda")
        state = m.init_adamw(params)
        step = m.make_train_step(model, cfg, m.AdamWConfig(lr=lr, warmup_steps=2, total_steps=10),
                                 extra_keys=("src_embeds",))
        g = torch.Generator(device="cuda").manual_seed(67)
        src = torch.randn((B, S, cfg.d_model), generator=g, device="cuda")
        losses = []
        for i in range(10):
            frames = src if fixed else torch.randn((B, S, cfg.d_model), generator=g,
                                                   device="cuda")
            batch = {"tokens": torch.from_numpy(m.batch_at(dc, i)["tokens"]).cuda(),
                     "src_embeds": frames}
            params, state, met = step(params, state, batch)
            losses.append(round(float(met["loss"].cpu()), 4))
        print(json.dumps(dict(lr=lr, one_set_of_frames=fixed, losses=losses)), flush=True)
        del params, state
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        out = m.train.main(["--arch", cs.SEAMLESS_ARCH, "--batch", str(B), "--steps", "10"])
        print(json.dumps({"launcher": {k: out[k] for k in ("params", "losses", "step_ms")}}),
              flush=True)
    except AssertionError as e:
        print(f"launcher: {e}", flush=True)
    print(f"launcher {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
