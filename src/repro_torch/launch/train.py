"""Training launcher: data stream -> train loop -> checkpoint, the port of
``repro.launch.train``.

Runs on the card by default, in float32 (as the JAX launcher trains), at
the configuration's full width and depth with seeded random weights;
``--smoke`` takes the reduced same-family config and ``--device cpu`` the
CPU (the kernels' plain versions):

  python -m repro_torch.launch.train --arch internlm2-1.8b --steps 20
  python -m repro_torch.launch.train --smoke --device cpu --steps 12

It asserts that the loss falls, as the JAX launcher does.  ``main``
returns what it printed as a dict: the per-step losses, the parameter
count and the wall time per step (after the first, which builds and loads
the kernels).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry as R
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM
from repro_torch.training import (AdamWConfig, DataConfig, batch_at, init_adamw,
                                  make_train_step, save)
from repro_torch.training.optimizer import leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = R.get_smoke_config(args.arch) if args.smoke else R.get_config(args.arch)
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} training (encoder-decoder, VLM) is not "
                                  "ported yet (ROADMAP queue 1, item 12)")
    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    model = DecoderLM(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed), dtype, device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    opt_state = init_adamw(params)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.2f}M params, "
          f"{args.steps} steps @ batch={args.batch} seq={args.seq} ({args.dtype}, {device})")

    dc = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq,
                    seed=args.seed)
    step_fn = make_train_step(model, cfg, opt_cfg)
    t0 = time.perf_counter()
    t_first = None
    losses = []
    for i in range(args.steps):
        batch = {"tokens": torch.from_numpy(batch_at(dc, i)["tokens"]).to(device)}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"].cpu()))      # the step boundary's host read
        if i == 0:
            t_first = time.perf_counter()
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  ce {float(m['ce'].cpu()):.4f} "
                  f"gnorm {float(m['grad_norm'].cpu()):.3f}  "
                  f"({time.perf_counter() - t0:.1f}s)")
    t_end = time.perf_counter()
    assert losses[-1] < losses[0], "loss did not decrease"
    if args.ckpt:
        save(args.ckpt, params, opt_state, step=args.steps)
        print("checkpoint ->", args.ckpt)
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {
        "arch": cfg.name, "device": str(device), "dtype": args.dtype,
        "params": n_params, "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "losses": losses, "first_step_s": t_first - t0,
        "step_ms": (1e3 * (t_end - t_first) / (args.steps - 1)
                    if args.steps > 1 else None),
    }


if __name__ == "__main__":
    main()
