"""Serving launcher: profile -> LUT -> adaptive serving loop (paper §4),
the port of ``repro.launch.serve``.

Runs on the card by default, in bfloat16, at the configuration's full
width with seeded random weights; ``--smoke`` takes the reduced same-family
config and ``--device cpu`` the CPU (plain kernels):

  python -m repro_torch.launch.serve --arch opt-6.7b --requests 16
  python -m repro_torch.launch.serve --smoke --device cpu --dtype float32
  python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu \
      --dtype float32 --requests 6 --max-new 8 --profile-bs 1,2 --s-max 2

``--arch mamba2-1.3b`` serves the Mamba-2 target (its prefill through the
SSD kernel K6) with its dense draft.  ``--arch qwen3-8b`` (per-head q/k
norms through K5), ``yi-34b`` (seven query heads per kv-head) and
``qwen3-moe-30b-a3b`` (128 experts, top-8) serve the dense and MoE Qwen3 /
Yi targets, each with its dense draft:

  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --smoke \
      --device cpu --dtype float32 --requests 6 --max-new 8 --profile-bs 1,2 --s-max 2

``--arch deepseek-v2-236b`` serves DeepSeek-V2's MLA target (the
compressed ``ckv``/``krope`` cache; 160 experts, top-6, 2 shared) with its
dense draft.  Its 60 layers hold about 479 GB in bf16, so on one 80 GB card
``--layers`` cuts the target's depth (widths uncut):

  python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 8

A family whose requests need modality extras (the encoder-decoder's
``src_embeds``) raises ``NotImplementedError``: JAX's launcher cannot serve
it either.

``main`` returns what it printed as a dict: the profiled per-token latency
grid, the LUT, the adaptive and ``s = 0`` summaries and throughputs, and the
mean accepted run at ``--s-max``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry as R
from repro_torch.core.adaptive import (AdaptiveController, fixed_controller,
                                       measure_acceptance, profile_engine)
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.serving.metrics import summarize
from repro_torch.serving.server import EngineBackend, serve
from repro_torch.serving.traffic import synthetic_prompts, uniform_traffic

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _tokens_per_s(res) -> float:
    """Generated tokens over the time the engine spent generating them."""
    busy = sum(b.duration for b in res.batches)
    return sum(b.tokens_generated for b in res.batches) / busy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-6.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--cv", type=float, default=1.0)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--profile-bs", default="1,2,4,8")
    ap.add_argument("--s-max", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the target to its first N layers (widths uncut)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    tcfg = R.get_smoke_config(args.arch) if args.smoke else R.get_config(args.arch)
    if tcfg.is_encdec or tcfg.family == "vlm":
        # the profile, the acceptance sample and the serving loop prefill
        # without per-request extras, as JAX's launcher does
        raise NotImplementedError(
            f"{tcfg.name}: the serving launcher cannot serve the {tcfg.family!r} family "
            "(per-request modality extras); drive SpecDecodeEngine.generate with "
            "target_extras={'src_embeds': ...} (an encoder-decoder) or "
            "{'prefix_embeds': ...} (a VLM) instead")
    if args.layers is not None:
        tcfg = tcfg.with_(n_layers=args.layers)
    dcfg = R.get_draft_config(args.arch)
    if args.smoke:
        dcfg = dataclasses.replace(
            dcfg, n_layers=2, d_model=64, d_ff=128, vocab_size=tcfg.vocab_size,
            attn=dataclasses.replace(dcfg.attn, n_heads=2, n_kv_heads=2,
                                     head_dim=32))
    dtype = _DTYPES[args.dtype]
    engine = SpecDecodeEngine(tcfg, dcfg, max_new=args.max_new, dtype=dtype,
                              device=args.device)
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    tparams = engine.target.init(gen, dtype, engine.device)
    dparams = engine.draft.init(gen, dtype, engine.device)

    # ---- profiling stage (paper §4) ----
    rng = np.random.default_rng(args.seed + 1)
    sample = synthetic_prompts(8, tcfg.vocab_size, rng, 8, 16)
    P = max(len(p) for p in sample)
    toks = np.zeros((len(sample), P), np.int32)
    lens = np.zeros((len(sample),), np.int32)
    for i, p in enumerate(sample):
        toks[i, :len(p)] = p
        lens[i] = len(p)
    bs = [int(x) for x in args.profile_bs.split(",")]
    t0 = time.perf_counter()
    lut = profile_engine(engine, tparams, dparams, toks, lens,
                         batch_sizes=bs, s_values=range(0, args.s_max + 1),
                         gen_tokens=16, cache_len=args.cache_len)
    profile_s = time.perf_counter() - t0
    print(f"profiling took {profile_s:.1f}s; LUT: {lut.table} "
          f"(monotone={lut.is_monotone()})")
    for b in lut.batch_sizes:
        print(f"  b={b}: ms/token by s: "
              + " ".join(f"{s}:{1e3 * t:.3f}" for s, t in lut.per_token[b].items()))
    runs = measure_acceptance(engine, tparams, dparams, toks, lens,
                              s=args.s_max, gen_tokens=16,
                              cache_len=args.cache_len)
    mean_accepted = float(np.mean(runs))
    print(f"mean accepted drafts at s={args.s_max}: {mean_accepted:.3f}")

    # ---- execution stage ----
    reqs = uniform_traffic(args.requests, args.interval, args.cv,
                           tcfg.vocab_size, seed=args.seed + 2,
                           max_new=args.max_new)
    backend = EngineBackend(engine, tparams, dparams, cache_len=args.cache_len)
    res = serve([dataclasses.replace(r) for r in reqs],
                backend, AdaptiveController(lut=lut), max_batch=args.max_batch)
    print("adaptive:", summarize(res))
    res0 = serve([dataclasses.replace(r) for r in reqs],
                 backend, fixed_controller(0), max_batch=args.max_batch)
    print("no-spec :", summarize(res0))
    speedup = res0.mean_latency / res.mean_latency
    print(f"speedup: {speedup:.2f}x")
    return {
        "arch": tcfg.name, "n_layers": tcfg.n_layers, "draft": dcfg.name,
        "device": str(engine.device),
        "dtype": args.dtype, "profile_s": profile_s,
        "grid_s_per_token": {b: dict(d) for b, d in lut.per_token.items()},
        "lut": dict(lut.table), "lut_monotone": lut.is_monotone(),
        "mean_accepted": mean_accepted,
        "adaptive": dataclasses.asdict(summarize(res)),
        "no_spec": dataclasses.asdict(summarize(res0)),
        "speedup": speedup,
        "tokens_per_s_adaptive": _tokens_per_s(res),
        "tokens_per_s_no_spec": _tokens_per_s(res0),
        "batches": len(res.batches),
        "wall_s": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    main()
