"""Batched speculative decoding (paper §3, Algorithm 1) on a contiguous
ring KV cache: the port of ``repro.core.spec_decode`` for the contiguous
pool, greedy verification and no chunked prefill.

One speculative step at speculation length ``s`` for a batch of ``b``
ragged requests:

  1. draft phase — the draft model proposes s tokens autoregressively; its
     first feed is always the *two* most recently committed tokens;
  2. verify — the target scores all b x (s+1) positions in one forward
     (ring-buffer writes + position-based masks);
  3. accept — per request, the longest draft prefix matching the target's
     argmax, plus the target's bonus/correction token;
  4. commit — pure length updates for the attention caches.

``s = 0`` is plain batched autoregressive decoding with the same code.
PyTorch runs eagerly, so there is no per-(batch, s) compile cache; the
caches are updated in place instead of being donated.  The step's only
device-to-host reads are the accept and commit counts, read once at the
step boundary for ``StepStats``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM

# headroom rows in the per-request output buffer: one speculative step can
# commit up to s + 1 tokens past max_new.  Also the ceiling on s.
S_MAX = 8


def resolve_device(device: torch.device | str) -> torch.device:
    """The entry points' device rule: CUDA unless the caller names the CPU,
    and no silent move to the CPU when CUDA is missing."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return device


@dataclasses.dataclass
class DecodeState:
    """Device-side state of a running batch."""
    tcache: Any
    dcache: Any
    seq_lens: torch.Tensor      # [B] committed tokens
    last2: torch.Tensor         # [B, 2] tokens at positions n-2, n-1
    out: torch.Tensor           # [B, max_new + S_MAX + 1] generated tokens
    n_generated: torch.Tensor   # [B]
    done: torch.Tensor          # [B] bool


@dataclasses.dataclass
class StepStats:
    accepted: np.ndarray     # [B] accepted draft tokens this step (a)
    committed: np.ndarray    # [B] tokens committed this step (a+1, 0 if done)


class SpecDecodeEngine:
    """Target + draft pair with batched speculative stepping.

    ``dtype`` is the KV caches' dtype; the parameters come from the caller.
    ``device`` defaults to CUDA and raises without it."""

    def __init__(self, target_cfg: ModelConfig, draft_cfg: Optional[ModelConfig],
                 max_new: int = 128, eos_id: int = -1,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cuda"):
        self.tcfg = target_cfg
        self.dcfg = draft_cfg
        self.target = DecoderLM(target_cfg)
        self.draft = DecoderLM(draft_cfg) if draft_cfg is not None else None
        self.max_new = max_new
        self.eos_id = eos_id
        self.dtype = dtype
        self.device = resolve_device(device)

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _init_caches(self, B: int, cache_len: int):
        tcache = self.target.init_cache(B, cache_len, self.dtype, self.device)
        dcache = (self.draft.init_cache(B, cache_len, self.dtype, self.device)
                  if self.draft is not None else None)
        return tcache, dcache

    def prefill(self, tparams, dparams, tokens, prompt_lens,
                cache_len: int) -> DecodeState:
        """Right-padded prompts [B, P] (numpy or tensor) -> a fresh state.
        The target is prefilled with ``prompt_lens - 1`` tokens and the
        draft with ``prompt_lens - 2``; the last two prompt tokens seed the
        first step."""
        lens_host = np.asarray(prompt_lens)
        if int(lens_host.min()) < 3:
            raise ValueError("prompts need >= 3 tokens")
        tokens = self._tensor(tokens, torch.long)
        lens = self._tensor(lens_host)
        B = tokens.shape[0]
        tcache, dcache = self._init_caches(B, cache_len)
        _, tcache, total = self.target.prefill(tparams, tokens, tcache,
                                               prompt_lens=lens - 1)
        if self.draft is not None:
            _, dcache, _ = self.draft.prefill(dparams, tokens, dcache,
                                              prompt_lens=lens - 2)
        bidx = torch.arange(B, device=self.device)
        last2 = torch.stack([tokens[bidx, (lens - 2).long()],
                             tokens[bidx, (lens - 1).long()]], dim=1).to(torch.int32)
        return DecodeState(
            tcache=tcache, dcache=dcache, seq_lens=total + 1, last2=last2,
            out=torch.zeros((B, self.max_new + S_MAX + 1), dtype=torch.int32,
                            device=self.device),
            n_generated=torch.zeros((B,), dtype=torch.int32, device=self.device),
            done=torch.zeros((B,), dtype=torch.bool, device=self.device),
        )

    def step(self, tparams, dparams, state: DecodeState,
             s: int) -> Tuple[DecodeState, StepStats]:
        """One speculative step at length ``s`` for the whole batch.  The
        returned state shares (and has updated in place) the input state's
        caches; the input state must not be stepped again."""
        if not 0 <= s <= S_MAX:
            raise ValueError(
                f"s={s} outside [0, {S_MAX}]: the step's output buffer is "
                f"sized for at most S_MAX={S_MAX} speculative tokens")
        B = state.seq_lens.shape[0]
        fn = make_spec_step(self.target, self.draft, B, s, eos_id=self.eos_id,
                            max_new=self.max_new)
        (tc, dc, seq_lens, last2, out, n_gen, done, a, n_commit) = fn(
            tparams, dparams, state.tcache, state.dcache, state.seq_lens,
            state.last2, state.out, state.n_generated, state.done)
        # step-boundary host read: the accept and commit counts, in one copy
        counts = torch.stack([a, n_commit]).cpu().numpy()
        return (DecodeState(tc, dc, seq_lens, last2, out, n_gen, done),
                StepStats(accepted=counts[0], committed=counts[1]))

    def generate(self, tparams, dparams, tokens, prompt_lens, *, s: int,
                 cache_len: int, max_new: Optional[int] = None,
                 collect_stats: bool = False):
        """Generate ``max_new`` tokens for every request with fixed s.
        Returns (tokens [B, max_new] numpy, list[StepStats], n_steps)."""
        state = self.prefill(tparams, dparams, tokens, prompt_lens, cache_len)
        stats = []
        n_steps = 0
        limit = max_new or self.max_new
        while True:
            state, st = self.step(tparams, dparams, state, s)
            n_steps += 1
            if collect_stats:
                stats.append(st)
            if bool(state.done.all().cpu()) or n_steps > limit * 2 + 8:
                break
        return state.out.cpu().numpy()[:, :self.max_new], stats, n_steps

    def warmup(self, tparams, dparams, batch_sizes, s_values, cache_len: int,
               prompt_len: int = 8):
        """Run one step per (batch, s) pair once, so that library handles
        and the kernels are loaded before anything is timed."""
        for b in batch_sizes:
            tokens = np.full((b, prompt_len), 3, np.int32)
            lens = np.full((b,), prompt_len, np.int32)
            for s in s_values:
                state = self.prefill(tparams, dparams, tokens, lens, cache_len)
                self.step(tparams, dparams, state, s)


def make_spec_step(tgt: DecoderLM, drf: Optional[DecoderLM], B: int, s: int, *,
                   eos_id: int = -1, max_new: int = 128):
    """One greedy speculative step (paper Algorithm 1, batched) for the
    contiguous pool: the port of ``repro.core.spec_decode.make_spec_step``.

    Signature: fn(tparams, dparams, tcache, dcache, seq_lens, last2, out,
    n_generated, done) -> (tcache', dcache', seq_lens', last2', out',
    n_generated', done', accepted, n_commit).  The caches are written in
    place, and nothing is read back to the host.
    """
    eos = eos_id

    def fn(tparams, dparams, tcache, dcache, seq_lens, last2, out,
           n_generated, done):
        dev = seq_lens.device
        # ---- 1. draft phase ----
        if s > 0:
            logits, dcache = drf.decode_step(dparams, last2, dcache, seq_lens - 1)
            lg = logits[:, -1]
            drafts = []
            for i in range(s):
                if i > 0:
                    logits, dcache = drf.decode_step(dparams, d[:, None], dcache,
                                                     seq_lens + i)
                    lg = logits[:, 0]
                d = torch.argmax(lg, dim=-1).to(torch.int32)
                drafts.append(d)
            drafts = torch.stack(drafts, dim=1)                       # [B, s]
        else:
            drafts = torch.zeros((B, 0), dtype=torch.int32, device=dev)

        # ---- 2. verify: [t_{n-1}, d_1..d_s] ----
        feed = torch.cat([last2[:, 1:], drafts], dim=1)              # [B, s+1]
        vlogits, tcache_out = tgt.decode_step(tparams, feed, tcache, seq_lens)
        bidx = torch.arange(B, device=dev)

        # ---- 3. acceptance (argmax verification) ----
        pred = torch.argmax(vlogits, dim=-1).to(torch.int32)          # [B, s+1]
        if s > 0:
            match = drafts == pred[:, :s]
            a = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        else:
            a = torch.zeros((B,), dtype=torch.int32, device=dev)
        a = torch.where(done, 0, a)
        bonus = pred[bidx, a.long()]                                  # [B]

        # ---- 4. commit ----
        tcache_new = tgt.commit(tcache_out, a)
        cand = torch.cat([drafts, bonus[:, None]], dim=1)             # [B, s+1]
        cand[bidx, a.long()] = bonus
        icols = torch.arange(s + 1, device=dev)[None, :]
        write = (icols <= a[:, None]) & (~done[:, None])
        is_eos = (cand == eos) & write
        eos_i = is_eos.to(torch.int32)
        write &= (torch.cumsum(eos_i, dim=1) - eos_i) == 0            # keep first eos
        n_commit = write.sum(dim=1).to(torch.int32)

        # masked write of the committed run: unwritten columns get their old
        # value back (the JAX scatter drops them instead); written columns are
        # in range because a live row has n_generated < max_new
        cols = (n_generated[:, None] + icols).clamp(max=out.shape[1] - 1).long()
        out = out.scatter(1, cols, torch.where(write, cand, out.gather(1, cols)))
        n_generated = n_generated + n_commit
        seq_lens = seq_lens + n_commit
        hit_eos = (is_eos & write).any(dim=1)
        done = done | hit_eos | (n_generated >= max_new)

        # last two committed tokens for the next draft phase
        last1 = torch.where(a > 0, cand[bidx, (a - 1).clamp(min=0).long()],
                            last2[:, 1])
        new_last2 = torch.where(done[:, None], last2,
                                torch.stack([last1, bonus], dim=1))
        last2 = torch.where((n_commit > 0)[:, None], new_last2, last2)
        return (tcache_new, dcache, seq_lens, last2, out, n_generated, done,
                a, n_commit)

    return fn
