"""Adaptive speculative decoding (paper §4): profile-then-serve.

Profiling stage: measure per-token latency on a small prompt sample over the
grid (b in powers of two up to b_max) x (s in 0..s_max), build a look-up
table b -> s_opt.  Execution stage: each formed batch looks up its optimal
speculation length; batch sizes that were not profiled take the *smaller*
speculation length of the two nearest profiled sizes (paper §4).

Two profiling backends share the LUT machinery:
  * :func:`profile_engine`   — wall-clock measurement of a live
    :class:`~repro_torch.core.spec_decode.SpecDecodeEngine` (the paper's
    method);
  * :class:`~repro_torch.core.analytical.LatencyModel` — fitted or
    roofline-derived analytical model.

A copy of ``repro.core.adaptive`` whose host reads of the engine state are
explicit copies to the host at step boundaries (``state.done`` is a device
tensor in the port).  The engine's ``step`` ends in such a read, so the
wall-clock profile times work that the device has finished.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analytical import (LatencyModel, acceptance_curve,
                                   fit_latency_model, fit_power_law)


# ---------------------------------------------------------------------------
# LUT


@dataclass(frozen=True)
class SpeculationLUT:
    """b -> s_opt table with the paper's nearest-profiled lookup rule."""
    table: Mapping[int, int]                 # profiled batch size -> s_opt
    per_token: Mapping[int, Mapping[int, float]] = field(default_factory=dict)

    @property
    def batch_sizes(self) -> List[int]:
        return sorted(self.table)

    def lookup(self, b: int) -> int:
        """Optimal s for batch size ``b``.

        Profiled sizes return their entry; unprofiled sizes take the smaller
        s of the two nearest profiled sizes (paper §4); out-of-range sizes
        clamp to the nearest profiled size.
        """
        bs = self.batch_sizes
        if not bs:
            raise ValueError("empty LUT")
        if b in self.table:
            return self.table[b]
        if b <= bs[0]:
            return self.table[bs[0]]
        if b >= bs[-1]:
            return self.table[bs[-1]]
        lo = max(x for x in bs if x < b)
        hi = min(x for x in bs if x > b)
        return min(self.table[lo], self.table[hi])

    def is_monotone(self) -> bool:
        """s_opt non-increasing in b — the paper's key observation."""
        vals = [self.table[b] for b in self.batch_sizes]
        return all(a >= b for a, b in zip(vals, vals[1:]))


def lut_from_model(model: LatencyModel, s_max: int = 8,
                   batch_sizes: Optional[Sequence[int]] = None) -> SpeculationLUT:
    bs = list(batch_sizes) if batch_sizes is not None else list(model.batch_sizes)
    table = {b: model.s_opt(b, s_max) for b in bs}
    per_token = {b: {s: model.per_token_time(b, s) for s in range(0, s_max + 1)}
                 for b in bs}
    return SpeculationLUT(table=table, per_token=per_token)


def lut_from_grid(per_token: Mapping[int, Mapping[int, float]]) -> SpeculationLUT:
    """LUT from a measured (b, s) -> per-token-latency grid (argmin over s)."""
    table = {b: min(d, key=d.get) for b, d in per_token.items()}
    return SpeculationLUT(table=table, per_token=dict(per_token))


# ---------------------------------------------------------------------------
# wall-clock profiling of a live engine (the paper's profiling stage)


def profile_engine(engine, tparams, dparams, prompts: np.ndarray,
                   prompt_lens: np.ndarray, *,
                   batch_sizes: Sequence[int] = (1, 2, 4, 8, 16),
                   s_values: Sequence[int] = tuple(range(0, 9)),
                   gen_tokens: int = 32, cache_len: int = 256,
                   repeats: int = 1) -> SpeculationLUT:
    """Measure per-token latency for every (b, s) grid point.

    ``prompts`` [P, Tp] / ``prompt_lens`` [P] is the profiling sample (the
    paper uses a held-out slice of the dataset).  Each grid point generates
    ``gen_tokens`` tokens per request and records wall time / tokens.
    """
    grid: Dict[int, Dict[int, float]] = {}
    P = prompts.shape[0]
    for b in batch_sizes:
        reps = int(np.ceil(b / P))
        toks = np.tile(prompts, (reps, 1))[:b]
        lens = np.tile(prompt_lens, reps)[:b]
        grid[b] = {}
        for s in s_values:
            best = float("inf")
            for _ in range(max(repeats, 1)):
                # compile outside the timed region (the paper's profiling is
                # steady-state serving latency)
                state = engine.prefill(tparams, dparams, toks, lens, cache_len)
                engine.step(tparams, dparams, state, s)
                state = engine.prefill(tparams, dparams, toks, lens, cache_len)
                t0 = time.perf_counter()
                total = 0
                while total < gen_tokens * b:
                    state, st = engine.step(tparams, dparams, state, s)
                    total += int(st.committed.sum())
                    if bool(state.done.all().cpu()):
                        break
                dt = time.perf_counter() - t0
                best = min(best, dt / max(total, 1))
            grid[b][s] = best
    return lut_from_grid(grid)


def measure_acceptance(engine, tparams, dparams, prompts: np.ndarray,
                       prompt_lens: np.ndarray, *, s: int = 8,
                       gen_tokens: int = 64, cache_len: int = 256,
                       ) -> List[int]:
    """Per-step accepted-run lengths (the l_i samples of paper Eq. 4)."""
    state = engine.prefill(tparams, dparams, prompts, prompt_lens, cache_len)
    runs: List[int] = []
    total = 0
    while total < gen_tokens * prompts.shape[0]:
        state, st = engine.step(tparams, dparams, state, s)
        runs.extend(int(a) for a in st.accepted)
        total += int(st.committed.sum())
        if bool(state.done.all().cpu()):
            break
    return runs


# ---------------------------------------------------------------------------
# the adaptive controller (execution stage + beyond-paper online refresh)


@dataclass
class AdaptiveController:
    """Serve-time speculation-length chooser.

    Paper behaviour: ``s = lut.lookup(batch_size)``.

    Beyond-paper (DESIGN §8.2): optionally tracks an EWMA of observed
    acceptance and rebuilds the LUT through the analytical model when the
    live acceptance drifts from the profiled c, gamma (e.g. the workload's
    draftability changed).  Disabled unless ``model`` is provided.
    """
    lut: SpeculationLUT
    model: Optional[LatencyModel] = None
    ewma_alpha: float = 0.05
    drift_threshold: float = 0.25
    s_max: int = 8
    # online state
    _ewma_accept: Optional[float] = None
    _profiled_accept: Optional[float] = None
    refreshes: int = 0

    def choose(self, batch_size: int) -> int:
        if batch_size <= 0:
            return 0
        return self.lut.lookup(batch_size)

    def observe(self, accepted: np.ndarray, s: int) -> None:
        """Feed per-request accepted counts from one step (optional)."""
        if self.model is None or s <= 0:
            return
        a = float(np.mean(accepted)) / max(s, 1)     # normalized acceptance
        if self._ewma_accept is None:
            self._ewma_accept = a
        else:
            self._ewma_accept += self.ewma_alpha * (a - self._ewma_accept)
        if self._profiled_accept is None:
            self._profiled_accept = min(self.model.l_of_s(s) / s, 1.0)
        drift = abs(self._ewma_accept - self._profiled_accept)
        if drift > self.drift_threshold:
            # rescale c so that l(s)/s matches the observed acceptance
            scale = max(self._ewma_accept, 1e-3) / max(self._profiled_accept, 1e-3)
            new_model = dataclasses.replace(self.model, c=self.model.c * scale)
            self.model = new_model
            self.lut = lut_from_model(new_model, self.s_max, self.lut.batch_sizes)
            self._profiled_accept = self._ewma_accept
            self.refreshes += 1


def fixed_controller(s: int, batch_sizes=(1, 2, 4, 8, 16, 32)) -> AdaptiveController:
    """Baseline: fixed speculation length for every batch size."""
    return AdaptiveController(lut=SpeculationLUT({b: s for b in batch_sizes}))
