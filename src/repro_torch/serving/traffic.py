"""Client-side traffic generation (paper §5.3).

Inter-arrival times are sampled from a Gamma distribution parameterised by
the mean interval and the coefficient of variation (CV):

    shape k = 1 / CV**2,   scale theta = mean * CV**2

so that E[X] = k * theta = mean and std/mean = CV.  CV = 1 recovers the
exponential (Poisson arrivals); CV > 1 is burstier, CV < 1 more regular.

The alternating generator reproduces Fig. 6's experiment: the client switches
between *intense* (interval 0.2 s) and *sparse* (interval 1.0 s) traffic every
50 seconds, CV fixed at 1.  A copy of ``repro.serving.traffic``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request


def gamma_intervals(n: int, mean: float, cv: float, rng: np.random.Generator,
                    ) -> np.ndarray:
    """n inter-arrival gaps with the paper's (mean, CV) parameterisation."""
    if mean <= 0:
        return np.zeros(n)
    shape = 1.0 / (cv * cv)
    scale = mean * cv * cv
    return rng.gamma(shape, scale, size=n)


@dataclass(frozen=True)
class TrafficPhase:
    mean_interval: float
    cv: float
    duration: float  # seconds this phase lasts; inf for a single-phase run


def arrival_times(n: int, phases: Sequence[TrafficPhase],
                  rng: np.random.Generator) -> np.ndarray:
    """Absolute arrival times for ``n`` requests walking through ``phases``
    cyclically (each phase lasts ``duration`` seconds of arrival time)."""
    out = np.empty(n)
    t = 0.0
    phase_idx, phase_t0 = 0, 0.0
    for i in range(n):
        ph = phases[phase_idx % len(phases)]
        gap = float(gamma_intervals(1, ph.mean_interval, ph.cv, rng)[0])
        t += gap
        while np.isfinite(ph.duration) and t - phase_t0 > ph.duration:
            phase_t0 += ph.duration
            phase_idx += 1
            ph = phases[phase_idx % len(phases)]
        out[i] = t
    return out


def synthetic_prompts(n: int, vocab: int, rng: np.random.Generator,
                      min_len: int = 8, max_len: int = 32) -> List[np.ndarray]:
    """Stand-in for the Chatbot-Instruction-Prompts sample: random-token
    prompts with the dataset's short-prompt length profile."""
    lens = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(0, vocab, size=int(L)).astype(np.int32) for L in lens]


def make_requests(n: int, phases: Sequence[TrafficPhase], vocab: int,
                  seed: int = 0, max_new: int = 128,
                  prompts: Optional[List[np.ndarray]] = None) -> List[Request]:
    rng = np.random.default_rng(seed)
    at = arrival_times(n, phases, rng)
    if prompts is None:
        prompts = synthetic_prompts(n, vocab, rng)
    return [Request(rid=i, arrival=float(at[i]), tokens=prompts[i % len(prompts)],
                    prompt_len=len(prompts[i % len(prompts)]), max_new=max_new)
            for i in range(n)]


def uniform_traffic(n: int, mean_interval: float, cv: float, vocab: int,
                    seed: int = 0, max_new: int = 128) -> List[Request]:
    return make_requests(n, [TrafficPhase(mean_interval, cv, float("inf"))],
                         vocab, seed, max_new)


def alternating_traffic(n: int, vocab: int, seed: int = 0,
                        intense: float = 0.2, sparse: float = 1.0,
                        period: float = 50.0, cv: float = 1.0,
                        max_new: int = 128) -> List[Request]:
    """Fig. 6: alternate intense/sparse every ``period`` seconds."""
    return make_requests(
        n, [TrafficPhase(intense, cv, period), TrafficPhase(sparse, cv, period)],
        vocab, seed, max_new)
