"""Analytical model of batched speculative decoding (paper §3.3).

The paper models total generation time for ``N`` tokens at batch size ``b``
and speculation length ``s`` as

    T(b, s) = N / (l(s) + 1) * (t_L(b, s) + s * t_S(b, 1))          (Eq. 7)

with two fitted ingredients:

  * acceptance curve  l(s) ~= c * s**gamma   (gamma < 1, sub-linear, Fig. 2)
  * verify latency    t_L(b, s) ~= alpha_b * s + beta                (Fig. 3)

and the monotonicity result (Eq. 11-12): the stationarity residual

    delta(b, s) = K * alpha_b * s**gamma - L * s**(gamma-1) + alpha_b
    K = (1 - gamma) * c,   L = c * beta * gamma

is increasing in both ``b`` (through alpha_b) and ``s``, hence the optimal
speculation length ``s_opt`` is non-increasing in ``b``.

Everything here is plain numpy (it runs at profiling time, not in the
serving path).  A copy of ``repro.core.analytical``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# acceptance curve l(s)


def acceptance_curve(run_lengths: Sequence[int], s_values: Sequence[int]) -> np.ndarray:
    """Empirical l(s) from per-prompt correct-run lengths (paper Eq. 4).

    ``run_lengths[i]`` is the number of leading draft tokens the target
    accepted for prompt i when the draft ran unconstrained; then
    l(s) ~= mean_i min(l_i, s).
    """
    li = np.asarray(run_lengths, dtype=np.float64)
    return np.array([np.mean(np.minimum(li, s)) for s in s_values])


def fit_power_law(s_values: Sequence[int], l_values: Sequence[float],
                  ) -> Tuple[float, float]:
    """Fit l(s) ~= c * s**gamma by least squares in log-log space.

    Returns (c, gamma).  Zero l-values are clamped to a small epsilon (they
    only occur when the draft never matches, where any fit is moot).
    """
    s = np.asarray(s_values, dtype=np.float64)
    l = np.maximum(np.asarray(l_values, dtype=np.float64), 1e-6)
    A = np.stack([np.ones_like(s), np.log(s)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.log(l), rcond=None)
    log_c, gamma = coef
    return float(np.exp(log_c)), float(gamma)


def power_law_r2(s_values, l_values, c: float, gamma: float) -> float:
    l = np.asarray(l_values, dtype=np.float64)
    pred = c * np.asarray(s_values, dtype=np.float64) ** gamma
    ss_res = float(np.sum((l - pred) ** 2))
    ss_tot = float(np.sum((l - l.mean()) ** 2))
    return 1.0 - ss_res / max(ss_tot, 1e-12)


# ---------------------------------------------------------------------------
# verify-latency curve t_L(b, s)


def fit_linear_latency(s_values: Sequence[int], t_values: Sequence[float],
                       ) -> Tuple[float, float]:
    """Fit t_L(s) ~= alpha * s + beta for one batch size.  Returns (alpha, beta)."""
    s = np.asarray(s_values, dtype=np.float64)
    t = np.asarray(t_values, dtype=np.float64)
    A = np.stack([s, np.ones_like(s)], axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    return float(coef[0]), float(coef[1])


# ---------------------------------------------------------------------------
# the full model


@dataclass(frozen=True)
class LatencyModel:
    """Fitted T(b, s) model for one (target, draft, hardware) triple.

    alpha/beta: per-batch-size linear verify-latency fits (seconds);
    t_s: per-batch-size draft per-token latency t_S(b, 1) (seconds);
    c/gamma: acceptance power law.
    """
    alpha: Mapping[int, float]
    beta: Mapping[int, float]
    t_s: Mapping[int, float]
    c: float
    gamma: float

    def l_of_s(self, s: float) -> float:
        return 0.0 if s <= 0 else self.c * float(s) ** self.gamma

    def t_verify(self, b: int, s: int) -> float:
        return self.alpha[b] * s + self.beta[b]

    def per_token_time(self, b: int, s: int) -> float:
        """Expected time per generated token (T / N), the paper's Eq. 8."""
        num = self.t_verify(b, s) + s * self.t_s[b]
        return num / (self.l_of_s(s) + 1.0)

    def total_time(self, N: int, b: int, s: int) -> float:
        return N * self.per_token_time(b, s)

    def s_opt(self, b: int, s_max: int = 8) -> int:
        """Integer grid minimiser of per-token time over s in 0..s_max."""
        times = [self.per_token_time(b, s) for s in range(0, s_max + 1)]
        return int(np.argmin(times))

    def delta(self, b: int, s: float) -> float:
        """Stationarity residual (Eq. 11) with the draft cost folded into
        alpha_b the way the paper does ("we merge it with alpha_b")."""
        a_b = self.alpha[b] + self.t_s[b]
        K = (1.0 - self.gamma) * self.c
        L = self.c * self.beta[b] * self.gamma
        return K * a_b * s ** self.gamma - L * s ** (self.gamma - 1.0) + a_b

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        return tuple(sorted(self.alpha))


def fit_latency_model(
    verify_times: Mapping[int, Mapping[int, float]],
    draft_times: Mapping[int, float],
    run_lengths: Sequence[int],
    s_fit_range: Sequence[int] = tuple(range(1, 9)),
) -> LatencyModel:
    """Build a :class:`LatencyModel` from raw profiling measurements.

    verify_times[b][s] = measured t_L(b, s) for one verify call (seconds);
    draft_times[b]     = measured draft per-token time t_S(b, 1);
    run_lengths        = per-prompt accepted-run lengths for the l(s) fit.
    """
    alpha: Dict[int, float] = {}
    beta: Dict[int, float] = {}
    for b, per_s in verify_times.items():
        ss = sorted(per_s)
        a_, b_ = fit_linear_latency(ss, [per_s[s] for s in ss])
        alpha[b] = max(a_, 1e-9)
        beta[b] = max(b_, 0.0)
    ls = acceptance_curve(run_lengths, list(s_fit_range))
    c, gamma = fit_power_law(list(s_fit_range), ls)
    # clamp into the paper's regime (sub-linear, non-negative)
    gamma = min(max(gamma, 1e-3), 0.999)
    return LatencyModel(alpha=alpha, beta=beta, t_s=dict(draft_times), c=c, gamma=gamma)


# ---------------------------------------------------------------------------
# roofline-driven analytical backend (beyond-paper: DESIGN §8.1)
#
# On hardware we do not have (the 256-chip v5e pod) the wall-clock profile is
# replaced by a roofline estimate: one verify step at (b, s) moves
# ``weight_bytes + cache_bytes(b)`` through HBM and performs
# ``2 * params * b * (s+1)`` FLOPs; its latency is the max of the three
# roofline terms.  The same b -> s_opt machinery then applies unchanged.


@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip peak numbers.  The defaults are the JAX package's TPU v5e
    figures, kept so that the copy computes what the original computes; a
    model of the H100 passes the card's own peaks."""
    peak_flops: float = 197e12        # bf16 FLOP/s
    hbm_bw: float = 819e9             # bytes/s
    ici_bw: float = 50e9              # bytes/s per link
    chips: int = 1

    def step_time(self, flops: float, bytes_hbm: float, bytes_coll: float = 0.0,
                  ) -> float:
        """Roofline latency of one step whose totals are given across all chips."""
        n = self.chips
        return max(flops / (n * self.peak_flops),
                   bytes_hbm / (n * self.hbm_bw),
                   bytes_coll / (n * self.ici_bw))


def roofline_latency_model(
    target_params: int, draft_params: int, hw: HardwareSpec,
    c: float, gamma: float,
    batch_sizes: Iterable[int] = (1, 2, 4, 8, 16, 32),
    bytes_per_param: int = 2,
    cache_bytes_per_seq: float = 0.0,
    collective_bytes_per_step: float = 0.0,
    s_max: int = 8,
) -> LatencyModel:
    """Analytical LatencyModel from parameter counts + hardware peaks.

    A verify step at (b, s) costs
      FLOPs      ~= 2 * target_params * b * (s + 1)
      HBM bytes  ~= target_params * bytes_per_param + b * cache_bytes_per_seq
    and a draft token costs the same with draft_params and s = 0.  alpha_b /
    beta are recovered by evaluating the roofline at s in {0..s_max} and
    fitting the same linear form the paper uses, so downstream code is
    identical for measured and analytical backends.
    """
    alpha: Dict[int, float] = {}
    beta: Dict[int, float] = {}
    t_s: Dict[int, float] = {}
    w_bytes = target_params * bytes_per_param
    dw_bytes = draft_params * bytes_per_param
    for b in batch_sizes:
        ss = list(range(0, s_max + 1))
        ts = [hw.step_time(2.0 * target_params * b * (s + 1),
                           w_bytes + b * cache_bytes_per_seq,
                           collective_bytes_per_step) for s in ss]
        a_, b_ = fit_linear_latency(ss, ts)
        alpha[b] = max(a_, 1e-12)
        beta[b] = max(b_, 1e-12)
        t_s[b] = hw.step_time(2.0 * draft_params * b,
                              dw_bytes + b * cache_bytes_per_seq * 0.1)
    return LatencyModel(alpha=alpha, beta=beta, t_s=t_s, c=c, gamma=gamma)
