"""Stochastic acceptance shared by every simulation path (paper Eq. 4).

The simulated acceptance process is a truncated geometric: each of the ``s``
draft positions is independently "correct" with probability ``p``, and the
accepted run is the number of leading correct drafts.  ``p`` is chosen so the
*expected* run length matches the fitted acceptance curve l(s), i.e. it
inverts  sum_{i=1..s} p^i = l(s).

One :class:`GeometricAcceptance` instance owns the rng and the per-``s``
``p`` cache; :class:`~repro_torch.serving.server.SimBackend` draws from it.
A copy of ``repro.serving.acceptance``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.analytical import LatencyModel


def match_prob(l_target: float, s: int) -> float:
    """p such that the truncated-geometric expected run sum_{i=1..s} p^i
    equals ``l_target``."""
    l_target = min(max(l_target, 0.0), s - 1e-9)
    lo, hi = 0.0, 1.0 - 1e-12
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        val = sum(mid ** i for i in range(1, s + 1))
        if val < l_target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


class GeometricAcceptance:
    """rng + p-cache for truncated-geometric acceptance draws."""

    def __init__(self, model: LatencyModel, seed: int = 0):
        self.model = model
        self.rng = np.random.default_rng(seed)
        self._p_cache: Dict[int, float] = {}

    def p(self, s: int) -> float:
        if s not in self._p_cache:
            self._p_cache[s] = match_prob(self.model.l_of_s(s), s)
        return self._p_cache[s]

    def draw(self, b: int, s: int) -> np.ndarray:
        """Accepted-run lengths for ``b`` live requests at speculation ``s``."""
        if s <= 0:
            return np.zeros(b, dtype=np.int64)
        u = self.rng.random((b, s))
        return (np.cumprod(u < self.p(s), axis=1)).sum(axis=1)
