"""Request / completion records for the serving layer (paper §5.3).

Latency is measured exactly as the paper does: ``t_b - t_a`` where ``t_a`` is
the client send time and ``t_b`` the time the server finishes the request —
queueing time included.  A copy of ``repro.serving.request``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Request:
    rid: int
    arrival: float                 # t_a, seconds
    tokens: np.ndarray             # [Tp] prompt token ids
    prompt_len: int
    max_new: int = 128
    # filled in by the server
    start: Optional[float] = None        # batch execution start
    finish: Optional[float] = None       # t_b
    first_token: Optional[float] = None  # first committed token (TTFT end)
    n_generated: int = 0                 # tokens actually committed
    # chunked-prefill cursor: positions of the (prompt + stash) feed already
    # written into this request's slot.  0 while queued; advances as the
    # iteration-level scheduler feeds chunks; reset to 0 on preemption (a
    # re-admission re-prefills — chunked again if still over the budget).
    prefill_pos: int = 0

    @property
    def latency(self) -> float:
        assert self.finish is not None
        return self.finish - self.arrival

    @property
    def queue_wait(self) -> float:
        assert self.start is not None
        return self.start - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (iteration-level schedulers fill this in)."""
        return None if self.first_token is None else self.first_token - self.arrival

    @property
    def itl(self) -> Optional[float]:
        """Mean inter-token latency after the first token."""
        if self.first_token is None or self.finish is None or self.n_generated < 2:
            return None
        return (self.finish - self.first_token) / (self.n_generated - 1)


@dataclass
class BatchRecord:
    """One executed batch (for timelines and per-batch diagnostics)."""
    start: float
    duration: float
    batch_size: int
    s_used: int
    tokens_generated: int
    n_steps: int
    rids: tuple = ()

    @property
    def per_token_latency(self) -> float:
        return self.duration / max(self.tokens_generated, 1)
