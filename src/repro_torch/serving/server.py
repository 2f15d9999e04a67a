"""Server loop (paper §5.3): a message queue feeding a batched speculative
decoding engine.

Pending requests are merged into one batched request (up to ``max_batch``,
16 in the paper), the controller picks the speculation length for that batch
size, and the batch runs to completion before the next batch is formed.

Two execution backends:

  * :class:`EngineBackend` — drives a live
    :class:`~repro_torch.core.spec_decode.SpecDecodeEngine` and uses its
    wall-clock time (the paper's setup);
  * :class:`SimBackend` — discrete-event simulation from a fitted
    :class:`~repro_torch.core.analytical.LatencyModel` with stochastic
    acceptance.

Both backends answer ``run_batch(requests, s) -> (duration_s, BatchRecord)``;
the server's virtual clock advances by the returned duration, so the loop is
deterministic and backend-agnostic.  A copy of ``repro.serving.server``.

Iteration-level (continuous-batching) scheduling lives in
:mod:`repro_torch.serving.scheduler`: :func:`serve_continuous` below runs
that scheduler over the simulated step backend, and
:func:`~repro_torch.serving.scheduler.serve_continuous_live` runs the
identical scheduling code on a live engine's KV slot pool.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.adaptive import AdaptiveController
from repro_torch.core.analytical import LatencyModel
from repro_torch.serving.acceptance import GeometricAcceptance
from repro_torch.serving.request import BatchRecord, Request


# ---------------------------------------------------------------------------
# backends


class EngineBackend:
    """Wall-clock execution on a live SpecDecodeEngine.

    Batches are padded to the next power of two, the batch sizes the
    profile measured.  ``outputs`` maps each served request id to its
    generated tokens.
    """

    def __init__(self, engine, tparams, dparams, cache_len: int = 256):
        self.engine = engine
        self.tparams = tparams
        self.dparams = dparams
        self.cache_len = cache_len
        self._warm = set()
        self.outputs: Dict[int, np.ndarray] = {}

    @staticmethod
    def _pad_pow2(b: int) -> int:
        p = 1
        while p < b:
            p *= 2
        return p

    def run_batch(self, reqs: Sequence[Request], s: int) -> Tuple[float, BatchRecord]:
        b = len(reqs)
        B = self._pad_pow2(b)
        tp = max(max(r.prompt_len for r in reqs), 4)
        tokens = np.ones((B, tp), np.int32)
        lens = np.full((B,), 4, np.int32)
        for i, r in enumerate(reqs):
            tokens[i, :r.prompt_len] = r.tokens
            lens[i] = r.prompt_len
        max_new = max(r.max_new for r in reqs)
        # run this (B, prompt-shape, s) combination once outside the timed
        # region: serving latency is steady-state (the paper profiles before
        # deployment; first-call set-up must not contaminate comparisons)
        wkey = (B, tokens.shape[1], s)
        if wkey not in self._warm:
            state = self.engine.prefill(self.tparams, self.dparams, tokens,
                                        lens, self.cache_len)
            self.engine.step(self.tparams, self.dparams, state, s)
            self._warm.add(wkey)
        t0 = time.perf_counter()
        out, stats, n_steps = self.engine.generate(
            self.tparams, self.dparams, tokens, lens, s=s,
            cache_len=self.cache_len, max_new=max_new, collect_stats=True)
        dt = time.perf_counter() - t0
        for i, r in enumerate(reqs):
            self.outputs[r.rid] = out[i, :r.max_new]
        toks = b * max_new
        return dt, BatchRecord(start=0.0, duration=dt, batch_size=b, s_used=s,
                               tokens_generated=toks, n_steps=n_steps,
                               rids=tuple(r.rid for r in reqs))


class SimBackend:
    """Discrete-event simulation of batched speculative decoding.

    Per step at (b, s): duration t_L(b, s) + s * t_S(b, 1) from the latency
    model; each live request independently accepts a truncated-geometric
    number of drafts whose mean matches l(s) (the shared
    :class:`~repro_torch.serving.acceptance.GeometricAcceptance` process), then
    commits a + 1 tokens.
    """

    def __init__(self, model: LatencyModel, seed: int = 0):
        self.model = model
        self.acceptance = GeometricAcceptance(model, seed)

    def _batch_key(self, b: int) -> int:
        """Nearest profiled batch size >= b (clamped to the largest)."""
        bs = self.model.batch_sizes
        for x in bs:
            if x >= b:
                return x
        return bs[-1]

    def run_batch(self, reqs: Sequence[Request], s: int) -> Tuple[float, BatchRecord]:
        b = len(reqs)
        bk = self._batch_key(b)
        step_t = self.model.t_verify(bk, s) + s * self.model.t_s[bk]
        remaining = np.array([r.max_new for r in reqs], dtype=np.int64)
        n_steps, toks = 0, 0
        while remaining.max() > 0:
            accepted = self.acceptance.draw(b, s)
            commit = np.minimum(accepted + 1, np.maximum(remaining, 0))
            commit = np.where(remaining > 0, commit, 0)
            toks += int(commit.sum())
            remaining -= commit
            n_steps += 1
        return n_steps * step_t, BatchRecord(
            start=0.0, duration=n_steps * step_t, batch_size=b, s_used=s,
            tokens_generated=toks, n_steps=n_steps,
            rids=tuple(r.rid for r in reqs))


# ---------------------------------------------------------------------------
# the server


@dataclass
class ServeResult:
    requests: List[Request]
    batches: List[BatchRecord]
    # iteration-level schedulers attach their per-step StepTrace list here
    trace: Optional[list] = None

    @property
    def latencies(self) -> np.ndarray:
        return np.array([r.latency for r in self.requests])

    @property
    def mean_latency(self) -> float:
        return float(self.latencies.mean())


def serve_continuous(requests: Sequence[Request], model: LatencyModel,
                     controller: AdaptiveController, max_batch: int = 16,
                     seed: int = 0, policy=None,
                     telemetry=None) -> ServeResult:
    """Iteration-level (Orca-style) continuous batching x speculation,
    simulated from a fitted latency model: requests join and leave the
    running batch at speculative-step granularity and the controller
    re-chooses s every iteration from the current batch size.

    This is the :class:`~repro_torch.serving.scheduler.ContinuousScheduler`
    that drives the live engine, run over
    :class:`~repro_torch.serving.scheduler.SimStepBackend`.  ``telemetry``
    attaches a :class:`~repro_torch.serving.telemetry.Telemetry` hub.
    """
    from repro_torch.serving.scheduler import ContinuousScheduler, SimStepBackend
    backend = SimStepBackend(model, capacity=max_batch, seed=seed)
    sched = ContinuousScheduler(backend, controller, policy,
                                telemetry=telemetry)
    result = sched.run(requests)
    result.trace = sched.trace
    return result


def serve(requests: Sequence[Request], backend, controller: AdaptiveController,
          max_batch: int = 16) -> ServeResult:
    """Run the paper's server loop over a pre-generated request trace.

    The clock is virtual: it advances by each batch's execution duration (the
    backend decides whether that duration is wall-clock or simulated), so the
    same trace evaluates every comparison point reproducibly (§5.3:
    "we generate only one sequence of requests, which is used to evaluate all
    comparison points").
    """
    reqs = sorted(requests, key=lambda r: r.arrival)
    clock = 0.0
    i, n = 0, len(reqs)
    batches: List[BatchRecord] = []
    while i < n:
        if reqs[i].arrival > clock:
            clock = reqs[i].arrival           # idle until next arrival
        j = i
        while j < n and reqs[j].arrival <= clock and j - i < max_batch:
            j += 1
        batch = reqs[i:j]
        s = controller.choose(len(batch))
        duration, rec = backend.run_batch(batch, s)
        rec.start = clock
        for r in batch:
            r.start = clock
            r.finish = clock + duration
        clock += duration
        batches.append(rec)
        i = j
    return ServeResult(requests=list(reqs), batches=batches)
