"""Latency metrics & timeline grouping for the serving experiments (a copy
of ``repro.serving.metrics``)."""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.serving.server import ServeResult


@dataclass(frozen=True)
class LatencySummary:
    mean: float
    p50: float
    p90: float
    p99: float
    max: float
    n: int
    n_skipped: int = 0      # unfinished/rejected requests excluded upstream

    @staticmethod
    def of(latencies: Sequence[float], name: str = "latency",
           n_skipped: int = 0) -> "LatencySummary":
        a = np.asarray(latencies, dtype=np.float64)
        if a.size == 0:
            raise ValueError(
                f"LatencySummary.of: no '{name}' samples to summarize"
                + (f" ({n_skipped} unfinished/rejected requests skipped)"
                   if n_skipped else ""))
        return LatencySummary(
            mean=float(a.mean()), p50=float(np.percentile(a, 50)),
            p90=float(np.percentile(a, 90)), p99=float(np.percentile(a, 99)),
            max=float(a.max()), n=len(a), n_skipped=n_skipped)


def _finished(result: ServeResult) -> Tuple[List[Request], int]:
    """Requests with a recorded finish time, plus the skipped count.

    Runs that were interrupted (or that rejected requests) leave
    ``finish = None`` on some records.
    """
    done = [r for r in result.requests if r.finish is not None]
    return done, len(result.requests) - len(done)


def summarize(result: ServeResult) -> LatencySummary:
    done, skipped = _finished(result)
    return LatencySummary.of([r.latency for r in done], name="latency",
                             n_skipped=skipped)


def timeline_groups(result: ServeResult, group: int = 40,
                    ) -> List[Tuple[float, float]]:
    """Fig. 6 view: (timestamp of first request in group, mean latency of the
    group) for consecutive groups of ``group`` requests in arrival order.
    When the request count is not a multiple of ``group``, the tail
    remainder is emitted as a final partial group.  Unfinished/rejected requests are skipped (with a
    warning)."""
    done, skipped = _finished(result)
    if skipped:
        warnings.warn(f"timeline_groups: skipping {skipped} unfinished/"
                      f"rejected requests")
    reqs = sorted(done, key=lambda r: r.arrival)
    out = []
    for i in range(0, len(reqs), group):
        chunk = reqs[i:i + group]
        out.append((chunk[0].arrival, float(np.mean([r.latency for r in chunk]))))
    return out


def batch_size_histogram(result: ServeResult) -> Dict[int, int]:
    h: Dict[int, int] = {}
    for b in result.batches:
        h[b.batch_size] = h.get(b.batch_size, 0) + 1
    return h


def speedup(base: ServeResult, new: ServeResult) -> float:
    return base.mean_latency / new.mean_latency


# ---------------------------------------------------------------------------
# iteration-level (continuous batching) metrics: TTFT / ITL / occupancy
# — only schedulers that commit at step granularity fill these in


def ttft_summary(result: ServeResult) -> LatencySummary:
    """Time-to-first-token distribution (arrival -> first committed token)."""
    vals = [r.ttft for r in result.requests if r.ttft is not None]
    if not vals:
        raise ValueError("no per-request first-token times recorded "
                         "(run an iteration-level scheduler)")
    return LatencySummary.of(vals, name="ttft",
                             n_skipped=len(result.requests) - len(vals))


def itl_summary(result: ServeResult) -> LatencySummary:
    """Mean inter-token-latency distribution across requests."""
    vals = [r.itl for r in result.requests if r.itl is not None]
    if not vals:
        raise ValueError("no per-request inter-token latencies recorded")
    return LatencySummary.of(vals, name="itl",
                             n_skipped=len(result.requests) - len(vals))


def occupancy_timeline(result: ServeResult) -> List[Tuple[float, int]]:
    """(step start time, live batch size) per executed iteration."""
    return [(b.start, b.batch_size) for b in result.batches]


def mean_occupancy(result: ServeResult) -> float:
    """Time-weighted mean live batch size over the serving run."""
    if not result.batches:
        raise ValueError("mean_occupancy: no executed batches to average "
                         "over (empty ServeResult.batches)")
    num = sum(b.batch_size * b.duration for b in result.batches)
    den = sum(b.duration for b in result.batches)
    if den <= 0.0:
        raise ValueError("mean_occupancy: executed batches carry zero total "
                         "duration")
    return num / den


def goodput(result: ServeResult) -> float:
    """Committed tokens per second of makespan (first arrival to last
    finish), counting finished requests only."""
    done, _ = _finished(result)
    if not done:
        raise ValueError("goodput: no finished requests")
    t0 = min(r.arrival for r in result.requests)
    t1 = max(r.finish for r in done)
    if t1 <= t0:
        raise ValueError("goodput: zero makespan")
    return sum(r.n_generated for r in done) / (t1 - t0)


def admission_gaps(result: ServeResult) -> List[float]:
    """Per-iteration wall time of iterations that performed admission work
    (whole-prompt prefills or prefill chunks) while a decode batch was
    already running — i.e. the inter-token gap those admissions impose on
    every running request.

    ``StepTrace.occupancy`` is recorded *after* admission, so it counts
    the just-admitted slots themselves; an admission into an idle pool
    stalls nobody and must not count as a gap.  A request is "running"
    here once it has decoded in an earlier iteration.
    """
    if result.trace is None:
        raise ValueError("no StepTrace recorded "
                         "(run an iteration-level scheduler)")
    gaps = []
    seen_decoding: set = set()
    for t in result.trace:
        work = (sum(dt for dt in t.prefill_s if dt > 0)
                + sum(t.chunk_s))
        stalled = [rid for rid in t.rids if rid in seen_decoding]
        if work > 0 and stalled:
            gaps.append(t.duration + work)
        seen_decoding.update(t.rids)
    return gaps
