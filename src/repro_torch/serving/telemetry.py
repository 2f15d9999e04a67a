"""Serving telemetry hub: phase-span tracing, the live (s, batch) acceptance
observatory, and pool/scheduler gauges for the continuous-batching runtime.
The port of ``repro.serving.telemetry``: the same phases, methods, event
and gauge names; ``start``/``stop`` drive ``torch.profiler``.

The hub is strictly **read-only observability**: it never touches the step
pipeline's decisions, so token outputs and the :class:`StepTrace` are
bit-identical with telemetry on or off (tests/test_torch_telemetry.py
enforces the contract on the live engine for the contiguous,
paged-under-preemption, chunked-admission and prefix-cache paths).  It is
also **zero-overhead when off**: the
scheduler only wires its hooks when an *enabled* hub is supplied — with
``enabled=False`` (or no hub at all) the hot path contains no telemetry
branches, no ``perf_counter`` calls, and no event construction.

Three instruments, one object:

* **Phase spans** — every iteration of the scheduler emits structured spans
  (``admit`` / ``prefill`` / ``chunk_continue`` / ``decode_verify`` /
  ``commit`` / ``preempt`` / ``retire``) with the seconds charged to each
  phase, buffered in memory and optionally streamed as a JSONL event log
  (``jsonl_path=``).  The seconds are host seconds: the hub adds no device
  synchronisation, and a step's seconds end in the step's own read of its
  commit counts.  On the device side,
  :class:`~repro_torch.core.spec_decode.SpecDecodeEngine` wraps each
  dispatch (step, B=1 prefill/chunk forwards, inject/retire writes) in a
  ``torch.profiler.record_function`` scope when ``engine.annotate`` is set,
  so a profiler trace (``profile_dir=``) attributes device time per phase
  (its ``gpu_user_annotation`` ranges).

* **The (s, batch) acceptance observatory** — per executed decode step the
  accepted-draft counts accumulate into histograms keyed by (chosen s, live
  decode batch size).  With an expected-acceptance callable attached
  (``attach_expected_acceptance``; the scheduler wires the controller's
  analytical model automatically when it has one), the observatory surfaces
  observed-vs-predicted acceptance drift per cell and in aggregate — the
  paper's l(s) model validated online rather than only at profile time.

* **Pool and scheduler gauges** — per-iteration snapshots of slot occupancy
  vs parked-PREFILLING count, backlog depth, block-pool free/used depth and
  free-list fragmentation, plus monotone counters for every span phase.
  :meth:`prometheus_text` renders a Prometheus-style text exposition;
  :meth:`dashboard` renders a console summary (printed every
  ``dashboard_every`` iterations when set).
"""
from __future__ import annotations

import json
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# the span taxonomy; scheduler hooks only ever emit these phases
PHASES = ("admit", "prefill", "chunk_continue", "decode_verify", "commit",
          "preempt", "retire")


class Telemetry:
    """Serving telemetry hub (see module docstring).

    Every recording method is a no-op when ``enabled=False`` — but the
    scheduler goes further and never calls them at all in that case, so a
    disabled hub costs exactly nothing on the hot path.

    ``profile_dir`` arms :meth:`start`/:meth:`stop` to wrap the serving run
    in a ``torch.profiler`` trace, exported as a Chrome trace into that
    directory (and implies ``annotate_device=True`` so the trace carries
    per-phase scopes); ``trace_path`` then names the trace.  ``jsonl_path`` streams every event as
    one JSON line at emit time; the in-memory ``events`` buffer always holds
    the same records (see :meth:`write_jsonl`).
    """

    def __init__(self, enabled: bool = True,
                 jsonl_path: Optional[str] = None,
                 dashboard_every: int = 0,
                 annotate_device: bool = False,
                 profile_dir: Optional[str] = None,
                 stream=None):
        self.enabled = bool(enabled)
        self.profile_dir = profile_dir
        self.annotate_device = bool(annotate_device or profile_dir)
        self.dashboard_every = int(dashboard_every)
        self.stream = stream
        self.events: List[dict] = []
        self.counters: Dict[str, int] = {}
        self.tokens_committed = 0
        self.iterations = 0
        self.gauges: Dict[str, float] = {}
        self.peaks: Dict[str, float] = {}
        # observatory cells: (s, batch) -> accumulators
        self._acc: Dict[Tuple[int, int], dict] = {}
        # s -> expected normalized acceptance (l(s) / s), if a model exists
        self.expected_acceptance: Optional[Callable[[int], float]] = None
        self._jsonl = open(jsonl_path, "w") if jsonl_path else None
        self._profiler = None
        self.trace_path: Optional[str] = None     # the Chrome trace stop() wrote

    # ------------------------------------------------------------------
    # recording hooks (called by the scheduler only when enabled)

    def _emit(self, ev: dict) -> None:
        self.events.append(ev)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(ev, default=float) + "\n")

    def span(self, phase: str, iteration: int, dt: float, **attrs) -> None:
        """Record one completed phase span: ``dt`` seconds charged to
        ``phase`` during scheduler iteration ``iteration``."""
        if not self.enabled:
            return
        self.counters[phase] = self.counters.get(phase, 0) + 1
        if phase == "commit":
            self.tokens_committed += int(attrs.get("tokens", 0))
        self._emit({"ev": "span", "phase": phase, "iter": int(iteration),
                    "dt": float(dt), **attrs})

    def observe_step(self, *, s: int, batch: int, accepted,
                     duration: float) -> None:
        """Feed one executed decode step into the acceptance observatory:
        per-row accepted-draft counts at (chosen s, decode batch size)."""
        if not self.enabled or s <= 0:
            return
        key = (int(s), int(batch))
        rec = self._acc.get(key)
        if rec is None:
            rec = self._acc[key] = {"hist": np.zeros(s + 1, np.int64),
                                    "draws": 0, "accepted": 0,
                                    "steps": 0, "time": 0.0}
        a = np.asarray(accepted, dtype=np.int64)
        np.add.at(rec["hist"], np.clip(a, 0, s), 1)
        rec["draws"] += int(a.size)
        rec["accepted"] += int(a.sum())
        rec["steps"] += 1
        rec["time"] += float(duration)

    def iteration(self, iteration: int, clock: float, **vals) -> None:
        """End-of-iteration gauge snapshot (occupancy, backlog, block pool,
        ...); also drives the periodic console dashboard."""
        if not self.enabled:
            return
        self.iterations += 1
        self.gauges.update(vals)
        self.gauges["clock"] = float(clock)
        for k in ("occupancy", "backlog", "used_blocks", "prefilling",
                  "grid_occupancy"):
            if k in vals:
                self.peaks[k] = max(self.peaks.get(k, 0), vals[k])
        self._emit({"ev": "gauges", "iter": int(iteration),
                    "clock": float(clock), **vals})
        if self.dashboard_every and self.iterations % self.dashboard_every == 0:
            print(self.dashboard(), file=self.stream or sys.stdout, flush=True)

    def attach_expected_acceptance(self, fn: Callable[[int], float]) -> None:
        """Attach ``s -> expected normalized acceptance`` (typically
        ``model.l_of_s(s) / s``); enables the drift gauge."""
        self.expected_acceptance = fn

    # ------------------------------------------------------------------
    # observatory views

    def acceptance_table(self) -> List[dict]:
        """One row per observed (s, batch) cell: accepted-token histogram,
        observed normalized acceptance, and — with an expected-acceptance
        model attached — the observed-minus-predicted drift."""
        rows = []
        for (s, b) in sorted(self._acc):
            rec = self._acc[(s, b)]
            observed = (rec["accepted"] / (rec["draws"] * s)
                        if rec["draws"] else None)
            expected = (min(float(self.expected_acceptance(s)), 1.0)
                        if self.expected_acceptance is not None else None)
            drift = (observed - expected
                     if observed is not None and expected is not None
                     else None)
            rows.append({
                "s": s, "batch": b, "steps": rec["steps"],
                "draws": rec["draws"],
                "mean_accepted": rec["accepted"] / max(rec["draws"], 1),
                "acceptance": observed, "expected": expected, "drift": drift,
                "hist": rec["hist"].tolist(),
                "mean_step_s": rec["time"] / max(rec["steps"], 1),
            })
        return rows

    def acceptance_drift(self) -> Optional[float]:
        """Draw-weighted mean observed-minus-predicted acceptance across all
        (s, batch) cells; None without a model or without observations."""
        num = den = 0.0
        for row in self.acceptance_table():
            if row["drift"] is not None:
                num += row["drift"] * row["draws"]
                den += row["draws"]
        return num / den if den else None

    # ------------------------------------------------------------------
    # expositions

    def prometheus_text(self) -> str:
        """Prometheus text exposition of counters, gauges, peaks, and the
        per-(s, batch) acceptance observatory."""
        out = ["# TYPE repro_serving_spans_total counter"]
        for phase in sorted(self.counters):
            out.append(f'repro_serving_spans_total{{phase="{phase}"}} '
                       f"{self.counters[phase]}")
        out.append("# TYPE repro_serving_tokens_committed_total counter")
        out.append(f"repro_serving_tokens_committed_total "
                   f"{self.tokens_committed}")
        out.append("# TYPE repro_serving_iterations_total counter")
        out.append(f"repro_serving_iterations_total {self.iterations}")
        for name in sorted(self.gauges):
            out.append(f"# TYPE repro_serving_{name} gauge")
            out.append(f"repro_serving_{name} {self.gauges[name]}")
        for name in sorted(self.peaks):
            out.append(f"# TYPE repro_serving_peak_{name} gauge")
            out.append(f"repro_serving_peak_{name} {self.peaks[name]}")
        acc = self.acceptance_table()
        if acc:
            out.append("# TYPE repro_serving_acceptance_observed gauge")
            for r in acc:
                if r["acceptance"] is not None:
                    out.append(
                        f'repro_serving_acceptance_observed{{s="{r["s"]}",'
                        f'batch="{r["batch"]}"}} {r["acceptance"]:.6f}')
            if any(r["drift"] is not None for r in acc):
                out.append("# TYPE repro_serving_acceptance_drift gauge")
                for r in acc:
                    if r["drift"] is not None:
                        out.append(
                            f'repro_serving_acceptance_drift{{s="{r["s"]}",'
                            f'batch="{r["batch"]}"}} {r["drift"]:+.6f}')
            out.append("# TYPE repro_serving_step_seconds gauge")
            for r in acc:
                out.append(f'repro_serving_step_seconds{{s="{r["s"]}",'
                           f'batch="{r["batch"]}"}} {r["mean_step_s"]:.6g}')
        return "\n".join(out) + "\n"

    def dashboard(self) -> str:
        """Multi-line console summary of the latest gauges, counters, and
        the busiest acceptance cells."""
        g = self.gauges
        lines = [f"── serving telemetry · iter {self.iterations} · "
                 f"clock {g.get('clock', 0.0):.3f}s ──"]
        occ = g.get("occupancy", 0)
        cap = g.get("capacity", "?")
        lines.append(
            f" slots {occ}/{cap} occupied · {g.get('prefilling', 0)} "
            f"prefilling · backlog {g.get('backlog', 0)} · decode batch "
            f"{g.get('decode_batch', 0)} (s={g.get('s', 0)})")
        if "free_blocks" in g:
            lines.append(
                f" blocks {g['free_blocks']} free / {g.get('used_blocks', 0)}"
                f" used · fragmentation {g.get('fragmentation', 0.0):.2f}"
                f" · grid occupancy {g.get('grid_occupancy', 0.0):.2f}")
        cnt = " ".join(f"{k}={v}" for k, v in sorted(self.counters.items()))
        lines.append(f" counters: {cnt or '(none)'} · tokens "
                     f"{self.tokens_committed}")
        acc = sorted(self.acceptance_table(), key=lambda r: -r["draws"])[:3]
        for r in acc:
            drift = ("" if r["drift"] is None
                     else f", drift {r['drift']:+.3f}")
            lines.append(
                f" acceptance s={r['s']} b={r['batch']}: "
                f"{r['acceptance']:.3f} over {r['draws']} draws{drift}")
        return "\n".join(lines)

    def summary(self) -> dict:
        """JSON-friendly roll-up (the serving benchmark embeds this)."""
        return {
            "iterations": self.iterations,
            "tokens_committed": self.tokens_committed,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "peaks": dict(self.peaks),
            "acceptance": self.acceptance_table(),
            "acceptance_drift": self.acceptance_drift(),
        }

    # ------------------------------------------------------------------
    # persistence / profiler lifecycle

    def write_jsonl(self, path: str) -> None:
        """Dump the buffered event log to ``path`` (one JSON per line)."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, default=float) + "\n")

    def start(self, device: str = "cpu") -> None:
        """Begin a ``torch.profiler`` trace when ``profile_dir`` is set
        (no-op otherwise), with the CUDA activity when ``device`` is
        ``"cuda"``; the serving entry points call this around the run."""
        if self.enabled and self.profile_dir and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()

    def stop(self) -> None:
        """End the trace and export it as ``trace.json`` (Chrome format)
        into ``profile_dir``; flush the JSONL stream."""
        if self._profiler is not None:
            prof, self._profiler = self._profiler, None
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            self.trace_path = os.path.join(self.profile_dir, "trace.json")
            prof.export_chrome_trace(self.trace_path)
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        self.stop()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
