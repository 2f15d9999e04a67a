"""Iteration-level (Orca-style) continuous-batching scheduler: the port of
``repro.serving.scheduler``.

Requests JOIN and LEAVE the running batch at *speculative-step* granularity:
every iteration the scheduler (1) admits arrived requests into free KV slots
via a pluggable :class:`AdmissionPolicy`, (2) asks the
:class:`~repro_torch.core.adaptive.AdaptiveController` for the speculation
length at the **live occupancy** — the finest-grained use of the paper's
b -> s_opt LUT — and (3) runs one speculative step, retiring finished
slots.

Two step backends answer the same protocol, so the identical scheduling code
runs against the card and against the fitted simulation:

  * :class:`ContinuousEngineBackend` — a live
    :class:`~repro_torch.core.spec_decode.SpecDecodeEngine` slot pool
    (``prefill_into`` / masked step / ``retire_slot``), wall-clock timed
    with kernel builds done outside the timed regions;
  * :class:`SimStepBackend` — one discrete-event step from a fitted
    :class:`~repro_torch.core.analytical.LatencyModel` with the shared
    truncated-geometric acceptance process (serving/acceptance.py).

Paged KV + preemption: when the engine slot pool is paged, the scheduler
also (a) admits by block feasibility, (b) hard-rejects requests whose
worst-case footprint (prompt + max_new + the controller's speculation
ceiling) exceeds the per-request capacity, and (c) preempts under memory
pressure: if covering this step's worst-case commit (s+1 tokens per live
slot) could exhaust the free list, the victim with the longest remaining
budget (ties: most recently admitted) is evicted back to the backlog and
later re-prefilled from prompt + its generated-token stash.  Preemptions
are recorded in :class:`StepTrace`; they are pure functions of the block
accounting, so a :class:`SimStepBackend` built with the same pool geometry
re-derives them during replay.

The ``run`` loop is the JAX loop without the prefix-cache and telemetry
branches, so StepTraces agree by construction.  Chunked prefill runs on
both backends: with a :class:`PrefillBudgetAdmit` policy the live backend
feeds long prompts in budgeted chunks between speculative steps
(``SpecDecodeEngine.prefill_chunk_into``; K1 over a ring, K3 over a paged
pool).  A Mamba-2 target has no chunked prefill (``can_chunk`` is false),
so the policy falls back to whole-prompt budgeting there, as it does in
JAX on a chunk-incapable backend.  On a paged pool,
``mixed_launch=True`` defers every non-final chunk's forward into the next
speculative step (``SpecDecodeEngine.step_with_chunk``: the chunk's rows
ride the verify's K3 call, once per layer); the host bookkeeping still
runs at feed time, so the StepTrace is the one of the run without it.  The
prefix cache, sharded pools and the telemetry hub are not ported (ROADMAP
queue 1, items 10, 14 and 11) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptiveController
from repro_torch.core.analytical import LatencyModel
from repro_torch.core.spec_decode import S_MAX
from repro_torch.serving.acceptance import GeometricAcceptance
from repro_torch.serving.request import BatchRecord, Request
from repro_torch.serving.slots import PagedKVTables, SlotPool


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


# ---------------------------------------------------------------------------
# admission policies


class AdmissionPolicy:
    """Chooses which backlog requests to admit into free slots this step.

    Protocol contract (every policy must honour it):

    * ``backlog`` is the FCFS-ordered list of arrived, not-yet-admitted
      requests (a re-admitted preemption victim sits at the head).  The
      policy must treat it as read-only — the scheduler removes admitted
      requests itself.
    * ``free_slots`` is the number of currently claimable slots;
      ``clock`` is the scheduler's virtual time in seconds (policies may
      use it for deadline/aging decisions).
    * Returns the requests to admit this iteration, in admission order, a
      subset of ``backlog`` with ``len(result) <= free_slots``.  Returning
      a request not in ``backlog`` is a protocol violation.
    * The policy only *selects*; feasibility is the scheduler's job.  The
      scheduler may admit fewer than selected (KV-block feasibility,
      oversize rejection), and on a chunk-capable backend a
      :class:`PrefillBudgetAdmit` policy's budget/chunk attributes are read
      directly by the scheduler instead of :meth:`select` (see that class).
    * Policies may keep internal state across calls (e.g. deferral
      counters); the scheduler instantiates one policy per run.
    """

    def select(self, backlog: Sequence[Request], free_slots: int,
               clock: float) -> List[Request]:
        raise NotImplementedError


class ImmediateAdmit(AdmissionPolicy):
    """Admit FCFS into every free slot (Orca-style, the default)."""

    def select(self, backlog, free_slots, clock):
        return list(backlog[:free_slots])


class PrefillBudgetAdmit(AdmissionPolicy):
    """Chunked-prefill-style admission: cap the prefill tokens injected per
    iteration so admission work cannot starve the running batch (bounds the
    inter-token latency hit of each admission burst; SNIPPETS §2).

    ``chunk`` (default: the budget) is the fixed chunk size used when the
    scheduler runs a chunk-capable backend: a prompt longer than the
    remaining budget is then admitted chunked — never as a whole-prompt
    burst — and continues across iterations.  On a backend without chunk
    support, :meth:`select` falls back to whole-prompt budgeting: an
    over-budget head prompt waits (without blocking smaller backlog
    requests that still fit this step's budget) but only for at most
    ``max_defer`` iterations — after that it is admitted whole so a steady
    stream of small prompts cannot starve it forever — and when nothing
    fits at all the head is admitted whole immediately (no deadlock).
    """

    def __init__(self, token_budget: int = 64, chunk: Optional[int] = None,
                 max_defer: int = 16):
        if token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.token_budget = token_budget
        self.chunk_tokens = token_budget if chunk is None else chunk
        if self.chunk_tokens < 1:
            raise ValueError("chunk must be >= 1")
        self.max_defer = max_defer
        self._deferred: Dict[int, int] = {}    # rid -> times passed over

    def select(self, backlog, free_slots, clock):
        out: List[Request] = []
        used = 0
        for req in backlog:
            if len(out) >= free_slots or used >= self.token_budget:
                break                  # nothing else can fit this step
            if used + req.prompt_len > self.token_budget:
                skips = self._deferred.get(req.rid, 0) + 1
                if skips > self.max_defer and not out:
                    # aging escape: a chronically deferred prompt bursts
                    # whole rather than being starved by a steady stream
                    # of smaller fits (chunk-capable backends never get
                    # here — the scheduler admits it chunked instead)
                    self._deferred.pop(req.rid, None)
                    out.append(req)
                    used += req.prompt_len
                    continue
                # over budget this step: wait — but do not block smaller
                # backlog requests that still fit (the head-of-line fix)
                self._deferred[req.rid] = skips
                continue
            out.append(req)
            used += req.prompt_len
            self._deferred.pop(req.rid, None)
        if not out and backlog and free_slots > 0:
            # nothing fits the budget at all: whole-prompt fallback so the
            # policy never deadlocks
            req = backlog[0]
            self._deferred.pop(req.rid, None)
            out.append(req)
        return out


class FCFSBacklog(AdmissionPolicy):
    """At most ``max_per_step`` admissions per iteration (rate-limited FCFS,
    the gentlest admission schedule)."""

    def __init__(self, max_per_step: int = 1):
        self.max_per_step = max_per_step

    def select(self, backlog, free_slots, clock):
        return list(backlog[:min(free_slots, self.max_per_step)])


class HostShardQueue:
    """Per-host admission queue for a mesh-sharded slot pool.  Nothing in
    the port reaches it yet: its pools are not sharded (ROADMAP queue 1,
    item 14), so ``ContinuousScheduler.run`` claims slots from the pool
    directly.  It is kept, with the JAX package's behaviour, for that slice.

    A slot pool sharded over ``n_shards`` data shards places slot rows in
    contiguous ranges — shard ``i`` (one serving host's devices in a
    multi-host deployment) owns slots ``[i * capacity/n, (i+1) *
    capacity/n)``, exactly the layout a NamedSharding gives the capacity
    axis.  This queue claims slots ROUND-ROBIN across those ranges (lowest
    free slot within the chosen shard), so admissions spread evenly over
    the shards instead of filling shard 0 first — every host carries an
    even share of the live batch and of the per-step KV writes.

    It deliberately does NOT reorder admissions: the scheduler admits in
    the same FCFS order with or without a mesh, which is what keeps the
    sharded StepTrace identical to the single-device one (rids, commits,
    preemptions are all slot-number-free).
    """

    def __init__(self, capacity: int, n_shards: int):
        if n_shards < 1 or capacity % n_shards != 0:
            raise ValueError(
                f"capacity {capacity} does not split into {n_shards} "
                f"equal shard ranges")
        self.n_shards = n_shards
        self.per_shard = capacity // n_shards
        self._next = 0                 # round-robin cursor

    def claim(self, pool: SlotPool, req: Request) -> int:
        """Claim a slot for ``req``, round-robining across shard ranges.

        Starts at the cursor and takes the first shard with a free slot
        (lowest slot id within it), then advances the cursor past that
        shard.  Deterministic: a pure function of the pool's free set and
        the claim history.
        """
        for k in range(self.n_shards):
            sh = (self._next + k) % self.n_shards
            lo = sh * self.per_shard
            for slot in range(lo, lo + self.per_shard):
                if pool.is_free(slot):
                    self._next = (sh + 1) % self.n_shards
                    return pool.claim(req, slot=slot)
        raise RuntimeError("slot pool full")


# ---------------------------------------------------------------------------
# step backends


def controller_s_cap(controller) -> int:
    """Largest speculation length ``controller`` can ever choose.

    This — not the global S_MAX — is the right worst-case reservation unit
    for admission and KV-overflow checks: one speculative step commits at
    most ``s + 1`` tokens, so every "can this request still fit its KV
    budget" bound is of the form ``prompt + max_new + s_cap``, and a
    controller capped below S_MAX can serve requests the S_MAX bound would
    wrongly reject.

    Derivation: the max over the controller's LUT entries, raised to
    ``controller.s_max`` when an online acceptance model may rebuild LUT
    entries upward, clamped to the engine's hard S_MAX (the ``out``-buffer
    headroom).  Controllers without a LUT (e.g. ad-hoc stubs) conservatively
    get S_MAX.
    """
    try:
        cap = max(controller.lut.table.values())
    except (AttributeError, ValueError):
        return S_MAX
    if getattr(controller, "model", None) is not None:
        # online LUT refresh may rebuild entries up to controller.s_max
        cap = max(cap, getattr(controller, "s_max", S_MAX))
    return min(int(cap), S_MAX)


def _reject_oversize(req: Request, max_context: int,
                     s_cap: int = S_MAX) -> None:
    """Hard admission bound: a request whose worst-case KV footprint exceeds
    the per-request capacity can never be served — deferring it would spin
    forever, and admitting it would silently wrap the ring / overrun the
    block table and corrupt the KV (the PR-1 bug this check closes).
    ``s_cap`` is the scheduler's speculation ceiling (one step can overshoot
    ``max_new`` by at most that many tokens)."""
    if req.prompt_len + req.max_new + s_cap > max_context:
        raise ValueError(
            f"request {req.rid}: prompt_len={req.prompt_len} + "
            f"max_new={req.max_new} + s_cap={s_cap} exceeds the per-request "
            f"KV capacity {max_context}; the KV ring would wrap and corrupt "
            f"itself")


class ContinuousEngineBackend:
    """Live-engine step backend: a SpecDecodeEngine slot pool on the card.

    The kernels are built and loaded outside the timed regions (``warm_s``,
    and on the first prefill or chunk of each bucket), so serving latency is
    steady-state, as EngineBackend's is.  Each timed region ends in a fence:
    ``torch.cuda.synchronize()`` after a prefill or a chunk, and the engine
    step's own ``.cpu()`` read of the commit counts.

    With ``block_size`` set, the engine slot pool is the paged KV block pool
    (``self.kv`` holds its host free list / block tables) and the scheduler
    gains admission feasibility checks and preemption under memory pressure.
    A preempted request's generated tokens are stashed host-side; on
    re-admission it re-prefills from prompt + stash (recompute-style
    restore) and greedy decoding continues exactly where it left off.

    ``mixed_launch=True`` (paged only) defers each non-final chunk's
    forward: its host bookkeeping runs when it is fed, and the forward
    rides the next speculative step (the mixed verify+chunk launch).  Every
    other consumer of the pool first sends the deferred chunk on its own,
    so at most one chunk is ever in flight.
    """

    def __init__(self, engine, tparams, dparams, capacity: int,
                 cache_len: int = 256, warm_s: Sequence[int] = (),
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 collect_outputs: bool = False,
                 s_cap: int = S_MAX,
                 mesh=None,
                 prefix_cache: bool = False,
                 mixed_launch: bool = False):
        if mesh is not None:
            raise _not_ported("a mesh-sharded slot pool", 14)
        if prefix_cache:
            raise _not_ported("the prefix cache", 10)
        self.engine = engine
        self.tparams = tparams
        self.dparams = dparams
        self.capacity = capacity
        self.s_cap = s_cap
        self.state = engine.init_slots(capacity, cache_len,
                                       block_size=block_size,
                                       num_blocks=num_blocks)
        self.kv = self.state.paged               # None => contiguous rings
        self.cache_len = (self.kv.logical_len if self.kv is not None
                          else cache_len)
        self.collect_outputs = collect_outputs
        self.outputs: Dict[int, np.ndarray] = {}   # rid -> generated tokens
        self._stash: Dict[int, np.ndarray] = {}    # rid -> pre-preempt tokens
        self._warm_prefill: set = set()
        self._warm_chunk: set = set()
        self._warm_step: set = set()
        self.mixed_launch = mixed_launch
        self._deferred = None            # Optional[DeferredChunk]
        self._flush_s = 0.0              # flush seconds no timed region covered
        if mixed_launch and self.kv is None:
            raise ValueError(
                "mixed_launch=True needs a paged KV pool (block_size): "
                "the fused launch rides the ragged paged kernel")
        for s in warm_s:
            self.warm_step(s)

    @property
    def max_context(self) -> int:
        """Per-request KV capacity in tokens (admission hard limit)."""
        return self.cache_len

    @property
    def can_chunk(self) -> bool:
        """Whether the engine's model pair supports chunked prefill."""
        eng = self.engine
        return (hasattr(eng.target, "prefill_chunk")
                and (eng.draft is None
                     or hasattr(eng.draft, "prefill_chunk")))

    def warm_step(self, s: int) -> None:
        if s not in self._warm_step:
            self.engine.step(self.tparams, self.dparams, self.state, s,
                             warm=True)
            self._warm_step.add(s)

    def _fence(self) -> None:
        """Wait for the card, so the host clock covers the queued work."""
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _flush_deferred(self) -> float:
        """Run the deferred chunk's forward on its own, if one is pending,
        and return its seconds (fenced; 0 when none was pending).  Called
        before every other consumer of the pool (prefill, chunk, preempt,
        retire, output reads): the deferred forward must land before
        anything else reads or writes the pool.  A prefill or a chunk runs
        it inside its own timed region; preempt, retire and output reads
        have none, so their flush seconds go to the next step's time: the
        eager forward costs the host as much as a chunk does, and the
        virtual clock must not lose it."""
        if self._deferred is None:
            return 0.0
        chunk, self._deferred = self._deferred, None
        t0 = time.perf_counter()
        self.state = self.engine.flush_chunk(self.tparams, self.dparams,
                                             self.state, chunk)
        self._fence()
        return time.perf_counter() - t0

    def _bucket(self, n: int) -> int:
        p = 4
        while p < n:
            p *= 2
        return min(p, self.cache_len)   # never wider than the KV capacity

    def _full_prompt(self, req: Request) -> np.ndarray:
        """Prompt plus any tokens generated before a preemption."""
        stash = self._stash.get(req.rid)
        if stash is None:
            return np.asarray(req.tokens[:req.prompt_len], np.int32)
        return np.concatenate(
            [np.asarray(req.tokens[:req.prompt_len], np.int32), stash])

    def prefill(self, req: Request, slot: int) -> float:
        """Inject ``req`` into ``slot``; returns seconds of prefill work."""
        _reject_oversize(req, self.max_context, self.s_cap)  # defense in depth
        prompt = self._full_prompt(req)
        plen = len(prompt)
        P = self._bucket(plen)
        toks = np.ones((P,), np.int32)
        toks[:plen] = prompt
        if P not in self._warm_prefill:
            # load the kernels for this bucket off the clock
            self.engine.prefill_into(self.tparams, self.dparams, self.state,
                                     slot, toks, plen, self.cache_len,
                                     warm=True)
            self._warm_prefill.add(P)
        t0 = time.perf_counter()
        self._flush_deferred()
        self.state = self.engine.prefill_into(
            self.tparams, self.dparams, self.state, slot, toks,
            plen, self.cache_len)
        self._fence()
        return time.perf_counter() - t0

    def prefill_chunk(self, req: Request, slot: int, start: int,
                      n: int) -> float:
        """Feed feed-positions ``[start, start + n)`` of ``req``'s prompt
        (+ pre-preemption stash) into ``slot``; returns seconds.

        The feed spans ``len(prompt) - 1`` positions (the last token is
        written by the slot's first decode step, exactly like whole-prompt
        prefill); the chunk carrying the final position also commits the
        slot into the decode batch.
        """
        if start == 0:
            _reject_oversize(req, self.max_context, self.s_cap)
        prompt = self._full_prompt(req)
        total_len = len(prompt)
        CB = self._bucket(n)
        toks = np.ones((CB,), np.int32)
        toks[:n] = prompt[start:start + n]
        final = start + n == total_len - 1
        if CB not in self._warm_chunk:
            # load the kernels for this bucket off the clock
            self.engine.prefill_chunk_into(
                self.tparams, self.dparams, self.state, slot,
                np.ones((CB,), np.int32), 0, CB, CB + 2, warm=True)
            self._warm_chunk.add(CB)
        t0 = time.perf_counter()
        self._flush_deferred()
        if self.mixed_launch and not final:
            # the host bookkeeping runs now (block accounting and admission
            # are unchanged); the forward rides the next speculative step,
            # or a flush, whichever consumer of the pool comes first
            self.state, self._deferred = self.engine.prefill_chunk_into(
                self.tparams, self.dparams, self.state, slot, toks, start, n,
                total_len, defer=True)
            return time.perf_counter() - t0
        self.state = self.engine.prefill_chunk_into(
            self.tparams, self.dparams, self.state, slot, toks, start, n,
            total_len, last2=prompt[-2:] if final else None)
        self._fence()
        return time.perf_counter() - t0

    def step(self, s: int) -> Tuple[float, np.ndarray, np.ndarray]:
        """One speculative step at live occupancy.  Returns
        (wall seconds, committed[capacity], done[capacity]).  With a
        deferred chunk pending, the step is the mixed verify+chunk launch
        (``step_with_chunk``)."""
        self.warm_step(s)
        chunk, self._deferred = self._deferred, None
        t0 = time.perf_counter()
        if chunk is not None:
            self.state, st = self.engine.step_with_chunk(
                self.tparams, self.dparams, self.state, s, chunk)
        else:
            self.state, st = self.engine.step(self.tparams, self.dparams,
                                              self.state, s)
        committed = st.committed      # read on the host inside the step
        dt = time.perf_counter() - t0 + self._flush_s
        self._flush_s = 0.0
        return dt, committed, self.state.done.cpu().numpy()

    def preempt(self, slot: int, req: Request) -> None:
        """Evict ``req`` under memory pressure: stash its generated tokens,
        free the slot's KV blocks, and mark the row done."""
        self._flush_s += self._flush_deferred()
        dev_n = int(self.state.n_generated[slot].cpu())
        fresh = self.state.out[slot, :dev_n].cpu().numpy().astype(np.int32)
        old = self._stash.get(req.rid)
        self._stash[req.rid] = (fresh if old is None
                                else np.concatenate([old, fresh]))
        self.state = self.engine.retire_slot(self.state, slot)

    def retire(self, slot: int, req: Optional[Request] = None) -> None:
        self._flush_s += self._flush_deferred()
        if req is not None:
            if self.collect_outputs:
                # stitch ever-preempted requests now, before the slot (and
                # its out row) is recycled
                self.outputs[req.rid] = self.output_for(slot, req)
            # always drop the stash: keeping it for callers who opted out of
            # output collection would leak memory on long-lived backends
            self._stash.pop(req.rid, None)
        self.state = self.engine.retire_slot(self.state, slot)

    def output_for(self, slot: int, req: Optional[Request] = None) -> np.ndarray:
        """Generated tokens of the request in ``slot``.

        With ``req`` given, the result is truncated to ``req.n_generated``
        (a request with a smaller ``max_new`` than the engine's must not
        surface tokens past its budget) and stitched with any pre-preemption
        stash; without it, the engine-sized row is returned.
        """
        self._flush_s += self._flush_deferred()
        out = self.state.out[slot].cpu().numpy()
        if req is None:
            return out[:self.engine.max_new]
        stash = self._stash.get(req.rid)
        if stash is None:
            return out[:req.n_generated].astype(np.int32)
        cont = out[:req.n_generated - len(stash)].astype(np.int32)
        return np.concatenate([stash, cont])


class SimStepBackend:
    """Discrete-event step backend over a fitted LatencyModel.

    Step duration at live occupancy b is t_L(bk, s) + s * t_S(bk, 1) with bk
    the nearest profiled batch size >= b; acceptance is the shared
    truncated-geometric process — or, for sim-vs-live parity tests, a
    replayed ``accept_source(step_idx, rids, s) -> accepted`` trace.
    """

    can_chunk = True

    def __init__(self, model: LatencyModel, capacity: int, seed: int = 0,
                 accept_source: Optional[Callable] = None,
                 duration_source: Optional[Callable] = None,
                 prefill_source: Optional[Callable] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_context: int = 256,
                 done_source: Optional[Callable] = None,
                 chunk_source: Optional[Callable] = None,
                 prefix_cache: bool = False,
                 prefill_token_cost: float = 0.0):
        if prefix_cache:
            raise _not_ported("the prefix cache", 10)
        self.model = model
        self.capacity = capacity
        self.acceptance = GeometricAcceptance(model, seed)
        self.accept_source = accept_source
        self.duration_source = duration_source
        self.prefill_source = prefill_source
        # default prefill cost per fed token (seconds): 0.0 keeps
        # "prefill is outside the fitted model"; a positive value makes TTFT
        # sensitive to how many rows actually get prefilled
        self.prefill_token_cost = prefill_token_cost
        # replayed per-step done sets: the live engine marks a slot done on
        # its EOS step (commit > 0) one iteration before it commits 0, and
        # victim selection must see the same flag to replay identically
        self.done_source = done_source
        # replayed per-rid chunk durations (FIFO, like prefill_source)
        self.chunk_source = chunk_source
        self.done = np.ones(capacity, dtype=bool)
        self.rids = np.full(capacity, -1, dtype=np.int64)
        self._step_idx = 0
        # paged-KV mirror: same geometry as the live pool => the scheduler's
        # preemption decisions (functions of free/allocated/token counts
        # only) replay count-for-count against the live run
        if block_size is not None:
            max_blocks = -(-max_context // block_size)
            if num_blocks is None:
                num_blocks = capacity * max_blocks
            self.kv: Optional[PagedKVTables] = PagedKVTables(
                num_blocks, block_size, capacity, max_blocks)
        else:
            self.kv = None
        # the plain sim has no KV to overflow, so no admission hard limit
        self.max_context = (self.kv.logical_len if self.kv is not None
                            else None)

    def _batch_key(self, b: int) -> int:
        for x in self.model.batch_sizes:
            if x >= b:
                return x
        return self.model.batch_sizes[-1]

    def prefill(self, req: Request, slot: int) -> float:
        self.done[slot] = False
        self.rids[slot] = req.rid
        if self.kv is not None:
            # a re-admitted (preempted) request re-prefills prompt + stash
            self.kv.prefill(slot, req.prompt_len + req.n_generated)
            self.kv.evicted_pending.clear()  # no device rows to wipe in sim
        if self.prefill_source is not None:
            return float(self.prefill_source(req.rid))
        # default: prefill outside the fitted model (0.0 per-token cost)
        return (req.prompt_len + req.n_generated) * self.prefill_token_cost

    def prefill_chunk(self, req: Request, slot: int, start: int,
                      n: int) -> float:
        """Mirror of the live chunked-prefill block accounting: tokens grow
        chunk-by-chunk, the slot stays done (out of the decode batch) until
        the final chunk, then joins with the whole-prompt end state."""
        total_len = req.prompt_len + req.n_generated
        feed_total = total_len - 1
        if start == 0:
            self.done[slot] = True
            self.rids[slot] = req.rid
            if self.kv is not None:
                self.kv.prefill(slot, n)
                self.kv.mark_pending(slot)
        elif self.kv is not None:
            self.kv.ensure(slot, start + n)
            self.kv.commit(slot, n)
        if start + n == feed_total:
            if self.kv is not None:
                # cover the row the first decode step writes (row total-1)
                self.kv.ensure(slot, total_len)
                self.kv.commit(slot, 1)
                self.kv.clear_pending(slot)
            self.done[slot] = False
        if self.kv is not None:
            self.kv.evicted_pending.clear()  # no device rows to wipe in sim
        if self.chunk_source is not None:
            return float(self.chunk_source(req.rid))
        return n * self.prefill_token_cost

    def step(self, s: int) -> Tuple[float, np.ndarray, np.ndarray]:
        active = np.where(~self.done)[0]
        b = len(active)
        bk = self._batch_key(b)
        if self.kv is not None:
            # same slot set as the live engine's pre-step growth: every slot
            # still holding blocks (incl. EOS'd rows awaiting retirement),
            # minus mid-prefill slots (they grow chunk-by-chunk instead)
            for slot in self.kv.active_slots():
                if self.kv.is_pending(slot):
                    continue
                self.kv.ensure(slot, self.kv.tokens(slot) + s)
            self.kv.evicted_pending.clear()  # no device rows to wipe in sim
        if self.duration_source is not None:
            dt = float(self.duration_source(self._step_idx, b, s))
        else:
            dt = self.model.t_verify(bk, s) + s * self.model.t_s[bk]
        if self.accept_source is not None:
            accepted = np.asarray(
                self.accept_source(self._step_idx, self.rids[active], s))
        else:
            accepted = self.acceptance.draw(b, s)
        committed = np.zeros(self.capacity, dtype=np.int64)
        # accepted = -1 encodes a replayed zero-commit step (the live engine
        # had already stopped this request: EOS / engine-level max_new);
        # mirror the live backend by marking the slot done so the scheduler
        # retires it the same iteration
        committed[active] = np.maximum(accepted + 1, 0)
        self.done[active[committed[active] == 0]] = True
        if self.done_source is not None:
            rec = {int(r) for r in self.done_source(self._step_idx)}
            for slot in active:
                if int(self.rids[slot]) in rec:
                    self.done[slot] = True
        if self.kv is not None:
            for slot in self.kv.active_slots():
                if not self.kv.is_pending(slot):
                    self.kv.commit(slot, int(committed[slot]))
        self._step_idx += 1
        return dt, committed, self.done.copy()

    def preempt(self, slot: int, req: Request) -> None:
        self.done[slot] = True
        self.rids[slot] = -1
        if self.kv is not None:
            self.kv.release(slot)

    def retire(self, slot: int, req: Optional[Request] = None) -> None:
        self.done[slot] = True
        self.rids[slot] = -1
        if self.kv is not None:
            self.kv.release(slot)


# ---------------------------------------------------------------------------
# the scheduler


@dataclass
class StepTrace:
    """Per-iteration scheduling record (drives sim-vs-live parity tests)."""
    clock: float
    occupancy: int
    s: int
    rids: Tuple[int, ...]
    committed: Dict[int, int]          # rid -> raw committed this step
    admitted: Tuple[int, ...] = ()
    duration: float = 0.0              # step duration charged to the clock
    prefill_s: Tuple[float, ...] = ()  # per-admission prefill seconds
                                       # (-1.0 => admitted via chunks)
    preempted: Tuple[int, ...] = ()    # rids evicted before this step
    done_rids: Tuple[int, ...] = ()    # rids the backend flagged done after
    chunked: Tuple[Tuple[int, int], ...] = ()  # (rid, tokens) chunk events
    chunk_s: Tuple[float, ...] = ()    # per-chunk-event seconds


def replay_sources(trace: Sequence[StepTrace]):
    """(accept, duration, prefill, done, chunk) replay callbacks from a
    trace.

    Feeding these into :class:`SimStepBackend` pins every *outcome* (commit
    counts, step durations, prefill and chunk costs, per-step done flags)
    to the recorded run, so a second scheduler run over the sim backend
    must reproduce the recorded admission order, chunk schedule, and
    batch-size sequence exactly — the sim-vs-live parity check.  Preemption
    decisions are NOT replayed: they are pure functions of the block-pool
    accounting plus the done flags, so a sim backend built with the live
    pool's geometry re-derives them (and the parity test checks they
    match).  Chunk *sizes* are likewise re-derived (they are pure functions
    of the admission budget) — only their durations are replayed.

    ``step_idx`` counts executed steps: iterations that only fed prefill
    chunks (no live decode row) record a trace entry but no backend step,
    so the replay indexes into the occupancy > 0 subset of the trace.

    A preempted request is admitted (and so prefilled) more than once, so
    per-rid prefill/chunk costs replay as FIFO queues of the recorded
    durations.
    """
    steps = [t for t in trace if t.occupancy > 0]
    prefill: Dict[int, List[float]] = {}
    chunks: Dict[int, List[float]] = {}
    for t in trace:
        for rid, dt in zip(t.admitted, t.prefill_s):
            if dt >= 0:                # -1.0 marks a chunked admission
                prefill.setdefault(rid, []).append(dt)
        for (rid, _m), dt in zip(t.chunked, t.chunk_s):
            chunks.setdefault(rid, []).append(dt)

    def accept(step_idx, rids, s):
        # committed - 1; a recorded 0 maps to -1 (zero-commit step: the
        # recorded run had retired this request via EOS / engine max_new)
        rec = steps[step_idx].committed
        return np.array([rec.get(int(r), 1) - 1 for r in rids])

    def duration(step_idx, b, s):
        return steps[step_idx].duration

    def prefill_src(rid):
        q = prefill.get(rid)
        return q.pop(0) if q else 0.0

    def done_src(step_idx):
        return steps[step_idx].done_rids

    def chunk_src(rid):
        q = chunks.get(rid)
        return q.pop(0) if q else 0.0

    return accept, duration, prefill_src, done_src, chunk_src


class ContinuousScheduler:
    """Iteration-level serving loop over any step backend.

    After :meth:`run`, ``self.trace`` holds one :class:`StepTrace` per
    iteration (admission order, live batch size, per-request commits,
    chunked-prefill events) — the observable scheduling behaviour compared
    in parity tests.
    """

    def __init__(self, backend, controller: AdaptiveController,
                 policy: Optional[AdmissionPolicy] = None,
                 observe: bool = False,
                 telemetry=None):
        if telemetry is not None:
            raise _not_ported("the telemetry hub", 11)
        self.backend = backend
        self.controller = controller
        self.policy = policy or ImmediateAdmit()
        self.observe = observe
        self.trace: List[StepTrace] = []
        # the controller's speculation ceiling, not the global S_MAX, is the
        # worst-case reservation unit for admission/overflow checks
        self.s_cap = controller_s_cap(controller)
        if hasattr(backend, "s_cap"):
            backend.s_cap = self.s_cap

    @staticmethod
    def _select_victim(slots: Sequence[int], pool: SlotPool,
                       admit_seq: Dict[int, int]) -> int:
        """Preemption victim: longest remaining token budget, ties broken
        LIFO by admission order (the most recently admitted goes first)."""
        return max(slots, key=lambda sl: (pool.remaining(sl),
                                          admit_seq[pool.request_at(sl).rid]))

    def run(self, requests: Sequence[Request]):
        from repro_torch.serving.server import ServeResult   # avoid import cycle
        pending = sorted(requests, key=lambda r: r.arrival)
        pool = SlotPool(self.backend.capacity)
        backlog: List[Request] = []
        batches: List[BatchRecord] = []
        self.trace = []
        kv = getattr(self.backend, "kv", None)
        max_ctx = getattr(self.backend, "max_context", None)
        s_cap = self.s_cap
        chunk_cfg = getattr(self.policy, "chunk_tokens", None)
        budget_cfg = getattr(self.policy, "token_budget", None)
        chunking = (chunk_cfg is not None
                    and getattr(self.backend, "can_chunk", False))
        prefilling: Dict[int, Request] = {}   # slot -> mid-chunked-prefill
        admit_seq: Dict[int, int] = {}
        n_admits = 0
        prev_done: set = set()         # rids the backend flagged done last step

        def decode_slots() -> List[int]:
            return [sl for sl in pool.active_slots() if sl not in prefilling]

        def growth_reserve(s: int) -> int:
            """Blocks the running decode batch may claim this step."""
            return sum(
                max(0, kv.blocks_for(kv.tokens(sl) + s) - kv.allocated(sl))
                for sl in decode_slots())

        def pending_reserve(exclude: Optional[int] = None) -> int:
            """Blocks the mid-prefill slots still need to complete.  Keeping
            ``free >= this`` at all times is what guarantees every admitted
            chunked prefill can finish (no admit-then-starve)."""
            tot = 0
            for sl, rq in prefilling.items():
                if sl == exclude:
                    continue
                tot += max(0, kv.blocks_for(rq.prompt_len + rq.n_generated)
                           - kv.allocated(sl))
            return tot

        clock, i, n_done, n = 0.0, 0, 0, len(pending)
        while n_done < n:
            while i < n and pending[i].arrival <= clock:
                backlog.append(pending[i])
                i += 1
            admitted: List[int] = []
            prefill_s: List[float] = []
            chunked: List[Tuple[int, int]] = []
            chunk_s: List[float] = []
            budget_left = (budget_cfg if (chunking and budget_cfg is not None)
                           else float("inf"))

            def feed_chunk(req: Request, slot: int, m: int) -> None:
                nonlocal clock
                start = req.prefill_pos
                dt = self.backend.prefill_chunk(req, slot, start, m)
                clock += dt
                chunked.append((req.rid, m))
                chunk_s.append(dt)
                req.prefill_pos += m

            def claim_for(req: Request) -> int:
                """Shared admission bookkeeping (both admission modes)."""
                nonlocal n_admits
                backlog.remove(req)
                slot = pool.claim(req)
                if req.start is None:  # keep the first admission's start
                    req.start = clock
                n_admits += 1
                admit_seq[req.rid] = n_admits
                admitted.append(req.rid)
                return slot

            # ---- continue in-flight chunked prefills (Sarathi: ongoing
            # prefills spend the budget before new admissions) ----
            if chunking and prefilling:
                for slot in sorted(prefilling,
                                   key=lambda sl: admit_seq[
                                       prefilling[sl].rid]):
                    if budget_left <= 0:
                        break
                    req = prefilling[slot]
                    feed_total = req.prompt_len + req.n_generated - 1
                    start = req.prefill_pos
                    m = int(min(chunk_cfg, feed_total - start, budget_left))
                    if kv is not None:
                        # blocks actually available to this chunk right now
                        avail = (kv.available_blocks - growth_reserve(s_cap)
                                 - pending_reserve(exclude=slot))
                        cap_rows = ((kv.allocated(slot) + avail)
                                    * kv.block_size - start)
                        if cap_rows < feed_total - start + 1:
                            # full completion (incl. the +1 commit row) does
                            # not fit yet: feed what fits, short of the
                            # final position
                            m = min(m, max(cap_rows, 0),
                                    feed_total - start - 1)
                    if m <= 0:
                        continue       # blocked on blocks; retry next step
                    feed_chunk(req, slot, m)
                    budget_left -= m
                    if req.prefill_pos == feed_total:
                        del prefilling[slot]
            # ---- admissions ----
            if chunking:
                # budgeted admission supersedes policy.select(): its
                # whole-prompt budget semantics (skip over-budget heads)
                # exist precisely because chunk-incapable backends cannot
                # split a prompt — here an over-budget prompt is admitted
                # chunked instead, in the same FCFS order select() uses
                for req in list(backlog):
                    if pool.free_count == 0 or budget_left <= 0:
                        break
                    if max_ctx is not None:
                        _reject_oversize(req, max_ctx, s_cap)
                    total_len = req.prompt_len + req.n_generated
                    if kv is not None:
                        # reserve the full prompt + first-step worst case up
                        # front (plus the running batch's growth and the
                        # other pending prefills' completion) — a chunked
                        # admission that could not finish would hold blocks
                        # forever
                        need = kv.blocks_for(total_len + s_cap)
                        if (need + growth_reserve(s_cap) + pending_reserve()
                                > kv.available_blocks):
                            break      # head-of-line: wait for free blocks
                    slot = claim_for(req)
                    req.prefill_pos = 0
                    if total_len <= budget_left:
                        p_dt = self.backend.prefill(req, slot)
                        clock += p_dt
                        prefill_s.append(p_dt)
                        budget_left -= total_len
                    else:
                        # over the remaining budget: admit CHUNKED — never a
                        # whole-prompt burst (bounds this iteration's stall)
                        prefill_s.append(-1.0)
                        feed_total = total_len - 1
                        m = int(min(chunk_cfg, budget_left, feed_total))
                        feed_chunk(req, slot, m)
                        budget_left -= m
                        if req.prefill_pos < feed_total:
                            prefilling[slot] = req
            else:
                for req in self.policy.select(backlog, pool.free_count,
                                              clock):
                    if max_ctx is not None:
                        # oversized requests can NEVER be served (deferring
                        # would spin forever); fail loudly before claiming
                        _reject_oversize(req, max_ctx, s_cap)
                    total_len = req.prompt_len + req.n_generated
                    if kv is not None:
                        # admit only if the free list covers the prompt
                        # (plus stash), this request's worst-case first
                        # step, AND the running batch's own worst-case
                        # growth — otherwise a fresh admit pays a full B=1
                        # prefill just to be evicted by the pressure check
                        # below (prefill thrash)
                        need = kv.blocks_for(total_len + s_cap)
                        if need + growth_reserve(s_cap) > kv.available_blocks:
                            break      # head-of-line: wait for free blocks
                    slot = claim_for(req)
                    p_dt = self.backend.prefill(req, slot)
                    clock += p_dt
                    prefill_s.append(p_dt)
            if pool.occupancy == 0:
                if not backlog and i < n:
                    clock = max(clock, pending[i].arrival)
                continue
            # ---- preemption under memory pressure (paged pool only) ----
            # worst case this step commits s+1 tokens per decode slot, i.e.
            # KV writes up to seq_len + s rows; if covering that (plus the
            # pending prefills' completion) could exhaust the free list,
            # evict victims back to the backlog (they re-prefill from
            # prompt + generated stash later).  A lone slot always fits:
            # admission bounds every request to the pool.
            preempted: List[int] = []
            if kv is not None:
                while pool.occupancy > 1:
                    ds = decode_slots()
                    s = self.controller.choose(len(ds))
                    need = (growth_reserve(s) + pending_reserve())
                    if need <= kv.available_blocks:
                        break
                    # never evict a slot the backend already flagged done
                    # (EOS'd, awaiting its zero-commit retirement step):
                    # re-prefilling it would resurrect a finished request
                    # and generate past its EOS.  Mid-prefill slots are not
                    # eligible either: their completion is what the
                    # reservation protects.
                    eligible = [sl for sl in ds
                                if pool.request_at(sl).rid not in prev_done]
                    if not eligible:
                        break          # done slots free their blocks shortly
                    victim = self._select_victim(eligible, pool, admit_seq)
                    req = pool.retire(victim)
                    self.backend.preempt(victim, req)
                    req.prefill_pos = 0
                    backlog.insert(0, req)
                    preempted.append(req.rid)
            ds = decode_slots()
            b = len(ds)
            if b > 0:
                s = self.controller.choose(b)
                dt, committed, backend_done = self.backend.step(s)
                done_rids = tuple(sorted(
                    pool.request_at(sl).rid for sl in ds
                    if backend_done[sl]))
                clock += dt
                toks = 0
                raw: Dict[int, int] = {}
                accepted_live: List[int] = []
                for slot in ds:
                    req = pool.request_at(slot)
                    c_raw = int(committed[slot])
                    raw[req.rid] = c_raw
                    accepted_live.append(max(c_raw - 1, 0))
                    c = min(c_raw, pool.remaining(slot))
                    if c > 0 and req.first_token is None:
                        req.first_token = clock
                    pool.consume(slot, c)
                    req.n_generated += c
                    toks += c
                    # finished: served its token budget, or the backend
                    # stopped committing for it (EOS / engine-level max_new)
                    if pool.remaining(slot) <= 0 or (c_raw == 0
                                                     and backend_done[slot]):
                        req.finish = clock
                        pool.retire(slot)
                        self.backend.retire(slot, req)
                        n_done += 1
                if self.observe and s > 0:
                    # lint: allow-host-sync(accepted_live is already a host list; no device transfer)
                    self.controller.observe(np.asarray(accepted_live), s)
                batches.append(BatchRecord(
                    start=clock - dt, duration=dt, batch_size=b, s_used=s,
                    tokens_generated=toks, n_steps=1,
                    rids=tuple(sorted(raw))))
            else:
                # no live decode row this iteration (all occupied slots are
                # mid-chunked-prefill): the clock advanced by chunk work only
                if not chunked and not admitted and not preempted:
                    raise RuntimeError(
                        "scheduler stalled: occupied slots but no decode "
                        "step, chunk, admission, or preemption this "
                        "iteration (block accounting out of sync?)")
                s, dt, raw, done_rids = 0, 0.0, {}, ()
            self.trace.append(StepTrace(
                clock=clock - dt, occupancy=b, s=s,
                rids=tuple(sorted(raw)), committed=raw,
                admitted=tuple(admitted), duration=dt,
                prefill_s=tuple(prefill_s), preempted=tuple(preempted),
                done_rids=done_rids, chunked=tuple(chunked),
                chunk_s=tuple(chunk_s)))
            prev_done = set(done_rids)
        return ServeResult(requests=list(pending), batches=batches)


def serve_continuous_live(requests: Sequence[Request], engine, tparams,
                          dparams, controller: AdaptiveController, *,
                          capacity: int = 8, cache_len: int = 256,
                          policy: Optional[AdmissionPolicy] = None,
                          observe: bool = False,
                          backend: Optional[ContinuousEngineBackend] = None,
                          block_size: Optional[int] = None,
                          num_blocks: Optional[int] = None,
                          mesh=None,
                          prefix_cache: bool = False,
                          mixed_launch: bool = False,
                          telemetry=None):
    """Serve a request trace on a LIVE SpecDecodeEngine with iteration-level
    continuous batching: requests join/leave at speculative-step granularity
    and the controller re-chooses s from live occupancy every step.

    The virtual clock advances by measured wall time (kernel builds done
    outside the timed regions), so results are directly comparable with the
    run-to-completion :func:`repro_torch.serving.server.serve` loop and with
    the :class:`SimStepBackend` simulation on the same trace.

    ``block_size`` switches the KV slot pool to the paged block allocator
    (``num_blocks`` sizes it; default worst-case) with preemption under
    memory pressure; on the card the target's verify then runs the ragged
    paged kernel K3.  Admission hard-rejects any request whose worst-case
    KV footprint (``prompt_len + max_new`` + the controller's speculation
    ceiling) exceeds the per-request capacity.

    ``mixed_launch`` (requires ``block_size``) runs each non-final prefill
    chunk inside the next speculative step, one K3 call per layer for the
    chunk's and the verify's rows (``SpecDecodeEngine.step_with_chunk``).
    The host block accounting still runs at feed time, so admissions,
    preemptions, tokens and the StepTrace (all but its durations) equal the
    run without it; with an explicit ``backend`` pass the flag to the
    backend instead (``ValueError`` here).

    ``mesh``, ``prefix_cache`` and ``telemetry`` are the JAX package's
    sharded pool, prefix cache and telemetry hub; they are not ported yet
    and raise ``NotImplementedError``.
    """
    if mesh is not None:
        raise _not_ported("a mesh-sharded slot pool", 14)
    if prefix_cache:
        raise _not_ported("the prefix cache", 10)
    if backend is not None and mixed_launch:
        # the defer/flush bookkeeping lives on the backend
        raise ValueError(
            "serve_continuous_live: pass mixed_launch=True to the "
            "ContinuousEngineBackend constructor when supplying an explicit "
            "backend (the deferred-chunk bookkeeping lives on it)")
    for r in requests:
        if r.max_new > engine.max_new:
            raise ValueError(
                f"request {r.rid} wants {r.max_new} tokens but the engine "
                f"slot pool is sized for max_new={engine.max_new}")
    s_cap = controller_s_cap(controller)
    if backend is None:
        warm = sorted(set(controller.lut.table.values()))
        backend = ContinuousEngineBackend(engine, tparams, dparams,
                                          capacity=capacity,
                                          cache_len=cache_len, warm_s=warm,
                                          block_size=block_size,
                                          num_blocks=num_blocks,
                                          s_cap=s_cap, mixed_launch=mixed_launch)
    for r in requests:
        if r.prompt_len + r.max_new + s_cap > backend.max_context:
            raise ValueError(
                f"request {r.rid}: prompt_len={r.prompt_len} + "
                f"max_new={r.max_new} + s_cap={s_cap} exceeds the "
                f"per-request KV capacity {backend.max_context}; the KV "
                f"ring would wrap and corrupt itself")
    sched = ContinuousScheduler(backend, controller, policy, observe=observe,
                                telemetry=telemetry)
    result = sched.run(requests)
    result.trace = sched.trace
    return result
