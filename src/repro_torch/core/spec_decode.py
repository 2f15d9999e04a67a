"""Batched speculative decoding (paper §3, Algorithm 1): the port of
``repro.core.spec_decode`` for greedy verification, without the prefix
cache or sharded pools.

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

Slot pool (continuous batching, serving/scheduler.py): a fixed-capacity
:class:`DecodeState` whose empty rows are ``done``, so the same step serves
every occupancy level.  :meth:`SpecDecodeEngine.init_slots` allocates it,
:meth:`~SpecDecodeEngine.prefill_into` injects one request (a B = 1
prefill, then a copy into the slot's rows) and
:meth:`~SpecDecodeEngine.retire_slot` frees a row.

A Mamba-2 target (``family="ssm"``) takes the same step: its verify
``decode_step`` checkpoints the recurrent state after every fed position
and its ``commit`` picks each request's checkpoint at the accept index;
the slot pool copies every cache leaf on its slot axis, and a paged pool
is refused, as in the JAX engine.

Paged KV: ``init_slots(block_size=...)`` replaces the per-slot target rings
with one pool of fixed-size blocks (``DecoderLM.init_paged_cache``) plus a
block table ``bt [capacity, max_blocks]`` in ``DecodeState.tcache``; the
host half is the :class:`~repro_torch.serving.slots.PagedKVTables` on
``DecodeState.paged``.  ``prefill_into`` claims ``ceil(prompt / block)``
blocks and copies the prefill rows block by block; every ``step`` first
grows each live slot's table to cover ``seq_len + s`` rows, uploads ``bt``
only when a table grew, sends ``cu_blocks`` (``host_cu_blocks`` of the same
host tables) so the target's verify runs the ragged kernel K3, and
afterwards advances the host token mirror by the commit counts;
``retire_slot`` frees the blocks and wipes their ``pos`` rows, so a
recycled block never leaks stale keys.  The draft's small cache
stays a ring at the per-slot logical length.  ``warm=True`` on these
methods only loads the kernels and leaves the state as it is: there is no
compile to warm, and the state is written in place.

Chunked prefill: :meth:`~SpecDecodeEngine.prefill_chunk_into` feeds a
prompt into a slot in chunks between the steps of the running batch
(``DecoderLM.prefill_chunk``: K1 over the slot's ring, K3 over a paged
pool through the slot's table); the slot joins the decode batch after the
final chunk in the state a whole-prompt ``prefill_into`` leaves.

Mixed verify+chunk launch (paged pool): ``prefill_chunk_into(...,
defer=True)`` runs a non-final chunk's host bookkeeping and returns a
:class:`DeferredChunk` instead of running its forward.
:meth:`~SpecDecodeEngine.step_with_chunk` then runs that forward inside the
next speculative step: the draft's chunk forward first, then the target's
chunk rows in the same attention call as the verify rows, once per layer
(``DecoderLM.decode_step_mixed``, K3 on the card), so the chunk's separate
32-layer target forward disappears.  Any other consumer of the pool first
sends the deferred chunk on its own (:meth:`~SpecDecodeEngine.flush_chunk`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import build_model
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.tuning import host_cu_blocks

if TYPE_CHECKING:  # the real import is lazy: serving/ imports this module
    from repro_torch.serving.slots import PagedKVTables

# headroom rows in the per-request output buffer: one speculative step can
# commit up to s + 1 tokens past max_new.  Also the ceiling on s.
S_MAX = 8


def _slot_axis(full_shape, single_shape) -> Optional[int]:
    """The one axis where a B = 1 leaf differs from the pool's leaf (None
    when they are the same shape: a pool of capacity 1)."""
    diff = [i for i, (f, g) in enumerate(zip(full_shape, single_shape)) if f != g]
    assert len(full_shape) == len(single_shape) and len(diff) <= 1, \
        (full_shape, single_shape)
    return diff[0] if diff else None


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
    # host half of the paged KV pool (block free list + per-slot tables);
    # None for contiguous per-slot ring caches
    paged: Optional["PagedKVTables"] = None


@dataclasses.dataclass
class StepStats:
    accepted: np.ndarray     # [B] accepted draft tokens this step (a)
    committed: np.ndarray    # [B] tokens committed this step (a+1, 0 if done)


@dataclasses.dataclass
class DeferredChunk:
    """A paged, non-final prefill chunk whose host bookkeeping (block
    allocation, pending marking, first-chunk begin) has run but whose
    forward has not (``prefill_chunk_into(..., defer=True)``).  Consumed by
    :meth:`SpecDecodeEngine.step_with_chunk`, the mixed verify+chunk launch,
    or by :meth:`SpecDecodeEngine.flush_chunk`, the forward on its own.
    Either way the pool ends with the same rows below the trash block (the
    parked slot's verify writes land in the trash block in one order and
    nowhere in the other)."""
    slot: int
    tokens: np.ndarray       # the CB-bucketed chunk tokens
    start: int               # first feed position this chunk writes
    total_len: int           # the request's full prompt (+ stash) length
    bt_row: Optional[np.ndarray]  # [max_blocks] the slot's host table row;
                                  # None on a contiguous pool (no defer there)
    cb: int                  # the bucket CB (the JAX package's jit key)
    rows_limit: int          # R: the ring rows the draft's chunk forward attends


def ring_view(cache: Dict, slot: int) -> Dict:
    """The B = 1 view of a contiguous cache's slot (k/v on axis 1, pos on
    axis 0): writes through it land in the pool in place."""
    return {name: (t.narrow(0, slot, 1) if name == "pos" else t.narrow(1, slot, 1))
            for name, t in cache.items()}


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
        self.target = build_model(target_cfg)
        self.draft = build_model(draft_cfg) if draft_cfg is not None else None
        self.max_new = max_new
        self.eos_id = eos_id
        self.dtype = dtype
        self.device = resolve_device(device)

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _init_caches(self, B: int, cache_len: int):
        # an SSM target's recurrent cache takes the same arguments and
        # ignores cache_len: its state does not grow
        tcache = self.target.init_cache(B, cache_len, self.dtype, self.device)
        dcache = (self.draft.init_cache(B, cache_len, self.dtype, self.device)
                  if self.draft is not None else None)
        return tcache, dcache

    def prefill(self, tparams, dparams, tokens, prompt_lens,
                cache_len: int) -> DecodeState:
        """Right-padded prompts [B, P] (numpy or tensor) -> a fresh state.
        The target is prefilled with ``prompt_lens - 1`` tokens and the
        draft with ``prompt_lens - 2``; the last two prompt tokens seed the
        first step.  Both models return the committed lengths as they are
        (an SSM its ``prompt_lens``)."""
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

    # ------------------------------------------------------------------
    # slot pool (continuous batching; serving/scheduler.py drives this)

    def load_kernels(self, paged: bool = False) -> None:
        """Build and load the CUDA kernels this engine's steps launch (a
        no-op on the CPU), so that a timed region never includes a build:
        K1 (the draft, or a dense target), K5 (every norm), K2/K3 for a
        paged pool, K6 for an SSM target's prefill."""
        if self.device.type == "cuda":
            names = (["spec_verify_attn", "rmsnorm"]
                     + (["paged_verify_attn"] if paged else [])
                     + (["ssd_chunk"] if self.tcfg.family == "ssm" else []))
            build.build(names)                  # one nvcc per source, in parallel
            for name in names:
                build.load(name)

    def init_slots(self, capacity: int, cache_len: int, *,
                   block_size: Optional[int] = None,
                   num_blocks: Optional[int] = None,
                   mesh: Any = None) -> DecodeState:
        """Blank fixed-capacity slot pool: every row is an empty slot
        (``done``), ready to be claimed via :meth:`prefill_into`.

        With ``block_size`` set, the target KV lives in a paged block pool:
        ``cache_len`` becomes the per-slot logical cap (rounded up to whole
        blocks) and ``num_blocks`` (default: the worst case, ``capacity *
        blocks_per_slot``) sizes the shared pool; undersize it to trade
        memory for scheduler preemptions.  Only an attention target has one:
        an SSM target raises, as in the JAX engine."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded slot pools are not ported yet (ROADMAP queue 1, item 14)")
        dev = self.device
        if block_size is None:
            tcache, dcache = self._init_caches(capacity, cache_len)
            paged = None
        else:
            from repro_torch.serving.slots import PagedKVTables
            if not hasattr(self.target, "init_paged_cache"):
                raise NotImplementedError(
                    f"paged KV is not supported for family '{self.tcfg.family}'")
            max_blocks = -(-cache_len // block_size)
            if num_blocks is None:
                num_blocks = capacity * max_blocks
            paged = PagedKVTables(num_blocks, block_size, capacity, max_blocks)
            tcache = self.target.init_paged_cache(num_blocks, block_size,
                                                  self.dtype, dev)
            tcache["bt"] = torch.full((capacity, max_blocks), -1,
                                      dtype=torch.int32, device=dev)
            dcache = (self.draft.init_cache(capacity, paged.logical_len,
                                            self.dtype, dev)
                      if self.draft is not None else None)
        return DecodeState(
            tcache=tcache, dcache=dcache,
            # seq_lens = 2 keeps the masked step's positions non-negative
            seq_lens=torch.full((capacity,), 2, dtype=torch.int32, device=dev),
            last2=torch.zeros((capacity, 2), dtype=torch.int32, device=dev),
            out=torch.zeros((capacity, self.max_new + S_MAX + 1),
                            dtype=torch.int32, device=dev),
            n_generated=torch.zeros((capacity,), dtype=torch.int32, device=dev),
            done=torch.ones((capacity,), dtype=torch.bool, device=dev),
            paged=paged)

    def prefill_into(self, tparams, dparams, state: DecodeState, slot: int,
                     tokens, prompt_len: int, cache_len: int,
                     warm: bool = False) -> DecodeState:
        """Inject one new request into row ``slot`` of a live slot pool: a
        B = 1 prefill of the (padded) prompt, then a copy of every cache leaf
        into the slot's row of the pool, in place.  A paged pool allocates
        ``ceil(prompt_len / block_size)`` blocks and copies the prefill rows
        block by block through the slot's new table row."""
        if warm:
            self.load_kernels(state.paged is not None)
            return state
        tokens = np.asarray(tokens, np.int32).reshape(1, -1)
        pk = state.paged
        if pk is not None:
            cache_len = pk.logical_len
        one = self.prefill(tparams, dparams, tokens,
                           np.array([prompt_len], np.int32), cache_len)
        if pk is None:
            self._copy_slot(state.tcache, one.tcache, slot)
        else:
            pk.prefill(slot, prompt_len)
            ids = pk.table(slot)
            n, bs = len(ids), pk.block_size
            blocks = self._tensor(ids, torch.long)
            tc, t1 = state.tcache, one.tcache
            for name in ("k", "v"):
                rows = t1[name][:, 0, :n * bs]               # [nL, n*bs, KVH, hd]
                tc[name][:, blocks] = rows.reshape(rows.shape[0], n, bs,
                                                   *rows.shape[2:])
            tc["pos"][blocks] = t1["pos"][0, :n * bs].reshape(n, bs)
            tc["bt"][slot] = -1
            tc["bt"][slot, :n] = blocks.to(torch.int32)
        if self.draft is not None:
            self._copy_slot(state.dcache, one.dcache, slot)
        for name in ("seq_lens", "last2", "out", "n_generated", "done"):
            getattr(state, name)[slot] = getattr(one, name)[0]
        return state

    @staticmethod
    def _copy_slot(pool: Dict, one: Dict, slot: int) -> None:
        """Copy every leaf of a B = 1 cache (ring k/v/pos, or SSM state and
        conv buffers) into row ``slot`` of the pool's leaf, on its slot axis
        (``_slot_axis``); a pool of capacity 1 is the slot itself."""
        for name, full in pool.items():
            single = one[name]
            ax = _slot_axis(full.shape, single.shape)
            if ax is None:
                full.copy_(single)
            else:
                full.select(ax, slot).copy_(single.select(ax, 0))

    # ------------------------------------------------------------------
    # chunked prefill into a slot (the scheduler interleaves the chunks
    # with the decode steps of the running batch)

    def prefill_chunk_into(self, tparams, dparams, state: DecodeState,
                           slot: int, tokens, start: int, n: int,
                           total_len: int, last2=None, *,
                           warm: bool = False, defer: bool = False):
        """Feed one prefill chunk of a request into row ``slot``, in place.

        The request's feed (prompt, or prompt + pre-preemption stash) has
        ``total_len`` tokens; this call writes feed positions ``[start,
        start + n)`` of the target cache (the draft trails by one: its
        limit is ``total_len - 2``, as in the whole-prompt prefill, which
        leaves the last prompt token to the first decode step).
        ``tokens`` is the bucket-padded chunk (its first ``n`` entries
        real).

        Row-state contract (what the interleaved decode steps may observe):

        * **first chunk** (``start == 0``): the slot's stale ``pos`` rows
          are wiped (contiguous target ring and draft ring: a previous
          occupant's keys must never be attendable) and ``seq_lens[slot]``
          is PARKED at ``total_len``.  Parking is load-bearing: the slot is
          still ``done``, so interleaved steps write masked garbage for it,
          and at ``seq_lens = total_len`` those writes land at positions
          ``>= total_len - 1``, beyond every chunk query, and are rewritten
          by the slot's own first decode step before they can be attended.
          On a paged pool the slot is also marked *pending*: its device
          block-table row stays ``-1`` (decode writes go to the trash
          block) until the final chunk publishes it.
        * **middle chunks**: only cache rows ``[start, start + n)`` change;
          ``done``, ``out``, ``n_generated`` and ``last2`` stay as they are.
        * **final chunk** (``start + n == total_len - 1``): ``last2`` (the
          feed's final two tokens) must be given; the commit leaves the
          row state a whole-prompt ``prefill_into`` would have left:
          ``seq_lens = total_len``, ``last2`` set, ``out`` zeroed,
          ``n_generated = 0``, ``done = False`` and (paged) the block table
          published, including the block of row ``total_len - 1``, which
          the first decode step writes.

        ``warm=True`` only loads the kernels and returns the state as it
        is.  An SSM target has no chunked prefill and raises.

        ``defer=True`` (a paged, non-final, non-warm chunk only; anything
        else raises ``ValueError``) runs the first-chunk begin and the host
        block accounting as usual but not the forward, and returns
        ``(state, DeferredChunk)``: the caller runs the forward inside the
        next speculative step (:meth:`step_with_chunk`) or on its own
        (:meth:`flush_chunk`)."""
        if not hasattr(self.target, "prefill_chunk") or (
                self.draft is not None and not hasattr(self.draft, "prefill_chunk")):
            raise NotImplementedError(
                f"chunked prefill is not supported for family "
                f"'{self.tcfg.family}' (model lacks a prefill_chunk path)")
        pk = state.paged
        paged = pk is not None
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        CB = int(tokens.shape[0])
        feed_total = total_len - 1
        final = not warm and start + n == feed_total
        if defer and (not paged or final or warm):
            raise ValueError("defer=True needs a paged, non-final, non-warm chunk")
        if warm:
            self.load_kernels(paged)
            return state
        if not 0 < n <= CB:
            raise ValueError(f"chunk carries n={n} tokens in a {CB} bucket")
        if start + n > feed_total:
            raise ValueError(
                f"chunk [{start}, {start + n}) overruns the {feed_total}"
                f"-token feed (prompt of {total_len})")
        if final and (last2 is None or len(np.asarray(last2)) != 2):
            raise ValueError(
                "the final chunk must pass last2 = the feed's last 2 tokens")

        # ---- first chunk: wipe stale rows, park seq_lens ----
        if start == 0:
            if not paged:
                state.tcache["pos"][slot] = -1
            if self.draft is not None:
                state.dcache["pos"][slot] = -1
            state.seq_lens[slot] = total_len

        # ---- host block accounting + this chunk's block table ----
        bt_row = None
        if paged:
            if start == 0:
                pk.prefill(slot, n)
                pk.mark_pending(slot)
            else:
                pk.ensure(slot, start + n)
                pk.commit(slot, n)
            bt_row = np.full((pk.max_blocks,), -1, np.int32)
            ids = pk.table(slot)
            bt_row[:len(ids)] = ids

        # ---- the chunk forward, target then draft (deferred: not now) ----
        L = pk.logical_len if paged else int(state.tcache["pos"].shape[1])
        # every attendable key lives below row start + CB until the ring
        # wraps, so the ring forwards attend a power-of-two cover of it
        R = min(max(1 << (start + CB - 1).bit_length(), 16), L)
        chunk = DeferredChunk(slot=int(slot), tokens=tokens, start=int(start),
                              total_len=int(total_len), bt_row=bt_row, cb=CB,
                              rows_limit=R)
        if defer:
            return state, chunk
        self._chunk_forward(tparams, dparams, state, chunk)

        # ---- final chunk: the slot becomes a live decode row ----
        if final:
            if paged:
                # cover row total_len - 1 (written by the first decode step)
                pk.ensure(slot, total_len)
                pk.commit(slot, 1)
                pk.clear_pending(slot)
                ids = pk.table(slot)
                bt_row[:len(ids)] = ids
                state.tcache["bt"][slot] = self._tensor(bt_row)
            state.seq_lens[slot] = total_len
            state.last2[slot] = self._tensor(np.asarray(last2, np.int32))
            state.out[slot] = 0
            state.n_generated[slot] = 0
            state.done[slot] = False
        return state

    def _chunk_forward(self, tparams, dparams, state: DecodeState,
                       chunk: DeferredChunk) -> None:
        """A chunk's forward, target then draft, written into the pool in
        place: on a paged pool the target runs through the slot's one-row
        host table (K3), on a contiguous one through its ring view (K1);
        the draft through its ring view, bounded to ``rows_limit`` rows."""
        toks = self._tensor(chunk.tokens, torch.long)[None]
        off = self._tensor([chunk.start])
        feed_total = chunk.total_len - 1
        if chunk.bt_row is not None:
            # the pool is the B = 1 cache (writes land through the slot's
            # host table); the device bt row stays -1 until the commit
            row = chunk.bt_row[None]
            t1 = dict(state.tcache, bt=self._tensor(row))
            self.target.prefill_chunk(tparams, toks, t1, off, self._tensor([feed_total]),
                                      cu_blocks=self._tensor(host_cu_blocks(row)))
        else:
            self.target.prefill_chunk(tparams, toks, ring_view(state.tcache, chunk.slot),
                                      off, self._tensor([feed_total]),
                                      rows_limit=chunk.rows_limit)
        if self.draft is not None:
            self.draft.prefill_chunk(dparams, toks, ring_view(state.dcache, chunk.slot),
                                     off, self._tensor([feed_total - 1]),
                                     rows_limit=chunk.rows_limit)

    def flush_chunk(self, tparams, dparams, state: DecodeState,
                    chunk: DeferredChunk) -> DecodeState:
        """Run a deferred chunk's forward on its own: exactly the forward
        ``prefill_chunk_into(..., defer=True)`` skipped (its host bookkeeping
        ran then).  For when another consumer of the pool comes before the
        next speculative step."""
        self._chunk_forward(tparams, dparams, state, chunk)
        return state

    def retire_slot(self, state: DecodeState, slot: int) -> DecodeState:
        """Free a slot (mark it done), in place and with no host read: the
        step stops committing for it and the row can be claimed again.  A
        paged pool also frees the slot's blocks and wipes their ``pos``
        rows, so a recycled block never leaks stale attendable keys."""
        state.done[slot] = True
        if state.paged is not None:
            freed = state.paged.release(slot)
            if freed:
                state.tcache["pos"][self._tensor(freed, torch.long)] = -1
            state.tcache["bt"][slot] = -1
        return state

    def step(self, tparams, dparams, state: DecodeState, s: int, *,
             warm: bool = False) -> Tuple[DecodeState, StepStats]:
        """One speculative step at length ``s`` for the whole batch.  The
        returned state shares (and has updated in place) the input state's
        caches; the input state must not be stepped again.

        Paged pool: before the device step each live slot's table grows to
        cover its worst-case writes (``seq_len + s`` rows), ``bt`` is
        uploaded only if a table grew, and ``cu_blocks`` comes from the
        same host tables; afterwards the host token mirror advances by the
        commit counts.  ``warm=True`` only loads the kernels and returns the
        state untouched with zero counts."""
        self._check_s(s)
        B = state.seq_lens.shape[0]
        pk = state.paged
        if warm:
            self.load_kernels(pk is not None)
            zero = np.zeros(B, np.int32)
            return state, StepStats(accepted=zero, committed=zero.copy())
        fn = make_spec_step(self.target, self.draft, B, s, eos_id=self.eos_id,
                            max_new=self.max_new, paged=pk is not None)
        args = (tparams, dparams, state.tcache, state.dcache, state.seq_lens,
                state.last2, state.out, state.n_generated, state.done)
        if pk is not None:
            # the device table and the kernel's cu_blocks describe the same
            # blocks: both come from these host tables
            tables = self._grow_tables(state, s)
            args = (*args, torch.from_numpy(host_cu_blocks(tables)).to(self.device))
        return self._finish_step(state, fn(*args))

    @staticmethod
    def _check_s(s: int) -> None:
        if not 0 <= s <= S_MAX:
            raise ValueError(
                f"s={s} outside [0, {S_MAX}]: the step's output buffer is "
                f"sized for at most S_MAX={S_MAX} speculative tokens")

    @staticmethod
    def _grow_tables(state: DecodeState, s: int) -> np.ndarray:
        """Grow each live, non-pending slot's table to cover its worst-case
        writes this step (``seq_len + s`` rows) and upload ``bt`` only if a
        table grew.  Returns the host tables the device ``bt`` holds."""
        pk = state.paged
        grew = False
        for slot in pk.active_slots():
            if not pk.is_pending(slot):
                grew |= bool(pk.ensure(slot, pk.tokens(slot) + s))
        tables = pk.device_tables(exclude_pending=True)
        if grew:
            state.tcache["bt"].copy_(torch.from_numpy(tables))
        return tables

    @staticmethod
    def _finish_step(state: DecodeState, outs) -> Tuple[DecodeState, StepStats]:
        """The step-boundary host read of the accept and commit counts (one
        copy), then, on a paged pool, each non-pending slot's commit."""
        (tc, dc, seq_lens, last2, out, n_gen, done, a, n_commit) = outs
        counts = torch.stack([a, n_commit]).cpu().numpy()
        stats = StepStats(accepted=counts[0], committed=counts[1])
        pk = state.paged
        if pk is not None:
            for slot in pk.active_slots():
                if not pk.is_pending(slot):
                    pk.commit(slot, int(stats.committed[slot]))
        return (DecodeState(tc, dc, seq_lens, last2, out, n_gen, done, paged=pk),
                stats)

    def step_with_chunk(self, tparams, dparams, state: DecodeState, s: int,
                        chunk: DeferredChunk) -> Tuple[DecodeState, StepStats]:
        """One speculative step with a deferred chunk's forward inside it:
        the mixed verify+chunk launch.

        The draft's chunk forward runs first (B = 1 on the slot's ring
        view, as the chunk on its own runs it), then the usual draft loop;
        the target's chunk rows ride the verify's paged attention call,
        once per layer (``DecoderLM.decode_step_mixed``), through the
        chunk's host table row.  The tables grow as in :meth:`step`;
        ``cu_blocks`` comes from the host tables with the chunk row patched
        in, while the device ``bt`` row of the pending slot stays -1.  Its
        ``done`` flag forces its accept count to 0.  Against
        ``flush_chunk`` then ``step`` the pool rows below the trash block,
        the row state and the counts are equal in exact arithmetic; the
        products run on another number of rows, so they may round apart.
        A contiguous pool raises."""
        self._check_s(s)
        pk = state.paged
        if pk is None:
            raise ValueError("step_with_chunk needs a paged slot pool")
        B = state.seq_lens.shape[0]
        tables = self._grow_tables(state, s)
        # K3's grid covers the chunk row's blocks: it reads them through
        # the patched table, not through the device bt
        tables[chunk.slot] = chunk.bt_row
        cu = host_cu_blocks(tables)
        # one upload: cu_blocks, the chunk tokens, the chunk's table row
        ops = torch.from_numpy(np.concatenate([cu, chunk.tokens, chunk.bt_row])).to(self.device)
        feed_total = chunk.total_len - 1
        fn = make_spec_step(self.target, self.draft, B, s, eos_id=self.eos_id,
                            max_new=self.max_new, paged=True,
                            chunk=(chunk.cb, chunk.rows_limit))
        outs = fn(tparams, dparams, state.tcache, state.dcache, state.seq_lens,
                  state.last2, state.out, state.n_generated, state.done, ops[:B + 1],
                  (chunk.slot, ops[B + 1:B + 1 + chunk.cb], chunk.start, feed_total,
                   feed_total - 1, ops[B + 1 + chunk.cb:]))
        return self._finish_step(state, outs)

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


def make_spec_step(tgt, drf, B: int, s: int, *,
                   eos_id: int = -1, max_new: int = 128, paged: bool = False,
                   chunk: Optional[Tuple[int, int]] = None):
    """One greedy speculative step (paper Algorithm 1, batched): the port of
    ``repro.core.spec_decode.make_spec_step``.

    Signature: fn(tparams, dparams, tcache, dcache, seq_lens, last2, out,
    n_generated, done[, cu_blocks[, chunk_ops]]) -> (tcache', dcache',
    seq_lens', last2', out', n_generated', done', accepted, n_commit).
    ``paged=True`` adds the ``cu_blocks [B + 1]`` operand, which the
    target's verify passes to the paged attention (the ragged kernel K3 on
    the card).  ``tgt`` and ``drf`` are models of ``build_model`` (the
    draft a ``DecoderLM``; the target a ``DecoderLM`` or a ``Mamba2LM``,
    whose ``commit`` picks the state checkpoint at each accept count).  The
    caches are written in place, and nothing is read back to the host.

    ``chunk = (CB, R)`` (paged only) builds the mixed verify+chunk step:
    ``chunk_ops = (slot, tokens [CB], start, target limit, draft limit,
    table row [MAXB])`` (ints on the host, tensors on the device).  The
    draft's chunk forward runs first, B = 1 on the slot's ring view and
    bounded to ``R`` rows, in the order the chunk on its own then the step
    would run; then the draft loop, and the target's verify through
    ``decode_step_mixed``, which carries the chunk's rows in the same
    attention call.  The chunk slot is parked ``done``, so its accept count
    is 0 and its row state does not move.
    """
    eos = eos_id
    assert chunk is None or paged, "the mixed step is paged-pool only"

    def fn(tparams, dparams, tcache, dcache, seq_lens, last2, out,
           n_generated, done, cu_blocks=None, chunk_ops=None):
        dev = seq_lens.device
        # ---- 0. mixed launch: the draft's chunk forward first ----
        if chunk_ops is not None:
            cslot, ctoks, cstart, ctl, cdl, cbt_row = chunk_ops
            assert ctoks.shape[0] == chunk[0], "chunk tokens are not CB-bucketed"
            if drf is not None:
                drf.prefill_chunk(dparams, ctoks[None], ring_view(dcache, cslot),
                                  torch.full((1,), cstart, dtype=torch.int32, device=dev),
                                  torch.full((1,), cdl, dtype=torch.int32, device=dev),
                                  rows_limit=chunk[1])
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
        if chunk_ops is not None:
            vlogits, tcache_out = tgt.decode_step_mixed(
                tparams, feed, tcache, seq_lens, cslot, ctoks, cstart, ctl, cbt_row,
                s + 1, cu_blocks)
        else:
            vlogits, tcache_out = tgt.decode_step(tparams, feed, tcache, seq_lens,
                                                  cu_blocks if paged else None)
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
