"""The int8 KV cache (``kv_quant``) in the port against the JAX package, on
the CPU.

* ``_quant_rows`` and ``kernels.ref.dequant`` bit for bit against JAX's
  ``_quant_rows`` / ``_dequant`` in fp32 and bf16,
  with all-zero rows (the 1e-8 floor on the scale), rows that reach +-127
  exactly and round-half ties;
* the int8 cache leaves (names, dtypes, shapes) of the ring and the pool,
  and their crossing through ``bridge``;
* every write site on JAX's ``kv_quant`` run, from the same int8 cache and
  weights: ``prefill``, ``prefill_flash``, the ring ``decode_step`` at T 1
  and 4 with the ring wrapping, ``prefill_chunk`` on a ring (the ragged
  final chunk whose padded tail wraps onto row 0 included) and on a pool
  with table holes, the paged ``decode_step`` and ``decode_step_mixed``;
* the engine: speculative == greedy under int8 and close to the unquantised
  cache (ports of ``tests/test_perf_features.py``'s ``kv_quant`` tests);
  paged == contiguous == solo tokens (port of
  ``tests/test_paged_fused_kernel.py``'s int8 engine test); ``prefill_into``
  carrying the scales into the pool; a copy-on-write copying the scales and
  leaving its source block unchanged; one chunked, mixed, preempting
  ``serve_continuous_live`` run on the JAX and the port engines.

Tolerances: fp32 logits 1e-4 (absolute plus relative, the model tests'
``MODEL_TOL``), 1e-3 where a code moved (below); scales 1e-5 relative (the
fp32 K/V rows' tolerance of ``test_torch_chunked_prefill.py``: a scale is
its row's largest |value| over 127); codes equal but for round-half ties
that the last bits of an fp32 K/V value move, at most 1 code apart and on
at most 1e-3 of the elements (one at least).  A moved code changes its K/V
value by one scale step, about 1/127 of its row's largest |value|, and the
logits after it by up to about 1e-3.  Positions, tables, rows the call
must not write, and anything compared within the port bit for bit; tokens
and StepTraces equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import SpeculationLUT as JLUT
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.models import transformer as JT
from repro.serving import scheduler as jsched
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core.adaptive import AdaptiveController, SpeculationLUT
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.kernels import ref, tuning
from repro_torch.models import transformer as TT
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (ContinuousEngineBackend, PrefillBudgetAdmit,
                                           serve_continuous_live)
from repro_torch.serving.traffic import TrafficPhase, make_requests

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MOVED_TOL = dict(rtol=1e-3, atol=1e-3)   # logits after a code moved by a tie
SCALE_RTOL = 1e-5
CACHE_LEN = 96
BLOCK = 8
ROW_LEAVES = ("k", "v", "k_scale", "v_scale")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_codes(got, want, msg="") -> int:
    """int8 codes equal but for round-half ties moved by the last bits of
    the fp32 value: at most 1 apart, on at most 1e-3 of the elements.
    Returns how many moved."""
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    moved = int((d > 0).sum())
    assert d.max(initial=0) <= 1, f"{msg}: codes {d.max()} apart"
    assert moved <= max(1, 1e-3 * d.size), f"{msg}: {moved} codes moved"
    return moved


def _assert_leaves(got, want, msg="") -> int:
    """An int8 cache's row leaves (numpy dicts): codes by ``_assert_codes``,
    scales within ``SCALE_RTOL``.  Returns how many codes moved."""
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(got[name], want[name], rtol=SCALE_RTOL, atol=0,
                                   err_msg=f"{msg}{name}")
    return sum(_assert_codes(got[name], want[name], f"{msg}{name}") for name in ("k", "v"))


def _logit_tol(moved: int) -> dict:
    return MODEL_TOL if moved == 0 else MOVED_TOL


# ---------------------------------------------------------------------------
# _quant_rows and dequant


def _quant_inputs():
    x = np.random.default_rng(0).standard_normal((3, 5, 2, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                                      # the 1e-8 floor
    x[0, 1, 1] = np.arange(-127, 128, 8)                  # amax 127: scale 1, codes exact
    x[1, 0, 0, :5] = [0.5, 1.5, 2.5, -2.5, 127.0]         # ties: 0, 2, 2, -2
    x[2, 3] *= 1e-9                                       # amax below the floor's reach
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_and_dequant_bit_equal_to_jax(dtype):
    x = _quant_inputs()
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JT._quant_rows(jx)
    tq, ts = TT._quant_rows(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy()[1, 0, 0, :5], [0, 2, 2, -2, 127])
    np.testing.assert_array_equal(tq.numpy()[0, 0, 0], 0)
    assert ts[0, 0, 0] == np.float32(1e-8)
    np.testing.assert_array_equal(tq.numpy()[0, 1, 1], np.arange(-127, 128, 8))
    # stored in the cache's dtype, dequantised with the stored scale
    jd = JT._dequant(jq, js.astype(jx.dtype), jx.dtype)
    td = ref.dequant(tq, ts.to(tx.dtype), tx.dtype)
    assert td.dtype == tx.dtype
    np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the cache leaves


def _cfgs(arch):
    return (JR.get_smoke_config(arch).with_(kv_quant=True),
            R.get_smoke_config(arch).with_(kv_quant=True))


def test_cache_leaves_match_jax():
    """Ring and pool: JAX's names, dtypes and shapes (the port's pool has
    one trash block more); integer leaves keep their dtype across ``bridge``."""
    jc, tc = _cfgs("yi-9b")
    jm, tm = JT.DecoderLM(jc), TT.DecoderLM(tc)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        jring, tring = jm.init_cache(3, 40, jdt), tm.init_cache(3, 40, dtype, device="cpu")
        jpool, tpool = jm.init_paged_cache(12, 8, jdt), tm.init_paged_cache(12, 8, dtype,
                                                                             device="cpu")
        for j, t, extra in ((jring, tring, 0), (jpool, tpool, 1)):
            assert list(t) == list(j)
            for name in j:
                shape = list(j[name].shape)
                if extra:   # the trash block
                    shape[0 if name == "pos" else 1] += 1
                assert list(t[name].shape) == shape, name
                assert str(t[name].dtype).split(".")[-1] == str(j[name].dtype), name
        assert tring["k"].dtype == torch.int8 and tring["k_scale"].dtype == dtype
    # across the bridge: int8 codes and int32 positions keep their dtype
    back = bridge.to_torch(jax.tree.map(np.asarray, jm.init_paged_cache(12, 8)), "cpu",
                           dtype=torch.bfloat16)
    assert back["k"].dtype == torch.int8 and back["pos"].dtype == torch.int32
    assert back["k_scale"].dtype == torch.bfloat16
    assert bridge.to_numpy(back)["v"].dtype == np.int8


# ---------------------------------------------------------------------------
# the model against JAX's kv_quant run


def _models(arch):
    """Both int8-cache decoders on the JAX-initialised weights."""
    jc, tc = _cfgs(arch)
    jm, tm = JT.DecoderLM(jc), TT.DecoderLM(tc)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _rows(tm, rows_shape, rng):
    """Random int8 row leaves ``rows_shape + [hd]`` (codes) and
    ``rows_shape`` (scales), as numpy: a row the call clobbers shows."""
    hd = tm.cfg.attn.head_dim
    return {n: rng.integers(-127, 128, (*rows_shape, hd)).astype(np.int8) for n in ("k", "v")} | {
        n: rng.uniform(0.005, 0.02, rows_shape).astype(np.float32)
        for n in ("k_scale", "v_scale")}


def _ring(tm, B, L, prefix, rng):
    """An int8 ring as numpy: random rows, row p % L holding position p for
    p < prefix[b], the rest unwritten."""
    c = _rows(tm, (tm.cfg.n_layers, B, L, tm.cfg.attn.n_kv_heads), rng)
    pos = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos[b, np.arange(prefix[b]) % L] = np.arange(prefix[b])
    return c | {"pos": pos}


def _jax(c):
    return {n: jnp.asarray(x) for n, x in c.items()}


def _torch(c):
    return {n: torch.from_numpy(x.copy()) for n, x in c.items()}


def _numpy(c):
    return {n: np.asarray(x) for n, x in c.items()}


def _check_ring(tc, jc, c0, written):
    """The port's ring against JAX's: positions exact, written rows by
    ``_assert_leaves``, every other row (codes and scales) bit for bit as
    in the starting cache ``c0``.  ``written[b]`` = the rows of slot b the
    call writes.  Returns how many codes moved."""
    tc, jc = bridge.to_numpy(tc), _numpy(jc)
    np.testing.assert_array_equal(tc["pos"], jc["pos"])
    L = c0["pos"].shape[1]
    for b, rows in enumerate(written):
        kept = np.setdiff1d(np.arange(L), rows)
        for name in ROW_LEAVES:
            np.testing.assert_array_equal(tc[name][:, b, kept], c0[name][:, b, kept],
                                          err_msg=name)
    return _assert_leaves(tc, jc)


@pytest.mark.parametrize("flash", [False, True], ids=["prefill", "prefill_flash"])
@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_prefill_matches_jax(arch, flash):
    """``prefill`` attends the quantised rows, ``prefill_flash`` the prompt's
    own unquantised K/V (K4's plain version here), each as JAX's."""
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    name = "prefill_flash" if flash else "prefill"
    jl, jc, jn = jax.jit(getattr(jm, name))(jp, jnp.asarray(toks), jm.init_cache(2, 40),
                                            jnp.asarray(lens))
    tl, tc, tn = getattr(tm, name)(tp, torch.from_numpy(toks),
                                   tm.init_cache(2, 40, device="cpu"), torch.from_numpy(lens))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    blank = bridge.to_numpy(tm.init_cache(2, 40, device="cpu"))
    moved = _check_ring(tc, jc, blank, [np.arange(12), np.arange(12)])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_logit_tol(moved))
    assert (bridge.to_numpy(tc)["k_scale"][:, 0, :12] > 0).all()


def test_prefill_and_prefill_flash_differ_by_the_quantisation():
    """Under ``kv_quant`` the two prefills no longer agree: ``prefill``
    attends dequantised rows.  They write the same codes and scales."""
    _, _, tm, tp = _models("yi-9b")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32))
    pl, pc, _ = tm.prefill(tp, toks, tm.init_cache(2, 40, device="cpu"))
    fl, fc, _ = tm.prefill_flash(tp, toks, tm.init_cache(2, 40, device="cpu"))
    assert not torch.allclose(pl, fl, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pl.numpy(), fl.numpy(), atol=0.1)
    for n in ROW_LEAVES:   # layer 0's inputs are equal on both routes
        assert torch.equal(pc[n][0], fc[n][0]), n


@pytest.mark.parametrize("T,seq_lens", [(1, [17, 9]), (4, [15, 9])], ids=["t1", "t4"])
@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_decode_step_matches_jax(arch, T, seq_lens):
    """Slot 0's new rows wrap onto rows 0.. of a 16-row ring."""
    jm, jp, tm, tp = _models(arch)
    L, B = 16, 2
    seq = np.asarray(seq_lens, np.int32)
    rng = np.random.default_rng(3 + T)
    c = _ring(tm, B, L, seq - 1, rng)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(toks), _jax(c), jnp.asarray(seq))
    tl, tc = tm.decode_step(tp, torch.from_numpy(toks), _torch(c), torch.from_numpy(seq))
    written = [(seq[b] - 1 + np.arange(T)) % L for b in range(B)]
    assert 0 in written[0]                              # the wrap
    moved = _check_ring(tc, jc, c, written)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_logit_tol(moved))


# (ring L, chunk T, offset [B], limit [B]); "wrap": the padded tail of the
# ragged final chunk lands on rows 0.. that hold the live prefix
RING_CASES = {
    "middle": (48, 8, [16, 8], [40, 30]),
    "ragged_final": (48, 16, [16, 12], [21, 20]),
    "wrap": (24, 16, [16, 14], [20, 21]),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_ring_prefill_chunk_matches_jax(arch, case):
    """Padded columns write their rows' old codes and scales back, so every
    row outside ``[offset, limit)`` is bit for bit as it was."""
    L, T, offset, limit = RING_CASES[case]
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(len(case))
    B = len(offset)
    c = _ring(tm, B, L, offset, rng)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    off, lim = np.asarray(offset, np.int32), np.asarray(limit, np.int32)
    jl, jc = jax.jit(jm.prefill_chunk, static_argnums=(5,))(
        jp, jnp.asarray(toks), _jax(c), jnp.asarray(off), jnp.asarray(lim), None)
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks), _torch(c), torch.from_numpy(off),
                              torch.from_numpy(lim))
    valid = (off[:, None] + np.arange(T)[None]) < lim[:, None]
    moved = _check_ring(tc, jc, c, [np.arange(off[b], lim[b]) % L for b in range(B)])
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **_logit_tol(moved))
    if case == "wrap":   # the padded tail did reach live rows of the prefix
        assert all((np.arange(lim[b], off[b] + T) % L < off[b]).any() for b in range(B))


def _pool(tm, NB=12, MAXB=6, seed=0):
    """An int8 pool as numpy: random rows and garbage positions everywhere;
    slot 0 owns blocks [4, 1, 7, 10] for positions 0..23, slot 1 owns
    [2, -1, 9] (a hole at its second logical block) for 0..6."""
    rng = np.random.default_rng(seed)
    c = _rows(tm, (tm.cfg.n_layers, NB, BLOCK, tm.cfg.attn.n_kv_heads), rng)
    bt = np.full((2, MAXB), -1, np.int32)
    bt[0, :4] = [4, 1, 7, 10]
    bt[1, :3] = [2, -1, 9]
    pos = rng.integers(0, 200, (NB, BLOCK)).astype(np.int32)
    for b, n in ((0, 24), (1, 7)):
        for j, pb in enumerate(bt[b]):
            if pb >= 0:
                rows = j * BLOCK + np.arange(BLOCK)
                pos[pb] = np.where(rows < n, rows, -1)
    return c | {"pos": pos, "bt": bt}


def _port_pool(c):
    """The port's pool carries one trash block past the JAX pool's NB."""
    out = {n: torch.from_numpy(np.concatenate([x, np.zeros_like(x[:, :1])], axis=1))
           for n, x in c.items() if n in ROW_LEAVES}
    out["pos"] = torch.from_numpy(np.concatenate([c["pos"], np.full_like(c["pos"][:1], -1)]))
    out["bt"] = torch.from_numpy(c["bt"].copy())
    return out


def _check_pool(tc, jc, c0, written):
    """Pool blocks below the trash block: positions exact, the rows in
    ``written`` ({(block, row)}) by ``_assert_leaves``, every other row bit
    for bit as in ``c0``.  Returns how many codes moved."""
    NB = c0["pos"].shape[0]
    got = {n: x[:, :NB] for n, x in bridge.to_numpy(tc).items() if n in ROW_LEAVES}
    want = _numpy(jc)
    np.testing.assert_array_equal(bridge.to_numpy(tc)["pos"][:NB], want["pos"])
    mask = np.zeros(c0["pos"].shape, bool)
    for pb, o in written:
        mask[pb, o] = True
    for name in ROW_LEAVES:
        np.testing.assert_array_equal(got[name][:, ~mask], c0[name][:, ~mask], err_msg=name)
    np.testing.assert_array_equal(bridge.to_numpy(tc)["bt"], c0["bt"])
    return _assert_leaves(got, want)


@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_paged_prefill_chunk_matches_jax(arch):
    """Slot 0: a ragged final chunk at 24..39 with 5 real columns; slot 1: a
    chunk at 7..22 over the hole of its table (those writes are dropped)."""
    jm, jp, tm, tp = _models(arch)
    c = _pool(tm)
    T = 16
    off, lim = np.array([24, 7], np.int32), np.array([29, 23], np.int32)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, T)).astype(np.int32)
    cu = tuning.host_cu_blocks(c["bt"])
    jl, jc = jax.jit(jm.prefill_chunk)(jp, jnp.asarray(toks), _jax(c), jnp.asarray(off),
                                       jnp.asarray(lim), None, jnp.asarray(cu))
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks), _port_pool(c), torch.from_numpy(off),
                              torch.from_numpy(lim), cu_blocks=torch.from_numpy(cu))
    valid = (off[:, None] + np.arange(T)[None]) < lim[:, None]
    written = {(int(c["bt"][b, p // BLOCK]), p % BLOCK) for b in range(2)
               for p in range(off[b], lim[b]) if c["bt"][b, p // BLOCK] >= 0}
    moved = _check_pool(tc, jc, c, written)
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **_logit_tol(moved))


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "cu_blocks"])
def test_paged_decode_step_matches_jax(ragged):
    """A verify step (T 4) of both slots; slot 1's rows 13..15 fall in the
    hole of its table and are dropped."""
    jm, jp, tm, tp = _models("yi-9b")
    c = _pool(tm)
    seq = np.array([25, 11], np.int32)
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (2, 4)).astype(np.int32)
    cu = tuning.host_cu_blocks(c["bt"]) if ragged else None
    jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(toks), _jax(c), jnp.asarray(seq),
                                     None if cu is None else jnp.asarray(cu))
    tl, tc = tm.decode_step(tp, torch.from_numpy(toks), _port_pool(c), torch.from_numpy(seq),
                            None if cu is None else torch.from_numpy(cu))
    written = {(int(c["bt"][b, p // BLOCK]), p % BLOCK) for b in range(2)
               for p in range(seq[b] - 1, seq[b] + 3) if c["bt"][b, p // BLOCK] >= 0}
    moved = _check_pool(tc, jc, c, written)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_logit_tol(moved))


@pytest.mark.parametrize("case", ["mid_block", "table_hole"])
def test_decode_step_mixed_matches_jax(case):
    """Slots 0 and 1 verify at s = 3 through ``_pool``'s tables; slot 2 is
    pending and carries a 16-column chunk at 16.. through its host row
    (which ends mid-block at 27, or has a hole over 16..23); slot 3 is
    empty."""
    jm, jp, tm, tp = _models("yi-9b")
    c = _pool(tm, NB=16)
    host_row = np.array({"mid_block": [3, 5, 6, 14, -1, -1],
                         "table_hole": [3, 5, -1, 14, -1, -1]}[case], np.int32)
    start, limit = 16, 27 if case == "mid_block" else 32
    c["bt"] = np.concatenate([c["bt"], np.full((2, c["bt"].shape[1]), -1, np.int32)])
    for j, pb in enumerate(host_row[:2]):   # the pending slot's prefix 0..15
        c["pos"][pb] = j * BLOCK + np.arange(BLOCK)
    CB, vl = 16, 4
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tm.cfg.vocab_size, (4, CB)).astype(np.int32)
    ctoks = rng.integers(0, tm.cfg.vocab_size, (CB,)).astype(np.int32)
    seq = np.array([20, 11, 40, 2], np.int32)
    eff = c["bt"].copy()
    eff[2] = host_row
    cu = tuning.host_cu_blocks(eff)
    jl, jc = jax.jit(jm.decode_step_mixed, static_argnums=(9,))(
        jp, jnp.asarray(toks), _jax(c), jnp.asarray(seq), jnp.int32(2), jnp.asarray(ctoks),
        jnp.int32(start), jnp.int32(limit), jnp.asarray(host_row), vl, jnp.asarray(cu))
    tl, tc = tm.decode_step_mixed(tp, torch.from_numpy(toks), _port_pool(c),
                                  torch.from_numpy(seq), 2, torch.from_numpy(ctoks), start,
                                  limit, torch.from_numpy(host_row), vl, torch.from_numpy(cu))
    written = {(int(c["bt"][b, p // BLOCK]), p % BLOCK) for b in range(2)
               for p in range(seq[b] - 1, seq[b] - 1 + vl) if c["bt"][b, p // BLOCK] >= 0}
    written |= {(int(host_row[p // BLOCK]), p % BLOCK) for p in range(start, limit)
                if host_row[p // BLOCK] >= 0}
    moved = _check_pool(tc, jc, c, written)
    live = [0, 1, 3]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live, :vl], **_logit_tol(moved))


# ---------------------------------------------------------------------------
# the engine (port side; the JAX package's kv_quant engine tests)


def _jax_weights(jtcfg, jdcfg):
    """The JAX package's initialisation of a pair (target key 0, draft key
    1, as its tests draw them), handed over as numpy."""
    return (jax.tree.map(np.asarray, JT.DecoderLM(jtcfg).init(jax.random.PRNGKey(0))),
            jax.tree.map(np.asarray, JT.DecoderLM(jdcfg).init(jax.random.PRNGKey(1))))


def _engine(arch, draft, kv_quant=True, max_new=12):
    """The port's engine on a smoke target and ``draft(registry, target
    config)``, with JAX-initialised weights."""
    jt, tt = JR.get_smoke_config(arch), R.get_smoke_config(arch)
    jt, tt = jt.with_(kv_quant=kv_quant), tt.with_(kv_quant=kv_quant)
    jw = _jax_weights(jt, draft(JR, jt))
    eng = SpecDecodeEngine(tt, draft(R, tt), max_new=max_new, device="cpu")
    return eng, bridge.to_torch(jw[0], "cpu"), bridge.to_torch(jw[1], "cpu")


def _internlm_draft(registry, tcfg):
    return dataclasses.replace(registry.get_smoke_config("internlm2-1.8b"),
                               vocab_size=tcfg.vocab_size, kv_quant=tcfg.kv_quant)


def test_spec_equals_greedy_and_close_to_unquantised():
    """Port of ``test_kv_quant_golden_invariant_and_closeness``: s = 3 gives
    the greedy tokens under int8, and int8 changes few greedy tokens of a
    smoke model (> 0.9 agree).  The JAX test's weights."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 10)).astype(np.int32)
    lens = np.array([10, 8], np.int32)
    outs = {}
    for name, q8 in (("fp", False), ("q8", True)):
        eng, tp, dp = _engine("yi-9b", _internlm_draft, kv_quant=q8)
        ref, _, _ = eng.generate(tp, dp, toks, lens, s=0, cache_len=64)
        spec, _, _ = eng.generate(tp, dp, toks, lens, s=3, cache_len=64)
        np.testing.assert_array_equal(ref, spec)
        outs[name] = np.asarray(ref)
    assert (outs["fp"] == outs["q8"]).mean() > 0.9


def test_prefill_logits_close_to_unquantised():
    """Port of ``test_kv_quant_prefill_logits_close``: < 0.1 apart, on the
    JAX test's weights."""
    tcfg = R.get_smoke_config("yi-9b")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 9)))
    mq, mf = TT.DecoderLM(tcfg.with_(kv_quant=True)), TT.DecoderLM(tcfg)
    params = bridge.to_torch(jax.tree.map(np.asarray, JT.DecoderLM(JR.get_smoke_config(
        "yi-9b")).init(jax.random.PRNGKey(0))), "cpu")
    lq, cq, _ = mq.prefill(params, toks, mq.init_cache(2, 64, device="cpu"))
    lf, _, _ = mf.prefill(params, toks, mf.init_cache(2, 64, device="cpu"))
    assert cq["k"].dtype == torch.int8
    assert float((lq - lf).abs().max()) < 0.1


def _small_draft(registry, tcfg):
    d = registry.get_draft_config("yi-9b")
    return dataclasses.replace(
        d, n_layers=1, d_model=64, d_ff=128, vocab_size=tcfg.vocab_size,
        kv_quant=tcfg.kv_quant,
        attn=dataclasses.replace(d.attn, n_heads=2, n_kv_heads=2, head_dim=32))


@pytest.fixture(scope="module")
def q8_engine():
    return _engine("yi-9b", _small_draft)


def test_paged_equals_contiguous_equals_solo(q8_engine):
    """Port of ``test_engine_paged_kv_quant_matches_solo_both_kernels``: the
    int8 pool (scale leaves injected block-wise) and the int8 slot ring give
    the solo contiguous run's tokens."""
    eng, tp, dp = q8_engine
    p = np.random.default_rng(3).integers(0, 512, (9,)).astype(np.int32)
    ref, _, _ = eng.generate(tp, dp, p[None], np.array([9], np.int32), s=3, cache_len=64)
    outs = {}
    for paged in (False, True):
        state = eng.init_slots(2, cache_len=64, block_size=BLOCK if paged else None)
        assert state.tcache["k"].dtype == torch.int8 and "v_scale" in state.tcache
        assert state.dcache["k"].dtype == torch.int8
        state = eng.prefill_into(tp, dp, state, 0, p, len(p), 64)
        for _ in range(12):
            state, _ = eng.step(tp, dp, state, 3)
            if bool(state.done[0]):
                break
        outs[paged] = state.out.numpy()[0, :12].copy()
    np.testing.assert_array_equal(outs[False], np.asarray(ref)[0])
    np.testing.assert_array_equal(outs[True], outs[False])


def test_prefill_into_copies_the_scales(q8_engine):
    """The pool rows behind the slot's table equal the B = 1 prefill's ring
    rows bit for bit, codes and scales; the slot's rows past the prompt are
    untouched."""
    eng, tp, dp = q8_engine
    p = np.random.default_rng(4).integers(0, 512, (21,)).astype(np.int32)
    state = eng.init_slots(2, cache_len=48, block_size=BLOCK)
    state = eng.prefill_into(tp, dp, state, 1, p, len(p), 48)
    one = eng.prefill(tp, dp, p[None], np.array([len(p)], np.int32), state.paged.logical_len)
    ids = torch.tensor(state.paged.table(1))
    n = len(ids) * BLOCK
    for name in ROW_LEAVES:
        got = state.tcache[name][:, ids].flatten(1, 2)
        assert torch.equal(got, one.tcache[name][:, 0, :n]), name
    assert (state.tcache["k_scale"][:, ids].flatten(1, 2)[:, :len(p) - 1] > 0).all()
    assert torch.equal(state.tcache["pos"][ids].flatten(), one.tcache["pos"][0, :n])
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        assert torch.equal(state.dcache[name][:, 1] if name != "pos" else state.dcache[name][1],
                           one.dcache[name][:, 0] if name != "pos" else one.dcache[name][0])


def test_copy_on_write_copies_the_scales(q8_engine):
    """A 16-token prompt whose two blocks the cache holds: the zero-suffix
    admission's first decode row lives in the shared block, so
    ``commit_attached`` copies it.  The copy's codes, scales and positions
    equal the source's, and the source block is bit for bit unchanged after
    the slot's first decode step, which writes into the copy."""
    eng, tp, dp = q8_engine
    prefix = np.random.default_rng(17).integers(0, 512, 25).astype(np.int32)
    state = eng.init_slots(3, 48, block_size=BLOCK)
    pk = state.paged
    cache = PrefixCache(pk.pool)
    pk.attach_cache(cache)
    state = eng.prefill_into(tp, dp, state, 0, prefix, 25, 48)
    cache.insert(prefix[:24], pk.table(0)[:3])
    state = eng.retire_slot(state, 0)
    prompt = prefix[:16]
    src = cache.match(prompt)[1]
    leaves = ROW_LEAVES + ("pos",)

    def block(st, pb):
        return {n: (st.tcache[n][pb] if n == "pos" else st.tcache[n][:, pb]).clone()
                for n in leaves}
    snap = block(state, src)
    assert (snap["k_scale"] > 0).all()
    blocks = cache.lock(prompt)
    pk.attach(1, blocks, len(blocks) * BLOCK)
    cache.unlock(blocks)
    toks = np.ones((32,), np.int32)
    toks[:16] = prompt
    state = eng.attach_prefix(dp, state, 1, toks, 16, 16)
    state = eng.commit_attached(state, 1, 16, prompt[-2:])
    dst = pk.table(1)[1]
    assert dst != src and cache.match(prompt)[1] == src
    copied = block(state, dst)
    for n in leaves:
        assert torch.equal(copied[n], snap[n]), n
    state, _ = eng.step(tp, dp, state, 3)
    after = block(state, src)
    for n in leaves:
        assert torch.equal(after[n], snap[n]), n


# ---------------------------------------------------------------------------
# one live serving run on both engines


def _trace(vocab, cls):
    reqs = make_requests(8, [TrafficPhase(0.0005, 1.0, float("inf"))], vocab, seed=11,
                         max_new=16)
    rng = np.random.default_rng(3)
    out = []
    for i, r in enumerate(reqs):
        tokens, plen = r.tokens, r.prompt_len
        max_new = int(rng.integers(10, 17))
        if i % 2 == 0:
            plen = int(rng.integers(24, 40))
            tokens = rng.integers(0, vocab, (plen,)).astype(np.int32)
        out.append(cls(rid=r.rid, arrival=0.0, tokens=tokens, prompt_len=plen,
                       max_new=max_new))
    return out


TRACE_FIELDS = ("occupancy", "s", "rids", "committed", "admitted", "preempted",
                "done_rids", "chunked")


def test_live_serving_matches_jax():
    """Chunked admission (``PrefillBudgetAdmit(16, chunk=8)``) with the mixed
    launch on an undersized int8 pool (20 blocks of 8, so requests are
    preempted): the JAX and the port engines on the same weights give the
    same StepTrace and tokens."""
    jcfg, tcfg = _cfgs("yi-9b")
    je = JEngine(jcfg, _small_draft(JR, jcfg), max_new=24)
    te = SpecDecodeEngine(tcfg, _small_draft(R, tcfg), max_new=24, device="cpu")
    jt, jd = _jax_weights(jcfg, _small_draft(JR, jcfg))
    tt, td = bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu")
    runs = {}
    for side, eng, tp, dp in (("jax", je, jt, jd), ("port", te, tt, td)):
        mod = jsched if side == "jax" else None
        kw = dict(capacity=4, cache_len=CACHE_LEN, block_size=BLOCK, num_blocks=20,
                  collect_outputs=True, warm_s=(2, 3, 4), mixed_launch=True)
        be = (mod.ContinuousEngineBackend if mod else ContinuousEngineBackend)(eng, tp, dp, **kw)
        ctrl = (JController(lut=JLUT({1: 4, 2: 3, 4: 2})) if mod
                else AdaptiveController(lut=SpeculationLUT({1: 4, 2: 3, 4: 2})))
        pol = (mod.PrefillBudgetAdmit if mod else PrefillBudgetAdmit)(token_budget=16, chunk=8)
        serve = mod.serve_continuous_live if mod else serve_continuous_live
        res = serve(_trace(tcfg.vocab_size, JRequest if mod else Request), eng, tp, dp, ctrl,
                    backend=be, policy=pol)
        runs[side] = (be, res)
    (jbe, jres), (tbe, tres) = runs["jax"], runs["port"]
    assert te.target.init_paged_cache(2, BLOCK, device="cpu")["k"].dtype == torch.int8
    assert any(t.chunked for t in tres.trace) and any(t.preempted for t in tres.trace)
    assert all(r.finish is not None and r.n_generated == r.max_new for r in tres.requests)
    assert len(tres.trace) == len(jres.trace)
    for t0, t1 in zip(jres.trace, tres.trace):
        for f in TRACE_FIELDS:
            assert getattr(t0, f) == getattr(t1, f), f
    for r in tres.requests:
        np.testing.assert_array_equal(tbe.outputs[r.rid], np.asarray(jbe.outputs[r.rid]),
                                      err_msg=f"rid {r.rid}")
