"""The port's mixture-of-experts layer (``models/moe.py``) and the
qwen3-moe-30b-a3b decoder against the JAX package, on the CPU.

* ``moe_forward`` against JAX's, both dispatches, output and aux: a case
  where capacity binds (factor 1.0; drops asserted), one where
  ``group_size`` splits the tokens into several groups, and one with shared
  experts; their gradients; ``group_size`` and ``capacity``; the port's
  two dispatches keeping the same assignments;
* the mixed verify+chunk step at a capacity that drops, against JAX's
  ``decode_step_mixed``: the padding rows of JAX's ``[B, Tm]`` layout are
  routed and take capacity, so the port carries that layout for a MoE
  model (the packed dense layout would route other tokens);
  ``step_with_chunk`` against JAX's at that capacity, and against
  ``flush_chunk`` + ``step`` where nothing drops;
* speculative = greedy through the engine (the smoke config's capacity
  factor 2.0 = n_experts / top_k, as JAX's own test runs it: then no
  expert can overflow, since a token picks an expert at most once, and a
  token's output does not depend on the rows beside it), and the engine's
  tokens against JAX's at factor 1.0, call for call;
* one training step (loss, ce, aux, every gradient) against JAX's;
* the launchers and the model's family checks.

The model entry points (prefill, decode, the paged step, the chunk,
``prefill_flash``, forward with aux) are held against JAX's in
``test_torch_qk_norm.py``, for this config too.

fp32 throughout.  Tolerances: ``MODEL_TOL`` (1e-4 absolute and relative)
for outputs, logits and caches; aux 1e-5 relative; each gradient 1e-4 of
its tensor's largest entry; kept assignments, positions and tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.launch import serve as slaunch
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import DecoderLM
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_qk_norm import (MODEL_TOL, MOE, NB, _cfgs, assert_cache_close,
                                assert_grads_close, mixed_both, small_draft,
                                spec_equals_greedy, train_step_matches_jax)

DISPATCHES = ["einsum", "gather"]
# (capacity factor, tokens, shared experts): capacity binds; several groups
# (3090 tokens: groups of 618); shared experts
LAYER_CASES = {"drops": (1.0, 96, 0), "groups": (2.0, 3090, 0), "shared": (1.0, 40, 2)}


def drops(cfg, params, x):
    """Dropped assignments of one ``moe_forward(cfg, params, x)`` call, from
    its router outputs, and the assignments in all."""
    m = cfg.moe
    B, T, d = x.shape
    tg = tmoe.group_size(B * T)
    _, _, top_i = tmoe.route(m, params["router"], x.reshape(-1, tg, d))
    C = tmoe.capacity(tg, m.top_k, m.n_experts, m.capacity_factor)
    return int((tmoe.slot_ranks(top_i, m.n_experts) >= C).sum()), top_i.numel()


def count_drops(monkeypatch):
    """Record ``drops`` for every ``moe_forward`` call the decoder makes."""
    seen = []
    inner = tmoe.moe_forward

    def recording(cfg, params, x):
        seen.append(drops(cfg, params, x))
        return inner(cfg, params, x)
    monkeypatch.setattr(tmoe, "moe_forward", recording)
    return seen


def layer_pair(dispatch, cf, shared):
    kw = dict(capacity_factor=cf, dispatch=dispatch, n_shared=shared)
    if shared:
        kw["d_ff_shared"] = 48
    jcfg, tcfg = _cfgs(MOE, **kw)
    jp = jax.tree.map(lambda a: a[0], jcm.init_params(jmoe.moe_defs(jcfg),
                                                      jax.random.PRNGKey(1), 1, jnp.float32))
    return jcfg, jp, tcfg, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _x(N, d=128, seed=0):
    return np.random.default_rng(seed).standard_normal((1, N, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# the layer


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_forward_matches_jax(dispatch, case):
    cf, N, shared = LAYER_CASES[case]
    jcfg, jp, tcfg, tp = layer_pair(dispatch, cf, shared)
    x = _x(N)
    jy, jaux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x))
    ty, taux = tmoe.moe_forward(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    n_drop, n_all = drops(tcfg, tp, torch.from_numpy(x))
    if case == "drops":
        assert n_drop > 0
    if case == "groups":
        assert tmoe.group_size(N) < N and n_drop == 0
    if case == "shared":
        assert "sh_gate" in tp and tp["sh_gate"].shape == (128, 96)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_gradients_match_jax(dispatch):
    """The gradients of ``sum(y * r) + aux`` in x and every parameter, where
    capacity binds: the router's through the combine weights and the aux
    loss, the experts' through the kept slots only."""
    jcfg, jp, tcfg, tp = layer_pair(dispatch, 1.0, 2)
    x = _x(96, seed=1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_forward(jcfg, p, xx)
        return (y * r).sum() + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tpl = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_forward(tcfg, tpl, tx)
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    assert_grads_close({k: v.grad for k, v in tpl.items()}, jax.tree.map(np.asarray, jgp))
    assert_grads_close({"x": tx.grad}, {"x": np.asarray(jgx)})


def test_group_size_and_capacity_match_jax():
    for n in (1, 4, 7, 48, 64, 96, 257, 1024, 1030, 2048, 3090, 4096):
        assert tmoe.group_size(n) == jmoe.group_size(n), n
    for tg in (1, 3, 16, 64, 256, 1024):
        for k, e, f in ((2, 4, 1.0), (2, 4, 2.0), (8, 128, 1.25), (8, 128, 16.0), (6, 160, 1.25)):
            assert tmoe.capacity(tg, k, e, f) == jmoe.capacity(tg, k, e, f), (tg, k, e, f)


def test_dispatches_keep_the_same_assignments():
    """Where capacity binds, the cumulative-sum ranks (``einsum``) and the
    stable-sort ranks (``gather``) keep the same assignments, and the two
    dispatches give the same outputs and aux."""
    out = {}
    for dispatch in DISPATCHES:
        _, _, tcfg, tp = layer_pair(dispatch, 0.5, 0)
        x = torch.from_numpy(_x(256, seed=3))
        out[dispatch] = tmoe.moe_forward(tcfg, tp, x)
    m = tcfg.moe
    _, top_p, top_i = tmoe.route(m, tp["router"], x.reshape(1, 256, -1))
    C = tmoe.capacity(256, m.top_k, m.n_experts, m.capacity_factor)
    kept_einsum = tmoe.slot_ranks(top_i, m.n_experts) < C
    _, _, combine_w, _ = tmoe._dispatch_gather(m, x.reshape(1, 256, -1), top_i, top_p, C)
    assert (~kept_einsum).any()
    assert torch.equal(kept_einsum, combine_w > 0)
    np.testing.assert_allclose(out["gather"][0].numpy(), out["einsum"][0].numpy(),
                               **MODEL_TOL)
    np.testing.assert_allclose(float(out["gather"][1]), float(out["einsum"][1]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the mixed step: JAX's [B, Tm] layout


@pytest.mark.parametrize("s", [0, 3])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_mixed_step_matches_jax_where_capacity_drops(monkeypatch, dispatch, s):
    """At capacity factor 1.0 the call drops assignments (asserted); the
    verify logits of every other slot, the empty one included, and the pool
    equal JAX's, with ``tokens`` as the port's engine passes them (the
    verify feed alone: the port pads it to JAX's width)."""
    seen = count_drops(monkeypatch)
    jl, jc, tl, tc, c, vl = mixed_both(MOE, s, 1.0, tokens_wide=False, dispatch=dispatch)
    assert sum(n for n, _ in seen) > 0, seen
    assert all(n_all == 4 * 16 * 2 for _, n_all in seen)     # B x Tm rows, top-2
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3, :vl], **MODEL_TOL)
    assert_cache_close(tc, jc, NB)
    np.testing.assert_array_equal(tc["bt"].numpy(), c["bt"])


def test_moe_mixed_step_takes_wide_tokens_as_jax():
    """``tokens`` already ``[B, Tm]`` wide (JAX's own argument): the same."""
    jl, jc, tl, tc, _, vl = mixed_both(MOE, 3, 1.0, tokens_wide=True)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3, :vl], **MODEL_TOL)
    assert_cache_close(tc, jc, NB)


# ---------------------------------------------------------------------------
# the engine


CACHE_LEN, BLOCK = 96, 8


def _engines(cf):
    jcfg, tcfg = _cfgs(MOE, cf)
    je = JEngine(jcfg, small_draft(JR, jcfg), max_new=12)
    te = SpecDecodeEngine(tcfg, small_draft(TR, tcfg), max_new=12, device="cpu")
    jt = jax.tree.map(np.asarray, je.target.init(jax.random.PRNGKey(0)))
    jd = jax.tree.map(np.asarray, je.draft.init(jax.random.PRNGKey(1)))
    return je, jt, jd, te, bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu"), tcfg


def _mixed_setup(eng, tp, dp, vocab):
    """Two live decode slots plus one deferred (pending) prefill chunk."""
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, vocab, (9,)).astype(np.int32)
    p1 = rng.integers(0, vocab, (13,)).astype(np.int32)
    long_p = rng.integers(0, vocab, (22,)).astype(np.int32)
    state = eng.init_slots(3, cache_len=CACHE_LEN, block_size=BLOCK)
    state = eng.prefill_into(tp, dp, state, 0, p0, len(p0), CACHE_LEN)
    state = eng.prefill_into(tp, dp, state, 1, p1, len(p1), CACHE_LEN)
    state, chunk = eng.prefill_chunk_into(tp, dp, state, 2, long_p[:8].copy(), 0, 8,
                                          len(long_p), defer=True)
    return state, chunk


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("s", [0, 3])
def test_step_with_chunk_matches_jax_where_capacity_drops(monkeypatch, s):
    seen = count_drops(monkeypatch)
    je, jt, jd, te, tt, td, tcfg = _engines(1.0)
    js, jchunk = _mixed_setup(je, jt, jd, tcfg.vocab_size)
    js, jst = je.step_with_chunk(jt, jd, js, s, jchunk)
    ts, tchunk = _mixed_setup(te, tt, td, tcfg.vocab_size)
    ts, tst = te.step_with_chunk(tt, td, ts, s, tchunk)
    assert sum(n for n, _ in seen) > 0
    np.testing.assert_array_equal(tst.accepted, jst.accepted)
    np.testing.assert_array_equal(tst.committed, jst.committed)
    for name in ("seq_lens", "last2", "out", "n_generated", "done"):
        np.testing.assert_array_equal(_np(getattr(ts, name)), _np(getattr(js, name)),
                                      err_msg=name)
    assert_cache_close(ts.tcache, js.tcache, ts.paged.num_blocks)


@pytest.mark.parametrize("s", [0, 3])
def test_step_with_chunk_equals_flush_then_step_without_drops(s):
    """At capacity factor n_experts / top_k no assignment drops, so the
    mixed step's tokens equal the chunk's own forward followed by the step."""
    _, _, _, eng, tp, dp, tcfg = _engines(2.0)
    assert tcfg.moe.capacity_factor == tcfg.moe.n_experts / tcfg.moe.top_k
    a, chunk_a = _mixed_setup(eng, tp, dp, tcfg.vocab_size)
    a = eng.flush_chunk(tp, dp, a, chunk_a)
    a, st_a = eng.step(tp, dp, a, s)
    b, chunk_b = _mixed_setup(eng, tp, dp, tcfg.vocab_size)
    b, st_b = eng.step_with_chunk(tp, dp, b, s, chunk_b)
    np.testing.assert_array_equal(st_a.committed, st_b.committed)
    for name in ("seq_lens", "last2", "out", "n_generated", "done"):
        np.testing.assert_array_equal(_np(getattr(a, name)), _np(getattr(b, name)),
                                      err_msg=name)


def test_spec_equals_greedy():
    spec_equals_greedy(TR.get_smoke_config(MOE))


def test_engine_tokens_match_jax_where_capacity_drops(monkeypatch):
    seen = count_drops(monkeypatch)
    je, jt, jd, te, tt, td, tcfg = _engines(1.0)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (3, 10)).astype(np.int32)
    lens = np.array([10, 7, 9], np.int32)
    jout, jstats, _ = je.generate(jt, jd, toks, lens, s=3, cache_len=64, collect_stats=True)
    tout, tstats, _ = te.generate(tt, td, toks, lens, s=3, cache_len=64, collect_stats=True)
    assert sum(n for n, _ in seen) > 0
    np.testing.assert_array_equal(tout, np.asarray(jout))
    for a, b in zip(tstats, jstats):
        np.testing.assert_array_equal(a.accepted, b.accepted)


# ---------------------------------------------------------------------------
# training, the launchers, the family checks


@pytest.mark.parametrize("cf", [None, 1.0], ids=["smoke", "cf1"])
def test_moe_train_step_matches_jax(cf):
    assert train_step_matches_jax(MOE, cf) > 0


def test_launchers_take_the_moe_family():
    res = tlaunch.main(["--arch", MOE, "--smoke", "--device", "cpu", "--steps", "8",
                        "--batch", "4", "--seq", "32", "--lr", "3e-3"])
    assert res["losses"][-1] < res["losses"][0]
    out = slaunch.main(["--arch", MOE, "--smoke", "--device", "cpu", "--dtype", "float32",
                        "--requests", "4", "--max-new", "6", "--profile-bs", "1,2",
                        "--s-max", "2", "--interval", "0.01"])
    assert out["adaptive"]["n"] == 4 and out["no_spec"]["n"] == 4


def test_decoder_family_checks():
    cfg = TR.get_smoke_config(MOE)
    assert isinstance(TR.build_model(cfg), DecoderLM)
    with pytest.raises(NotImplementedError, match="item 12"):
        DecoderLM(cfg.with_(moe=None))
    with pytest.raises(NotImplementedError, match="item 12"):
        DecoderLM(TR.get_smoke_config("yi-34b").with_(moe=cfg.moe))
    with pytest.raises(NotImplementedError, match="item 12"):
        TR.build_model(cfg.with_(family="hybrid"))
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(JR.get_smoke_config(MOE).moe)
