"""The port's engine and serving loops with a Mamba-2 target: speculative
tokens equal greedy target tokens (the ``FAMILY_ARCHS`` case of
``tests/test_spec_decode.py``), tokens and per-step ``StepStats`` equal the
JAX engine's on the same weights (including a draft that is accepted in
part, so that ``commit`` rolls back to interior checkpoints), the slot pool
and ``serve_continuous_live`` on a contiguous pool give each request's solo
tokens and the JAX run's tokens and trace, a paged pool is refused, and the
launcher serves mamba2 on the CPU.

Tokens must be equal, not close: both engines take the argmax of fp32
logits that agree to about 1e-6.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import SpeculationLUT as JLUT
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.serving import scheduler as jsched
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.core.adaptive import AdaptiveController, SpeculationLUT
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousEngineBackend, serve_continuous_live
from repro_torch.serving.traffic import TrafficPhase, make_requests
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "mamba2-1.3b"
CACHE_LEN = 64


def _draft(registry, tcfg, d_model=64, n_heads=2):
    """A one-layer dense draft of the target's vocabulary (its 4096 window
    inherited from ``dense_draft``)."""
    d = registry.get_draft_config(ARCH)
    return dataclasses.replace(
        d, n_layers=1, d_model=d_model, d_ff=128, vocab_size=tcfg.vocab_size,
        attn=dataclasses.replace(d.attn, n_heads=n_heads, n_kv_heads=n_heads, head_dim=32))


def _weights(draft):
    """numpy weights for (target, draft) from the JAX init.  ``"small"``: a
    random draft (nothing accepted).  ``"part"``: the draft's output
    projections are zeroed and it shares the target's embedding, final norm
    and unembedding, so it predicts from the current token alone; the
    target's mixer outputs are scaled by 0.005, so it often agrees: drafts
    are accepted in part (runs of 0 to s at s = 2 and 4 on these prompts)."""
    jcfg = JR.get_smoke_config(ARCH)
    jt = jax.tree.map(np.asarray, JR.build_model(jcfg).init(jax.random.PRNGKey(0)))
    dcfg = _draft(JR, jcfg, *((128, 4) if draft == "part" else ()))
    jd = jax.tree.map(np.asarray, JR.build_model(dcfg).init(jax.random.PRNGKey(1)))
    if draft == "part":
        for k in ("embed", "unembed", "final_norm"):
            jd[k] = jt[k].copy()
        for k in ("wo", "w_down"):
            jd["layers"][k] = np.zeros_like(jd["layers"][k])
        jt["layers"]["out"] = (0.005 * jt["layers"]["out"]).astype(np.float32)
    return jt, jd, dcfg


def _engines(draft, max_new=12):
    jt, jd, jdc = _weights(draft)
    jcfg, tcfg = JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)
    tdc = _draft(TR, tcfg, *((128, 4) if draft == "part" else ()))
    je = JEngine(jcfg, jdc, max_new=max_new)
    te = SpecDecodeEngine(tcfg, tdc, max_new=max_new, device="cpu")
    return je, jt, jd, te, bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu"), tcfg


def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (3, 10)).astype(np.int32),
            np.array([10, 7, 9], np.int32))


@pytest.mark.parametrize("s", [1, 3, 5])
def test_spec_equals_greedy(s):
    tcfg = TR.get_smoke_config(ARCH)
    eng = SpecDecodeEngine(tcfg, _draft(TR, tcfg), max_new=16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tp, dp = eng.target.init(gen, device="cpu"), eng.draft.init(gen, device="cpu")
    toks, lens = _prompts(tcfg.vocab_size)
    ref, _, _ = eng.generate(tp, dp, toks, lens, s=0, cache_len=96)
    out, _, _ = eng.generate(tp, dp, toks, lens, s=s, cache_len=96)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("draft,s", [("small", 0), ("small", 3), ("part", 2), ("part", 4)])
def test_tokens_and_stats_match_jax(draft, s):
    je, jt, jd, te, tt, td, tcfg = _engines(draft)
    toks, lens = _prompts(tcfg.vocab_size)
    jout, jstats, jn = je.generate(jt, jd, toks, lens, s=s, cache_len=CACHE_LEN,
                                   collect_stats=True)
    before = ops.PLAIN_SSD.launches
    tout, tstats, tn = te.generate(tt, td, toks, lens, s=s, cache_len=CACHE_LEN,
                                   collect_stats=True)
    assert ops.PLAIN_SSD.launches == before + tcfg.n_layers   # the prefill's scans
    np.testing.assert_array_equal(tout, np.asarray(jout))
    assert tn == jn and len(tstats) == len(jstats)
    for a, b in zip(tstats, jstats):
        np.testing.assert_array_equal(a.accepted, b.accepted)
        np.testing.assert_array_equal(a.committed, b.committed)
    if draft == "part":   # accepted in part: commit rolled back to interior checkpoints
        acc = np.concatenate([st.accepted for st in tstats])
        assert acc.max() > 0 and ((acc > 0) & (acc < s)).any()


def _solo(eng, tp, dp, prompt):
    out, _, _ = eng.generate(tp, dp, np.asarray(prompt)[None, :],
                             np.array([len(prompt)], np.int32), s=3, cache_len=CACHE_LEN)
    return out[0]


def test_slot_pool_matches_solo_generate():
    """The contiguous slot pool with an SSM target: every cache leaf (state,
    conv buffers, the draft's ring) is copied on its slot axis; a request
    injected mid-flight and a recycled slot give their solo tokens."""
    _, _, _, eng, tp, dp, tcfg = _engines("part", max_new=10)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, (L,)).astype(np.int32) for L in (8, 6, 9, 7)]
    refs = [_solo(eng, tp, dp, p) for p in prompts]
    state = eng.init_slots(3, CACHE_LEN)
    assert state.paged is None and bool(state.done.all())
    for slot in (0, 1):
        state = eng.prefill_into(tp, dp, state, slot, prompts[slot], len(prompts[slot]),
                                 CACHE_LEN)
    state, st = eng.step(tp, dp, state, 3)
    assert st.committed[2] == 0                      # the empty slot stays silent
    state = eng.prefill_into(tp, dp, state, 2, prompts[2], len(prompts[2]), CACHE_LEN)
    for _ in range(30):
        if bool(state.done.all()):
            break
        state, _ = eng.step(tp, dp, state, 3)
    out = state.out.numpy()[:, :eng.max_new]
    for i in range(3):
        np.testing.assert_array_equal(out[i], refs[i], err_msg=f"slot {i}")
    state = eng.retire_slot(state, 1)
    state = eng.prefill_into(tp, dp, state, 1, prompts[3], len(prompts[3]), CACHE_LEN)
    for _ in range(30):
        if bool(state.done[1]):
            break
        state, _ = eng.step(tp, dp, state, 3)
    np.testing.assert_array_equal(state.out.numpy()[1, :eng.max_new], refs[3])


def test_capacity_one_pool_is_the_slot():
    _, _, _, eng, tp, dp, tcfg = _engines("small", max_new=6)
    prompt = np.arange(5, 12, dtype=np.int32)
    state = eng.init_slots(1, CACHE_LEN)
    state = eng.prefill_into(tp, dp, state, 0, prompt, len(prompt), CACHE_LEN)
    for _ in range(10):
        state, _ = eng.step(tp, dp, state, 3)
        if bool(state.done[0]):
            break
    np.testing.assert_array_equal(state.out.numpy()[0, :6], _solo(eng, tp, dp, prompt))


def test_paged_pool_is_refused_for_an_ssm_target():
    _, _, _, eng, tp, dp, _ = _engines("small")
    with pytest.raises(NotImplementedError, match="paged KV"):
        eng.init_slots(4, CACHE_LEN, block_size=8)
    with pytest.raises(NotImplementedError, match="paged KV"):
        ContinuousEngineBackend(eng, tp, dp, capacity=2, cache_len=CACHE_LEN, block_size=8)


def _trace(vocab, cls, n=8, seed=7):
    reqs = make_requests(n, [TrafficPhase(0.0005, 1.0, float("inf"))], vocab,
                         seed=seed, max_new=10)
    rng = np.random.default_rng(3)
    return [cls(rid=r.rid, arrival=0.0, tokens=r.tokens, prompt_len=r.prompt_len,
                max_new=int(rng.integers(4, 11))) for r in reqs]


def test_live_serving_matches_jax_and_solo():
    """serve_continuous_live on a contiguous pool of 3 slots: the port's
    tokens per request equal the JAX run's and each request's solo
    generate, and the two StepTraces make the same decisions."""
    je, jt, jd, te, tt, td, tcfg = _engines("part", max_new=10)
    geo = dict(capacity=3, cache_len=CACHE_LEN, collect_outputs=True, warm_s=(1, 2, 3))
    runs = []
    for eng, tp, dp, cls, backend_cls, serve, ctrl in (
            (je, jt, jd, JRequest, jsched.ContinuousEngineBackend,
             jsched.serve_continuous_live, JController(lut=JLUT({1: 3, 2: 2, 4: 1}))),
            (te, tt, td, Request, ContinuousEngineBackend, serve_continuous_live,
             AdaptiveController(lut=SpeculationLUT({1: 3, 2: 2, 4: 1})))):
        reqs = _trace(tcfg.vocab_size, cls)
        backend = backend_cls(eng, tp, dp, **geo)
        runs.append((serve(copy.deepcopy(reqs), eng, tp, dp, ctrl, backend=backend),
                     backend, reqs))
    (jres, jbe, _), (tres, tbe, reqs) = runs
    sig = lambda tr: [(t.occupancy, t.s, tuple(t.rids), dict(t.committed),  # noqa: E731
                       tuple(t.admitted), tuple(t.done_rids)) for t in tr]
    assert sig(tres.trace) == sig(jres.trace)
    for r in reqs:
        out = tbe.outputs[r.rid]
        assert len(out) == r.max_new
        np.testing.assert_array_equal(out, np.asarray(jbe.outputs[r.rid]), err_msg=f"rid {r.rid}")
        solo = _solo(te, tt, td, r.tokens[:r.prompt_len])
        np.testing.assert_array_equal(out, solo[:r.max_new], err_msg=f"rid {r.rid}")


def test_launcher_serves_mamba2_on_cpu():
    res = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--dtype", "float32",
                        "--requests", "5", "--max-new", "6", "--profile-bs", "1,2",
                        "--s-max", "2", "--interval", "0.01"])
    assert res["arch"] == "mamba2-1.3b-smoke" and res["draft"] == "mamba2-1.3b-draft"
    assert set(res["lut"]) == {1, 2} and all(0 <= s <= 2 for s in res["lut"].values())
    assert res["adaptive"]["n"] == 5 and res["no_spec"]["n"] == 5
    assert all(t > 0 for d in res["grid_s_per_token"].values() for t in d.values())
