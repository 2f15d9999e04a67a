"""The port's training stack against the JAX package's on the CPU: the
forward, the loss and its per-tensor gradients, AdamW on identical
gradients, the schedule, the data stream, the distillation step and
checkpoints crossing between the packages, on the ``internlm2-1.8b`` smoke
config with the JAX weights carried over by ``bridge.py``; and a descent
test and the launcher on the port alone.

fp32 throughout.  Tolerances: logits 1e-4 absolute and relative (two
decoder layers, matrix products summed in another order); the loss 1e-5
relative; each gradient 1e-4 relative to its tensor's largest entry (the
backward sums over every token in another order); AdamW 1e-6 (the same
elementwise arithmetic); data and checkpoints exact.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models.transformer import DecoderLM as JDecoderLM
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_step as jstep
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.launch import train as tlaunch
from repro_torch.models.transformer import DecoderLM
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tstep
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "internlm2-1.8b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)
    jm, tm = JDecoderLM(jcfg), DecoderLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, jax.tree.map(np.asarray, jp)


def _tp(np_params):
    return bridge.to_torch(np_params, "cpu")


def _batch(vocab, B=3, T=17, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, T + 1)).astype(np.int32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _assert_grads_close(got, want, rel=1e-4):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        scale = np.abs(w[k]).max()
        assert np.abs(g[k] - w[k]).max() <= rel * scale, (k, np.abs(g[k] - w[k]).max(), scale)


def test_registry_has_the_trainer_default():
    cfg = TR.get_config(ARCH)
    jcfg = JR.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        jcfg.n_layers, jcfg.d_model, jcfg.d_ff, jcfg.vocab_size)
    assert (cfg.attn.n_heads, cfg.attn.n_kv_heads, cfg.attn.head_dim, cfg.attn.rope_theta) == (
        jcfg.attn.n_heads, jcfg.attn.n_kv_heads, jcfg.attn.head_dim, jcfg.attn.rope_theta)
    assert TR.get_draft_config(ARCH).d_model == JR.get_draft_config(ARCH).d_model


def test_forward_logits_match_jax(pair):
    jm, jp, tm, npp = pair
    toks = _batch(jm.cfg.vocab_size)["tokens"][:, :-1]
    jl, jaux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    tl, taux = tm.forward(_tp(npp), torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert taux.shape == () and float(taux) == float(jaux) == 0.0


def test_loss_and_grads_match_jax(pair):
    jm, jp, tm, npp = pair
    batch = _batch(jm.cfg.vocab_size, seed=1)
    jloss = jstep.make_loss_fn(jm, jm.cfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss = tstep.make_loss_fn(tm, tm.cfg)
    tp = _tp(npp)
    tmet, tg = tstep.value_and_grad(tloss, tp, {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(float(tmet["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), rtol=1e-5)
    assert set(tmet) == set(jmet)
    _assert_grads_close(tg, jax.tree.map(np.asarray, jg))
    assert not any(t.requires_grad for t in topt.leaves(tp))


def test_cross_entropy_mask_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = float(jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                         None if m is None else jnp.asarray(m)))
        got = float(tstep.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                        None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_update_matches_jax_on_identical_grads(pair):
    """Two AdamW steps from JAX's initial state, each handed the same grads
    (made with numpy): parameters, moments, step and grad norm agree."""
    _, jp, _, npp = pair
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
    rng = np.random.default_rng(3)
    jstate = jopt.init_adamw(jp)
    tparams = _tp(npp)
    tstate = bridge.adamw_state_to_torch(jstate.step, jax.tree.map(np.asarray, jstate.m),
                                         jax.tree.map(np.asarray, jstate.v), "cpu")
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.01,
                             npp)
        jp, jstate, jn = jopt.adamw_update(cfg, jax.tree.map(jnp.asarray, grads), jstate, jp)
        tparams, tstate, tn = topt.adamw_update(tcfg, _tp(grads), tstate, tparams)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for got, want in ((tparams, jp), (tstate.m, jstate.m), (tstate.v, jstate.v)):
            g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
            for k in w:
                np.testing.assert_allclose(g[k], w[k], **ADAM_TOL, err_msg=k)
        assert int(tstate.step) == int(jstate.step)
    assert tstate.step.dtype == torch.int32


@pytest.mark.parametrize("step", [0, 1, 3, 10, 57, 100, 250])
def test_lr_schedule_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=200, min_lr_ratio=0.1)
    want = float(jopt.lr_schedule(jopt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32)))
    got = float(topt.lr_schedule(topt.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_global_norm_matches_jax(pair):
    npp = pair[3]
    np.testing.assert_allclose(float(topt.global_norm(_tp(npp))),
                               float(jopt.global_norm(jax.tree.map(jnp.asarray, npp))),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["markov", "markov2", "uniform"])
def test_batches_match_jax(kind):
    kw = dict(vocab_size=512, batch=3, seq_len=40, kind=kind, alphabet=48, skew=0.9, seed=5)
    jdc, tdc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    for step in (0, 1, 7):
        want = jdata.batch_at(jdc, step)["tokens"]
        got = tdata.batch_at(tdc, step)["tokens"]
        assert got.dtype == want.dtype and np.array_equal(got, want)
    it = tdata.stream(tdc, start_step=2)
    assert np.array_equal(next(it)["tokens"], jdata.batch_at(jdc, 2)["tokens"])


def _teacher_batch(jm, seed):
    """A markov2 batch and fixed teacher logits over the padded vocab (the
    padded ids at -1e30, as a model's unembed leaves them)."""
    rng = np.random.default_rng(seed)
    dc = jdata.DataConfig(vocab_size=jm.cfg.vocab_size, batch=2, seq_len=12, kind="markov2",
                          alphabet=48, skew=0.9, seed=seed)
    toks = jdata.batch_at(dc, 0)["tokens"]
    tl = rng.standard_normal((2, 12, jm.padded_vocab)).astype(np.float32) * 2
    tl[..., jm.cfg.vocab_size:] = -1e30
    return toks, tl


def test_distill_kl_and_grads_match_jax(pair):
    """The port's distillation loss and gradients against ``jax.value_and_grad``
    of the same KL through the JAX forward; then one full
    ``make_distill_step`` in each package from the same state: the same
    ``kl`` and ``grad_norm`` metrics."""
    jm, jp, tm, npp = pair
    toks, tl = _teacher_batch(jm, 4)

    def jloss(params):
        logits, _ = jm.forward(params, jnp.asarray(toks[:, :-1]))
        t = jax.nn.log_softmax(jnp.asarray(tl), axis=-1)
        d = jax.nn.log_softmax(logits[..., :tl.shape[-1]], axis=-1)
        return jnp.sum(jnp.exp(t) * (t - d), axis=-1).mean()

    jkl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tbatch = {"tokens": torch.from_numpy(toks), "teacher_logits": torch.from_numpy(tl)}
    tmet, tg = tstep.value_and_grad(tstep.make_distill_loss_fn(tm), _tp(npp), tbatch)
    np.testing.assert_allclose(float(tmet["kl"]), float(jkl), rtol=1e-5)
    _assert_grads_close(tg, jax.tree.map(np.asarray, jg))

    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep_fn = jax.jit(jstep.make_distill_step(jm, jm.cfg, jopt.AdamWConfig(**opt_kw)))
    _, _, jm_ = jstep_fn(jp, jopt.init_adamw(jp), {k: jnp.asarray(v) for k, v in
                                                   (("tokens", toks), ("teacher_logits", tl))})
    tparams = _tp(npp)
    _, _, tm_ = tstep.make_distill_step(tm, tm.cfg, topt.AdamWConfig(**opt_kw))(
        tparams, topt.init_adamw(tparams), tbatch)
    assert set(tm_) == set(jm_) == {"kl", "grad_norm"}
    for k in jm_:
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5, err_msg=k)


def test_eval_step_reports_the_loss(pair):
    jm, jp, tm, npp = pair
    batch = _batch(jm.cfg.vocab_size, seed=6)
    want = jstep.make_eval_step(jm, jm.cfg)(jp, {"tokens": jnp.asarray(batch["tokens"])})
    got = tstep.make_eval_step(tm, tm.cfg)(_tp(npp), {"tokens": torch.from_numpy(batch["tokens"])})
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_checkpoint_written_by_jax_restores_in_the_port(pair):
    jm, jp, tm, npp = pair
    state = jopt.init_adamw(jp)
    state = state._replace(step=jnp.asarray(17, jnp.int32),
                           m=jax.tree.map(lambda a: a + 0.5, state.m))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        jckpt.save(path, jp, state, step=17)
        tparams = tm.init(torch.Generator().manual_seed(1), device="cpu")
        p, s, step = tckpt.restore(path, tparams, topt.init_adamw(tparams))
    assert step == 17 and int(s.step) == 17 and s.step.dtype == torch.int32
    _assert_trees_equal(p, npp)
    _assert_trees_equal(s.m, jax.tree.map(np.asarray, state.m))
    _assert_trees_equal(s.v, jax.tree.map(np.asarray, state.v))


def test_checkpoint_written_by_the_port_restores_in_jax(pair):
    jm, jp, tm, npp = pair
    tparams = tm.init(torch.Generator().manual_seed(2), device="cpu")
    tstate = topt.init_adamw(tparams)
    tstate = tstate._replace(step=torch.tensor(9, dtype=torch.int32))
    tstate.v["embed"].fill_(0.25)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sub", "ckpt.npz")
        tckpt.save(path, tparams, tstate, step=9)
        assert os.listdir(os.path.dirname(path)) == ["ckpt.npz"]   # no temporary left
        p, s, step = jckpt.restore(path, jp, jopt.init_adamw(jp))
    assert step == 9 and int(s.step) == 9
    _assert_trees_equal(jax.tree.map(np.asarray, p), tparams)
    _assert_trees_equal(jax.tree.map(np.asarray, s.v), tstate.v)


def test_bfloat16_checkpoints_cross_both_ways():
    """bf16 leaves: the port writes them widened to fp32 (exact), which JAX
    restores into a bf16 template; JAX writes 2-byte records, which the port
    reads as the raw bf16 bits."""
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16), "n": {"g": jnp.asarray(vals[0], jnp.bfloat16)}}
    ttree = {"w": torch.from_numpy(vals).bfloat16(),
             "n": {"g": torch.from_numpy(vals[0]).bfloat16()}}
    with tempfile.TemporaryDirectory() as d:
        tp_path, jp_path = os.path.join(d, "t.npz"), os.path.join(d, "j.npz")
        tckpt.save(tp_path, ttree, step=3)
        jback, _, step = jckpt.restore(tp_path, jtree)
        assert step == 3 and jback["w"].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(jback["w"], np.float32),
                                      ttree["w"].float().numpy())
        jckpt.save(jp_path, jtree)
        template = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                    "n": {"g": torch.zeros(5, dtype=torch.bfloat16)}}
        tback, _, _ = tckpt.restore(jp_path, template)
    assert tback["w"].dtype == torch.bfloat16
    assert torch.equal(tback["w"], ttree["w"]) and torch.equal(tback["n"]["g"], ttree["n"]["g"])


def test_adamw_state_bridge():
    state = jopt.init_adamw({"a": jnp.ones((2, 3)), "b": {"c": jnp.ones((4,))}})
    s = bridge.adamw_state_to_torch(np.asarray(state.step), jax.tree.map(np.asarray, state.m),
                                    jax.tree.map(np.asarray, state.v), "cpu")
    assert s.step.dtype == torch.int32 and int(s.step) == 0
    assert s.m["b"]["c"].dtype == torch.float32 and s.v["a"].shape == (2, 3)


def test_train_step_descends():
    """12 steps on the port alone (the JAX package's ``test_train_step_descends``)."""
    cfg = TR.get_smoke_config(ARCH)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = topt.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=30, weight_decay=0.0)
    state = topt.init_adamw(params)
    step = tstep.make_train_step(model, cfg, opt)
    dc = tdata.DataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=32, alphabet=64, skew=0.9)
    losses = []
    for i in range(12):
        batch = {"tokens": torch.from_numpy(tdata.batch_at(dc, i % 3)["tokens"])}
        params, state, m = step(params, state, batch)
        assert torch.isfinite(m["loss"]) and m["grad_norm"].shape == ()
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 12


def test_train_launcher_runs_on_the_cpu():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        res = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "12",
                            "--batch", "4", "--seq", "32", "--lr", "3e-3", "--ckpt", path])
        with np.load(path) as z:
            assert int(z["meta/step"]) == 12 and "params/layers/wq" in z.files
    assert res["losses"][-1] < res["losses"][0] and len(res["losses"]) == 12
    assert res["device"] == "cpu" and res["params"] > 0


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--smoke", "--steps", "2"])
