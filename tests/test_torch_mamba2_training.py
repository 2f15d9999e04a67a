"""Mamba-2 training on the port against the JAX package on the CPU, on the
``mamba2-1.3b`` smoke config with the JAX weights carried over by
``bridge.py``: the loss and every parameter's gradient against
``jax.value_and_grad`` of JAX's ``make_loss_fn`` (autodiff through
``Mamba2LM._ssd_chunked``; the port's gradient of the scan is K6's plain
backward here), at T 16 (two chunks of 8) and T 24 (three); the training
step descending over 12 steps, as ``tests/test_training.py`` runs it in
JAX; and the launcher.

fp32 throughout.  Tolerances: the loss 1e-5 relative; each gradient 1e-4
relative to its tensor's largest entry (the backward sums over every token
in another order), as ``tests/test_torch_training.py`` holds the dense
trainer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.training import train_step as jstep
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.training import data as tdata
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tstep
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_training import _assert_grads_close

ARCH = "mamba2-1.3b"


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)
    jm, tm = JR.build_model(jcfg), TR.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    return jm, jp, tm, jax.tree.map(np.asarray, jp)


def _batch(vocab, B, T, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, T + 1)).astype(np.int32)}


@pytest.mark.parametrize("T", [16, 24])
def test_loss_and_grads_match_jax(pair, T):
    jm, jp, tm, npp = pair
    assert jm.cfg.ssm.chunk == 8 and T % 8 == 0 and T // 8 >= 2   # the carry is on the path
    batch = _batch(jm.cfg.vocab_size, 3, T, seed=T)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, jm.cfg), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = bridge.to_torch(npp, "cpu")
    before = ops.PLAIN_SSD.launches
    tmet, tg = tstep.value_and_grad(tstep.make_loss_fn(tm, tm.cfg), tp,
                                    {"tokens": torch.from_numpy(batch["tokens"])})
    # one plain forward and one plain backward of the scan per layer
    assert ops.PLAIN_SSD.launches == before + 2 * tm.cfg.n_layers
    np.testing.assert_allclose(float(tmet["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), rtol=1e-5)
    assert set(tmet) == set(jmet)
    _assert_grads_close(tg, jax.tree.map(np.asarray, jg))
    assert not any(t.requires_grad for t in topt.leaves(tp))


def test_train_step_descends():
    """12 steps on the port alone (the JAX package's ``test_train_step_descends``
    for mamba2-1.3b: its optimizer settings and stream)."""
    cfg = TR.get_smoke_config(ARCH)
    model = TR.build_model(cfg)
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


def test_train_launcher_runs_mamba2_on_the_cpu():
    res = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "12"])
    assert res["arch"] == ARCH + "-smoke" and res["device"] == "cpu"
    assert res["losses"][-1] < res["losses"][0] and len(res["losses"]) == 12
