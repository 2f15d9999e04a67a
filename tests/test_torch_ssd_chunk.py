"""The port's SSD scan (K6's plain versions, the ones the CPU runs) against the
JAX package: ``ops.ssd_chunk`` against ``ssd_chunk_pallas`` in interpret
mode and ``ssd_chunk_ref`` at the shapes of ``tests/test_kernels.py``,
chained chunks against one long chunk, and ``ops.ssd_chunked`` (the model's
whole chunk loop) against the JAX ``Mamba2LM._ssd_chunked``; strong decay
stays finite; and the CUDA wrapper refuses what it cannot launch.

Inputs are made with numpy from a seed and handed to both packages.  fp32
throughout; tolerance 2e-4 absolute and relative, the JAX package's own
bound for K6 against its reference (the products are summed in another
order, and the decay's prefix sum too).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as K6
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = dict(rtol=2e-4, atol=2e-4)


def _softplus(x):
    return np.log1p(np.exp(x))


def _chunk_inputs(BH, Q, P, N, seed=0, h0=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, Q, P)).astype(np.float32)
    b = (0.3 * rng.standard_normal((BH, Q, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((BH, Q, N))).astype(np.float32)
    dt = _softplus(rng.standard_normal((BH, Q))).astype(np.float32)
    l = -_softplus(rng.standard_normal((BH, Q))).astype(np.float32)
    h = (rng.standard_normal((BH, P, N)) if h0 else np.zeros((BH, P, N))).astype(np.float32)
    return x, b, c, dt, l, h


def _port_chunk(*args):
    y, h = ops.ssd_chunk(*(torch.from_numpy(a) for a in args))
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("oracle", ["interpret", "ref"])
@pytest.mark.parametrize("Q,P,N", [(8, 8, 16), (16, 64, 128), (32, 16, 32)])
def test_plain_chunk_matches_jax(Q, P, N, oracle):
    args = _chunk_inputs(3, Q, P, N, seed=Q)
    ja = [jnp.asarray(a) for a in args]
    if oracle == "interpret":
        wy, wh = ssd_chunk_pallas(*ja, interpret=True)
    else:
        wy, wh = jax.vmap(jref.ssd_chunk_ref)(*ja)
    before = ops.PLAIN_SSD.launches
    y, h = _port_chunk(*args)
    assert ops.PLAIN_SSD.launches == before + 1 and K6.KERNEL.launches == 0
    np.testing.assert_allclose(y, np.asarray(wy), **TOL)
    np.testing.assert_allclose(h, np.asarray(wh), **TOL)


def test_chained_chunks_equal_one_long_chunk():
    """Two chained chunk calls == one call over the whole sequence (the
    inter-chunk recurrence the scan relies on)."""
    x, b, c, dt, l, _ = _chunk_inputs(2, 16, 8, 16, seed=5, h0=False)
    h0 = np.zeros((2, 8, 16), np.float32)
    y_full, h_full = _port_chunk(x, b, c, dt, l, h0)
    y1, h1 = _port_chunk(x[:, :8], b[:, :8], c[:, :8], dt[:, :8], l[:, :8], h0)
    y2, h2 = _port_chunk(x[:, 8:], b[:, 8:], c[:, 8:], dt[:, 8:], l[:, 8:], h1)
    np.testing.assert_allclose(np.concatenate([y1, y2], 1), y_full, **TOL)
    np.testing.assert_allclose(h2, h_full, **TOL)


def _scan_inputs(B, T, H, P, G, N, seed=0, strong=False):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, T, H, P)).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((B, T, G, N))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((B, T, G, N))).astype(np.float32)
    dt = (0.1 * _softplus(rng.standard_normal((B, T, H)))).astype(np.float32)
    dt[0, T // 2:] = 0.0                       # a ragged prompt: masked tail
    A_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    if strong:
        dt[:] = 0.1
        A_log[:] = np.log(16.0)
    h0 = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32)
    return xh, Bm, Cm, dt, A_log, h0


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("T,Q", [(24, 8), (30, 6), (29, 1)])
def test_plain_scan_matches_the_jax_model(T, Q, G):
    """``ops.ssd_chunked`` against ``Mamba2LM._ssd_chunked`` at the smoke
    config (chunk 8): T 24 runs three chunks of 8, T 30 five of 6, and the
    prime T 29 twenty-nine of 1; G 2 reads b/c by group."""
    jcfg = JR.get_smoke_config("mamba2-1.3b")
    jm = JR.build_model(jcfg)
    s = jcfg.ssm
    H = jm.nheads
    assert ref.ssd_chunk_len(T, s.chunk) == Q
    xh, Bm, Cm, dt, A_log, h0 = _scan_inputs(2, T, H, s.head_dim, G, s.d_state, seed=T + G)
    wy, wh = jm._ssd_chunked({"A_log": jnp.asarray(A_log)}, *(jnp.asarray(a) for a in
                                                              (xh, Bm, Cm, dt, h0)))
    t = torch.from_numpy
    y, h = ops.ssd_chunked(t(xh), t(Bm), t(Cm), t(dt), torch.exp(t(A_log)), t(h0), s.chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)


def test_strong_decay_stays_finite():
    """A = 16 and dt = 0.1 over one 256-row chunk: the decay's prefix sum
    falls to about -410, where exp(-cs_j) alone overflows; the masked form
    stays finite and agrees with the JAX reference."""
    xh, Bm, Cm, dt, A_log, h0 = _scan_inputs(2, 256, 4, 16, 1, 16, seed=9, strong=True)
    t = torch.from_numpy
    y, h = ops.ssd_chunked(t(xh), t(Bm), t(Cm), t(dt), torch.exp(t(A_log)), t(h0), 256)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    x = np.moveaxis(xh, 2, 1).reshape(8, 256, 16)
    b = np.repeat(np.moveaxis(Bm, 2, 1), 4, 1).reshape(8, 256, 16)
    c = np.repeat(np.moveaxis(Cm, 2, 1), 4, 1).reshape(8, 256, 16)
    d = np.moveaxis(dt, 2, 1).reshape(8, 256)
    l = -d * np.tile(np.exp(A_log), 2)[:, None]
    wy, wh = jax.vmap(jref.ssd_chunk_ref)(*(jnp.asarray(a) for a in
                                            (x, b, c, d, l, h0.reshape(8, 16, 16))))
    np.testing.assert_allclose(np.moveaxis(y.numpy(), 2, 1).reshape(8, 256, 16),
                               np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy().reshape(8, 16, 16), np.asarray(wh), **TOL)


def _cuda_args(**over):
    B, T, H, P, G, N = 1, 8, 4, 16, 1, 16
    a = dict(xh=torch.zeros((B, T, H, P)), B_=torch.zeros((B, T, G, N)),
             C_=torch.zeros((B, T, G, N)), dt=torch.zeros((B, T, H)), A=torch.ones(H),
             h0=torch.zeros((B, H, P, N)), chunk=8)
    a.update(over)
    return a


@pytest.mark.parametrize("over,match", [
    ({}, "CUDA device"),
    ({"xh": torch.zeros((1, 8, 4, 16), dtype=torch.float16)}, "dtype"),
    ({"B_": torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)}, "B/C dtype"),
    ({"xh": torch.zeros((1, 8, 4, 256)), "h0": torch.zeros((1, 4, 256, 16))}, "P 256"),
    ({"B_": torch.zeros((1, 8, 3, 16)), "C_": torch.zeros((1, 8, 3, 16))}, "groups"),
    ({"dt": torch.zeros((1, 8, 4), dtype=torch.bfloat16)}, "dt must be"),
    ({"h0": torch.zeros((1, 4, 16, 16)).transpose(2, 3)}, "h0 must be"),
    ({"xh": torch.zeros((1, 4, 8, 16)).transpose(1, 2)[..., :16]}, "CUDA device"),
])
def test_cuda_wrapper_refuses_what_it_cannot_launch(over, match):
    """K6's wrapper checks before any launch: CPU tensors and shapes or
    types the kernel does not take raise, and nothing falls back to the
    plain version."""
    before = ops.PLAIN_SSD.launches
    with pytest.raises(ValueError, match=match):
        K6.ssd_chunked_cuda(**_cuda_args(**over))
    with pytest.raises(ValueError, match="CUDA device"):
        K6.ssd_chunk_cuda(*(torch.from_numpy(a) for a in _chunk_inputs(2, 8, 8, 16)))
    assert ops.PLAIN_SSD.launches == before and K6.KERNEL.launches == 0
