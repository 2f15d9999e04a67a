"""The port's verify attention on the CPU (its plain version) against the JAX
package's ``ops.spec_verify_attn``, both through the Pallas kernel in
interpret mode and through the JAX reference.

Inputs are made with numpy from a seed and handed to both packages.  fp32
throughout; tolerance 2e-5 absolute and relative, the bound the JAX
package's own kernel tests use for the online-softmax kernel against its
reference (the sums are taken in another order).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import spec_verify_attn as K1

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (results do not depend on it).  The other
    port test modules import it, which makes it autouse there too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, T, L, H, KVH, hd=32, *, seed=0, masked_rows=False, quant=False):
    """Ring-cache inputs: per request a context length, T queries ending
    there, cache rows holding the newest positions (-1 = unwritten)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    n = np.array([max(1, L - 5 - 7 * b) for b in range(B)])
    q_pos = (n[:, None] - 1 + np.arange(T)[None]).astype(np.int32)
    top = (n + T - 1)[:, None]
    rows = np.arange(L)[None]
    cand = rows + (np.maximum(top - 1 - rows, 0) // L) * L
    k_pos = np.where(cand < top, cand, -1).astype(np.int32)
    if masked_rows:
        q_pos[0, :] = -1
        q_pos[-1, -1] = -1
    ks = vs = None
    if quant:
        ks = (np.abs(k).max(-1) / 127.0).astype(np.float32)
        vs = (np.abs(v).max(-1) / 127.0).astype(np.float32)
        k = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    return q, k, v, q_pos, k_pos, ks, vs


def _port(q, k, v, q_pos, k_pos, ks, vs, **kw):
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    return ops.spec_verify_attn(t(q), t(k), t(v), t(q_pos), t(k_pos),
                                k_scale=t(ks), v_scale=t(vs), **kw).numpy()


def _jax(q, k, v, q_pos, k_pos, ks, vs, use_pallas, **kw):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    fn = jax.jit(functools.partial(jops.spec_verify_attn, block_k=16,
                                   use_pallas=use_pallas, **kw))
    return np.asarray(fn(j(q), j(k), j(v), j(q_pos), j(k_pos), k_scale=j(ks),
                         v_scale=j(vs)))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["interpret", "ref"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("L", [40, 64])
@pytest.mark.parametrize("T", [1, 5, 37])
def test_verify_attn_matches_jax(T, L, G, use_pallas):
    case = _case(2, T, L, H=2 * G, KVH=2, seed=T * 100 + L + G)
    np.testing.assert_allclose(_port(*case), _jax(*case, use_pallas), **TOL)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["interpret", "ref"])
@pytest.mark.parametrize("variant", ["window", "prefix", "window_prefix",
                                     "masked_rows", "int8"])
def test_verify_attn_contract_matches_jax(variant, use_pallas):
    kw = {"window": {"window": 6}, "prefix": {"prefix_len": 4},
          "window_prefix": {"window": 5, "prefix_len": 3}}.get(variant, {})
    case = _case(3, 5, 40, H=4, KVH=2, seed=7, masked_rows=variant == "masked_rows",
                 quant=variant == "int8")
    got = _port(*case, **kw)
    np.testing.assert_allclose(got, _jax(*case, use_pallas, **kw), **TOL)
    if variant == "masked_rows":
        q_pos = case[3]
        assert (got[q_pos < 0] == 0).all()


def test_refs_match_jax_oracles():
    rng = np.random.default_rng(4)
    B, Tq, Tk, hd = 3, 6, 20, 16
    q, k, v = (rng.standard_normal((B, n, hd)).astype(np.float32) for n in (Tq, Tk, Tk))
    qp = (np.arange(Tq)[None] + np.array([[10], [3], [14]])).astype(np.int32)
    kp = np.where(np.arange(Tk)[None] < np.array([[16], [9], [20]]),
                  np.arange(Tk)[None], -1).astype(np.int32)
    qp[1, 0] = -1
    for kw in ({}, {"window": 4}, {"prefix_len": 2}):
        want = np.asarray(jref.spec_verify_ref(*map(jnp.asarray, (q, k, v, qp, kp)), **kw))
        got = ref.spec_verify_ref(*map(torch.from_numpy, (q, k, v, qp, kp)), **kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        got_f = ref.flash_attn_ref(*map(torch.from_numpy, (q, k, v, qp, kp)), **kw)
        np.testing.assert_allclose(got_f.numpy(), want, **TOL)


def test_cpu_call_runs_plain_version_only():
    case = _case(2, 3, 40, H=4, KVH=2, seed=1)
    k0, p0 = K1.KERNEL.launches, ops.PLAIN.launches
    _port(*case)
    assert K1.KERNEL.launches == k0 == 0
    assert ops.PLAIN.launches == p0 + 1


def _tensors(case):
    q, k, v, qp, kp, ks, vs = case
    return [None if x is None else torch.from_numpy(x) for x in (q, k, v, qp, kp, ks, vs)]


@pytest.mark.parametrize("bad,match", [
    ("cpu_tensor", "CUDA device"), ("head_dim", "head dim"), ("kv_dtype", "k/v dtype"),
    ("pos_dtype", "int32"), ("scales_missing", "k_scale"), ("window_zero", "window"),
    ("noncontig_heads", "contiguous")])
def test_kernel_wrapper_rejects_what_it_cannot_take(bad, match):
    """The kernel's wrapper checks before any launch: CPU tensors, and shapes,
    dtypes and layouts the kernel does not take, raise ValueError."""
    q, k, v, qp, kp, ks, vs = _tensors(_case(2, 3, 40, H=4, KVH=2, hd=64, seed=2))
    kw = {}
    if bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48].contiguous(), v[..., :48].contiguous()
        q = q.contiguous()
    elif bad == "kv_dtype":
        k, v = k.double(), v.double()
    elif bad == "pos_dtype":
        qp = qp.long()
    elif bad == "scales_missing":
        k, v = k.to(torch.int8), v.to(torch.int8)
    elif bad == "window_zero":
        kw["window"] = 0
    elif bad == "noncontig_heads":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    launches = K1.KERNEL.launches
    with pytest.raises(ValueError, match=match):
        K1.spec_verify_attn_cuda(q, k, v, qp, kp, **kw)
    assert K1.KERNEL.launches == launches


def test_library_path_tracks_the_source():
    p = build.library_path("spec_verify_attn")
    assert p == build.library_path("spec_verify_attn")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libspec_verify_attn-")
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert (build.CSRC / "spec_verify_attn.cu").is_file()


def test_default_scale_is_inverse_sqrt_head_dim():
    case = _case(1, 2, 40, H=2, KVH=2, seed=3)
    hd = case[0].shape[-1]
    np.testing.assert_allclose(_port(*case), _port(*case, scale=1 / math.sqrt(hd)))
