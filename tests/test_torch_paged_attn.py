"""The port's paged verify attention on the CPU (the plain gather path that
the kernels K2 and K3 are held against on the card) against the JAX
package: its Pallas kernels ``paged_verify_attn_pallas`` (dense) and
``ragged_paged_verify_attn_pallas`` in interpret mode, and its own gather
path.  Also the host grid arithmetic of ``kernels/tuning.py``, the kernel
wrappers' checks, and the paged branch of ``DecoderLM.decode_step`` against
the JAX model, trash-block writes included.

Inputs are made with numpy from a seed and handed to both packages.  fp32
throughout; tolerance 2e-5 absolute and relative, as for the contiguous
verify attention (``tests/test_torch_kernels.py``): the sums are taken in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.kernels import paged as jpaged
from repro.kernels import tuning as jtuning
from repro.kernels.paged_verify_attn import (paged_verify_attn_pallas,
                                             ragged_paged_verify_attn_pallas)
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.kernels import build, paged, tuning
from repro_torch.kernels import paged_verify_attn as K23
from repro_torch.models.transformer import DecoderLM
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = dict(rtol=2e-5, atol=2e-5)

# raggedness patterns (lens per slot, MAXB, bs, NB, interior holes), after
# tests/test_ragged_paged_attn.py: a near-max slot among 1-block slots and an
# empty slot; all slots empty; interior -1 holes
PATTERNS = {
    "basic": ([13, 24, 7], 3, 8, 14, ()),
    "extreme": ([115, 3, 5, 2, 7, 0], 15, 8, 24, ()),
    "all_dead": ([0, 0, 0], 3, 8, 6, ()),
    "holes": ([22, 15, 9], 3, 8, 12, ((0, 1), (2, 0))),
}


def _case(name, T=3, H=4, KVH=2, hd=32, quant=False):
    """numpy inputs: pool k/v [NB,bs,KVH,hd] whose unowned blocks hold
    garbage, pos [NB,bs], block tables with the pattern's holes, and T
    queries per slot ending at its length (-1 for an empty slot)."""
    lens, MAXB, bs, NB, holes = PATTERNS[name]
    rng = np.random.default_rng(len(name))
    B = len(lens)
    k = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    bt = np.full((B, MAXB), -1, np.int32)
    pos = np.full((NB, bs), -1, np.int32)
    order, nxt = rng.permutation(NB), 0
    for b, L in enumerate(lens):
        for j in range(-(-L // bs)):
            if (b, j) in holes:
                continue
            pb = int(order[nxt])
            nxt += 1
            bt[b, j] = pb
            rows = j * bs + np.arange(bs)
            pos[pb] = np.where(rows < L, rows, -1)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    q_pos = np.stack([np.arange(T) + L - 1 if L else np.full(T, -1)
                      for L in lens]).astype(np.int32)
    ks = vs = None
    if quant:
        ks = (np.abs(k).max(-1) / 127.0 + 1e-8).astype(np.float32)
        vs = (np.abs(v).max(-1) / 127.0 + 1e-8).astype(np.float32)
        k = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    return q, k, v, q_pos, pos, bt, ks, vs


def _port(q, k, v, q_pos, pos, bt, ks, vs, **kw):
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    return paged.paged_verify_attn(t(q), t(k), t(v), t(q_pos), t(pos), t(bt),
                                   k_scale=t(ks), v_scale=t(vs), **kw).numpy()


def _jax_all(q, k, v, q_pos, pos, bt, ks, vs, **kw):
    """(dense Pallas, ragged Pallas, gather) outputs of the JAX package."""
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    args = tuple(map(j, (q, k, v, q_pos, pos, bt)))
    sc = dict(k_scale=j(ks), v_scale=j(vs), **kw)
    cu = jnp.asarray(jtuning.host_cu_blocks(bt))
    dense = paged_verify_attn_pallas(*args, interpret=True, **sc)
    ragged = ragged_paged_verify_attn_pallas(*args, cu, interpret=True, **sc)
    gather = jpaged.gather_verify_attn(*args, use_pallas=False, **sc)
    return tuple(map(np.asarray, (dense, ragged, gather)))


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_gather_matches_jax_paged_kernels(pattern):
    case = _case(pattern)
    got = _port(*case)
    dense, ragged, gather = _jax_all(*case)
    np.testing.assert_array_equal(ragged, dense)
    np.testing.assert_allclose(got, dense, **TOL)
    live = case[3] >= 0                 # JAX's gather gives NaN on dead rows
    np.testing.assert_allclose(got[live], gather[live], **TOL)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("variant", ["window", "prefix", "window_prefix", "int8",
                                     "gqa_g4", "gqa_g1_hd64"])
def test_gather_contract_matches_jax(variant):
    """Window and prefix masks, int8 pools with per-(row, kv-head) scales,
    and GQA group sizes, on the pattern with holes."""
    kw = {"window": {"window": 10}, "prefix": {"prefix_len": 5},
          "window_prefix": {"window": 6, "prefix_len": 3}}.get(variant, {})
    shape = {"gqa_g4": dict(H=8, KVH=2), "gqa_g1_hd64": dict(H=2, KVH=2, hd=64)}
    case = _case("holes", T=4, quant=variant == "int8", **shape.get(variant, {}))
    got = _port(*case, **kw)
    dense, ragged, gather = _jax_all(*case, **kw)
    np.testing.assert_array_equal(ragged, dense)
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, gather, **TOL)


def test_gather_helpers_match_jax():
    q, k, v, q_pos, pos, bt, ks, vs = _case("holes", quant=True)
    kg, vg = paged.gather_kv_blocks(torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(bt))
    jk, jv = jpaged.gather_kv_blocks(jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt))
    np.testing.assert_array_equal(kg.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vg.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        paged.gather_key_positions(torch.from_numpy(pos), torch.from_numpy(bt)).numpy(),
        np.asarray(jpaged.gather_key_positions(jnp.asarray(pos), jnp.asarray(bt))))
    np.testing.assert_array_equal(
        paged.gather_scales(torch.from_numpy(ks), torch.from_numpy(bt)).numpy(),
        np.asarray(jpaged.gather_scales(jnp.asarray(ks), jnp.asarray(bt))))


@pytest.mark.parametrize("seed", range(4))
def test_grid_arithmetic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, MAXB = rng.integers(1, 9), rng.integers(1, 17)
    tables = np.where(rng.random((B, MAXB)) < 0.4, -1,
                      rng.integers(0, 64, (B, MAXB))).astype(np.int32)
    tables[0] = -1                                  # an empty slot
    cu = tuning.host_cu_blocks(tables)
    assert cu.dtype == np.int32
    np.testing.assert_array_equal(cu, jtuning.host_cu_blocks(tables))
    assert tuning.grid_steps_ragged(tables) == jtuning.grid_steps_ragged(tables)
    assert tuning.grid_steps_dense(tables) == jtuning.grid_steps_dense(tables)
    assert tuning.dead_tile_fraction(tables) == jtuning.dead_tile_fraction(tables)


def test_cpu_call_runs_the_plain_path_only():
    case = _case("basic")
    before = (K23.DENSE.launches, K23.RAGGED.launches, paged.PLAIN.launches)
    t = [torch.from_numpy(x) for x in case[:6]]
    paged.paged_verify_attn(*t)
    paged.paged_verify_attn(*t, cu_blocks=torch.from_numpy(tuning.host_cu_blocks(case[5])))
    assert (K23.DENSE.launches, K23.RAGGED.launches) == before[:2] == (0, 0)
    assert paged.PLAIN.launches == before[2] + 2


@pytest.mark.parametrize("bad,match", [
    ("cpu_tensor", "CUDA device"), ("head_dim", "head dim"), ("block_size", "block size"),
    ("kv_dtype", "k/v dtype"), ("table_dtype", "int32"), ("cu_shape", "cu_blocks"),
    ("scales_missing", "k_scale"), ("pool_pos", "pos"), ("alignment", "16 bytes")])
def test_kernel_wrappers_reject_what_they_cannot_take(bad, match):
    """K2's and K3's wrapper checks come before any build or launch: CPU
    tensors, and shapes, dtypes and layouts the kernels do not take, raise
    ValueError."""
    q, k, v, qp, pos, bt, _, _ = (None if x is None else torch.from_numpy(x)
                                  for x in _case("basic", hd=64))
    cu = torch.from_numpy(tuning.host_cu_blocks(bt.numpy()))
    if bad == "head_dim":
        q, k, v = (x[..., :48].contiguous() for x in (q, k, v))
    elif bad == "block_size":
        k, v, pos = k[:, :6].contiguous(), v[:, :6].contiguous(), pos[:, :6].contiguous()
    elif bad == "kv_dtype":
        k, v = k.double(), v.double()
    elif bad == "table_dtype":
        bt = bt.long()
    elif bad == "cu_shape":
        cu = cu[:-1]
    elif bad == "scales_missing":
        k, v = k.to(torch.int8), v.to(torch.int8)
    elif bad == "pool_pos":
        pos = pos[:-1]
    elif bad == "alignment":    # a pool view one element off a 16-byte boundary
        flat = torch.empty(k.numel() + 1, dtype=k.dtype)
        flat[1:] = k.reshape(-1)
        k = flat[1:].view(k.shape)
    launches = (K23.DENSE.launches, K23.RAGGED.launches)
    with pytest.raises(ValueError, match=match):
        K23.ragged_paged_verify_attn_cuda(q, k, v, qp, pos, bt, cu)
    if bad != "cu_shape":
        with pytest.raises(ValueError, match=match):
            K23.paged_verify_attn_cuda(q, k, v, qp, pos, bt)
    assert (K23.DENSE.launches, K23.RAGGED.launches) == launches


def test_paged_source_is_built_with_the_others():
    p = build.library_path("paged_verify_attn")
    assert p.name.startswith("libpaged_verify_attn-") and p.parent == build.BUILD_DIR
    assert (build.CSRC / "paged_verify_attn.cu").is_file()


# ---------------------------------------------------------------------------
# the paged branch of the model


def _paged_model(arch, NB=10, bs=8, B=3, MAXB=4, seed=0):
    """Both models on JAX-initialised weights, and one paged cache state as
    numpy: random pool contents, slot 0 with 3 blocks, slot 1 with 2 (one
    of them a hole), slot 2 empty."""
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    jm, tm = JDecoderLM(jcfg), DecoderLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    a = tcfg.attn
    shape = (tcfg.n_layers, NB, bs, a.n_kv_heads, a.head_dim)
    k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    bt = np.full((B, MAXB), -1, np.int32)
    bt[0, :3] = [4, 1, 7]
    bt[1, :2] = [2, -1]
    bt[1, 2] = 9
    pos = np.full((NB, bs), -1, np.int32)
    seq = np.array([19, 13, 2], np.int32)             # slot 2: the empty default
    for b in range(2):
        for j, pb in enumerate(bt[b]):
            if pb >= 0:
                rows = j * bs + np.arange(bs)
                pos[pb] = np.where(rows < seq[b] - 1, rows, -1)
    return jm, jp, tm, tp, dict(k=k, v=v, pos=pos, bt=bt), seq


def _port_cache(c):
    """The port's pool carries one trash block past the JAX pool's NB."""
    k = np.concatenate([c["k"], np.zeros_like(c["k"][:, :1])], axis=1)
    v = np.concatenate([c["v"], np.zeros_like(c["v"][:, :1])], axis=1)
    pos = np.concatenate([c["pos"], np.full_like(c["pos"][:1], -1)])
    return {name: torch.from_numpy(x.copy()) for name, x in
            dict(k=k, v=v, pos=pos, bt=c["bt"]).items()}


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_paged_decode_step_matches_jax(arch, T):
    jm, jp, tm, tp, c, seq = _paged_model(arch)
    rng = np.random.default_rng(T)
    toks = rng.integers(0, tm.cfg.vocab_size, (3, T)).astype(np.int32)
    cu = tuning.host_cu_blocks(c["bt"])
    jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(toks),
                                      {n: jnp.asarray(x) for n, x in c.items()},
                                      jnp.asarray(seq), jnp.asarray(cu))
    tc = _port_cache(c)
    NB = c["pos"].shape[0]
    tl, tc = tm.decode_step(tp, torch.from_numpy(toks), tc, torch.from_numpy(seq),
                            torch.from_numpy(cu))
    live = np.array([True, True, False])
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy()[:NB], np.asarray(jc["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy()[:, :NB], np.asarray(jc[name]), **TOL)
    np.testing.assert_array_equal(tc["bt"].numpy(), c["bt"])


def test_dropped_writes_land_in_the_trash_block_only():
    """A slot with no block at a write position (the empty slot; a hole in
    slot 1's table at T = 4 reaching past its last block) writes into the
    trash block NB and nowhere else: every other row of the pool keeps its
    value, and ``pos[:NB]`` equals the JAX pool's."""
    jm, jp, tm, tp, c, seq = _paged_model("yi-9b")
    NB = c["pos"].shape[0]
    toks = np.full((3, 4), 5, np.int32)
    tc = _port_cache(c)
    before = {n: t.clone() for n, t in tc.items()}
    _, tc = tm.decode_step(tp, torch.from_numpy(toks), tc, torch.from_numpy(seq))
    positions = (seq - 1)[:, None] + np.arange(4)[None]
    written = set()
    for b in range(3):
        for p in positions[b]:
            pb = c["bt"][b, min(p // 8, 3)]
            if pb >= 0:
                written.add((int(pb), int(p % 8)))
    for pb in range(NB):
        for off in range(8):
            if (pb, off) not in written:
                assert torch.equal(tc["k"][:, pb, off], before["k"][:, pb, off])
                assert tc["pos"][pb, off] == before["pos"][pb, off]
    assert (tc["pos"][NB] >= 0).any()          # the empty slot's rows went there
    _, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(toks),
                                     {n: jnp.asarray(x) for n, x in c.items()},
                                     jnp.asarray(seq))
    np.testing.assert_array_equal(tc["pos"].numpy()[:NB], np.asarray(jc["pos"]))


def test_init_paged_cache_has_one_trash_block():
    tm = DecoderLM(TR.get_smoke_config("opt-6.7b"))
    c = tm.init_paged_cache(6, 8, device="cpu")
    a = tm.cfg.attn
    assert c["k"].shape == (tm.cfg.n_layers, 7, 8, a.n_kv_heads, a.head_dim)
    assert c["pos"].shape == (7, 8) and (c["pos"] == -1).all()
    jc = JDecoderLM(JR.get_smoke_config("opt-6.7b")).init_paged_cache(6, 8)
    assert tuple(jc["k"].shape) == (tm.cfg.n_layers, 6, 8, a.n_kv_heads, a.head_dim)
