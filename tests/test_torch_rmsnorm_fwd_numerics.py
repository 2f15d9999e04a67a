"""The arithmetic of K5's forward (``csrc/rmsnorm.cu``, ``rmsnorm_fwd_kernel``),
emulated on the CPU and held against JAX's ``rms_norm``
(``repro.models.common``), the TPU kernel ``rmsnorm_pallas`` in interpret
mode and the port's plain ``ref.rmsnorm_ref``, on the same numpy-seeded
inputs.

The forward gives each group of ``lanes`` threads one row; thread t of a
group owns accesses j = t + k * lanes (k < chunks) of the row, ``vec``
values each.  A row's sum of squares, in
fp64, is each thread's own sum over its accesses in order, a butterfly of
shuffles over the group's lanes inside a warp, then the group's warps in
order; the mean is rounded once to fp32, then ``rstd = rsqrt(mean + eps)``
and ``y = (x * rstd).to(x.dtype) * gamma`` in fp32.  The emulation follows
that order (a square of an fp32 value is exact in fp64, so its multiply
and add give the kernel's fused ones bit for bit; torch's ``rsqrt`` stands
for the card's ``rsqrtf``); ``chip_smoke.py`` holds the kernel itself on
the card, and there also a row's bits against calls of other sizes.

Also here: the grid rule ``fwd_plan`` as a plain function of shapes (rows
covered once, instances the source builds, forced entries, the memoised
``fwd_grid``), and the wrapper's arguments and refusals through stand-ins
for the card.

Tolerances: fp32 1e-5 absolute plus relative (``chip_smoke.TOL``: the same
fp32 arithmetic, only the summation order and the reciprocal square root
differ); bf16 1e-2 (the output is rounded to bf16, 2^-9 relative, and a
last-place change of rstd can move the rounding of ``x * rstd`` by one bf16
place before the product with gamma).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models import common as jcm
from repro_torch.kernels import build, ref
from repro_torch.kernels import rmsnorm as K5
from tools import rmsnorm_variants
from tools.rmsnorm_variants import legal_fwd_plans

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
EPS = 1e-6
DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [128, 768, 1000, 1001, 2048, 4096]


@pytest.fixture(scope="module", autouse=True)
def one_thread_for_the_module():
    """Small CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(n, d, seed):
    """phase 2c's distributions: x of scale 3, gamma near 1."""
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((n, d))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, gamma


def butterfly(v: torch.Tensor, width: int) -> torch.Tensor:
    """``__shfl_xor_sync`` sums over the last dim (``width`` lanes of one
    group, at most a warp): offsets 16, 8, ... 1, each only where it is
    below the group's width, as the kernel's loop; a + b and b + a are
    equal, so every lane holds the same sum."""
    idx = torch.arange(width)
    o = 16
    while o >= 1:
        if o < width:
            v = v + v.index_select(-1, idx ^ o)
        o //= 2
    return v


def emulate_fwd(x: torch.Tensor, gamma: torch.Tensor, plan: dict):
    """The forward at ``plan``: y [n, d] in x's dtype and rstd [n] fp32,
    every group's row at once."""
    n, d = x.shape
    dt = x.dtype
    vec, lanes, chunks = (plan[k] for k in ("vec", "lanes", "chunks"))
    # cols[k, t, e]: the column of value e of thread t's access k
    cols = ((torch.arange(lanes)[None, :, None] + lanes * torch.arange(chunks)[:, None, None])
            * vec + torch.arange(vec)[None, None, :])
    valid = cols < d
    cidx = cols.clamp(max=d - 1)
    x32, g32 = x.float(), gamma.float()
    x64 = x32.double()
    xv = x32[:, cidx]                          # [n, chunks, lanes, vec]
    x2 = x64[:, cidx]
    ss = torch.zeros((n, lanes), dtype=torch.float64)
    for k in range(chunks):                    # each thread's own sum, in access order
        for e in range(vec):
            v = x2[:, k, :, e]
            ss = ss + torch.where(valid[k, :, e], v * v, 0.0)
    w = min(lanes, 32)
    ss = butterfly(ss.reshape(n, lanes // w, w), w)[:, :, 0]
    tot = ss[:, 0] if lanes <= 32 else torch.zeros(n, dtype=torch.float64)
    if lanes > 32:
        for wi in range(lanes // 32):          # the group's warps in order
            tot = tot + ss[:, wi]
    rstd = torch.rsqrt((tot / d).float() + EPS)
    out = (xv * rstd[:, None, None, None]).to(dt).float() * g32[cidx]
    y = torch.empty((n, d), dtype=dt)
    for k in range(chunks):
        for e in range(vec):
            ok = valid[k, :, e]
            y[:, cols[k, ok, e]] = out[:, k, ok, e].to(dt)
    return y, rstd


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= tol + tol * np.abs(want)), float(err.max())


def _as(a: np.ndarray, dt: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dt)


def _jnp(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 through fp32,
    which holds every bf16 value)."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "bf16"])
def test_emulation_matches_jax_pallas_and_plain(d, dt):
    n = 24
    x, g = make_inputs(n, d, seed=d + (0 if dt == torch.float32 else 1))
    tx, tg = _as(x, dt), _as(g, dt)
    plan = K5.fwd_plan(n, d, tx.element_size())
    assert plan["vec"] == (1 if d % (16 // tx.element_size()) else 16 // tx.element_size())
    y, rstd = emulate_fwd(tx, tg, plan)
    assert y.dtype == dt and rstd.dtype == torch.float32
    tol = TOL[dt]
    wants = [ref.rmsnorm_ref(tx, tg).float().numpy(),
             np.asarray(jcm.rms_norm(_jnp(tx), _jnp(tg)), np.float32),
             np.asarray(rmsnorm_pallas(_jnp(tx), _jnp(tg), interpret=True), np.float32)]
    for want in wants:
        close(y.float().numpy(), want, tol)
    close(rstd.numpy(), torch.rsqrt(tx.float().square().mean(-1) + EPS).numpy(), 1e-5)


def _plans_for(d, es):
    """Every plan fwd_plan can choose for d: its rule at n = 1, 37 and 512
    and every forced lanes and block the sweep forces."""
    plans = {}
    for n in (1, 37, 512):
        for p in [K5.fwd_plan(n, d, es)] + list(legal_fwd_plans(K5, n, d, es)):
            plans[(p["lanes"], p["gpb"])] = p
    return plans


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dt", DTYPES, ids=["fp32", "bf16"])
def test_a_rows_bits_do_not_depend_on_n(d, dt):
    """Every row gives the same bits in a call of 1, 37 or 512 rows, under
    every plan: the summation order follows lanes and the accesses, which
    d, the dtype and the alignment set, and groups a block only move a row
    to another block."""
    x, g = make_inputs(512, d, seed=7 * d)
    tx, tg = _as(x, dt), _as(g, dt)
    es = tx.element_size()
    by_lanes = {}
    for (lanes, gpb), forced in _plans_for(d, es).items():
        outs = {}
        for n in (1, 37, 512):
            plan = K5.fwd_plan(n, d, es, True, lanes, gpb)
            assert (plan["lanes"], plan["chunks"]) == (forced["lanes"], forced["chunks"])
            outs[n] = emulate_fwd(tx[:n].contiguous(), tg, plan)
        for n in (1, 37):
            assert torch.equal(outs[n][0], outs[512][0][:n])
            assert torch.equal(outs[n][1], outs[512][1][:n])
        # groups a block do not change a row's bits either
        prev = by_lanes.setdefault(lanes, outs[512])
        assert torch.equal(prev[0], outs[512][0]) and torch.equal(prev[1], outs[512][1])
        close(outs[512][0].float().numpy(), ref.rmsnorm_ref(tx, tg).float().numpy(), TOL[dt])
    # and the rule's own choice for d is the same at every n
    assert len({(K5.fwd_plan(n, d, es)["lanes"], K5.fwd_plan(n, d, es)["chunks"])
                for n in (1, 37, 512, 100000)}) == 1


@pytest.mark.parametrize("d", WIDTHS)
def test_the_fp64_sum_leaves_rstd_to_no_summation_order(d):
    """With the squares summed in fp64, every lanes a group gives every
    row the rstd of the exact mean rounded once to fp32: the order no
    longer shows in the fp32 mean, where an fp32 sum's did."""
    x, g = make_inputs(64, d, seed=5 * d)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    want = torch.rsqrt((tx.double().square().sum(-1) / d).float() + EPS)
    for lanes in sorted({p["lanes"] for p in legal_fwd_plans(K5, 64, d, 4)}):
        _, rstd = emulate_fwd(tx, tg, K5.fwd_plan(64, d, 4, True, lanes))
        assert torch.equal(rstd, want), lanes


def test_one_value_accesses_and_unaligned_bases():
    """d whose rows are not 16-byte multiples, or an unaligned base: one
    value an access, still within the tolerance of the plain version."""
    for n, d, dt, aligned in [(9, 1001, torch.float32, True), (20, 333, torch.bfloat16, True),
                              (16, 256, torch.float32, False)]:
        x, g = make_inputs(n, d, seed=d)
        tx, tg = _as(x, dt), _as(g, dt)
        plan = K5.fwd_plan(n, d, tx.element_size(), aligned)
        assert plan["vec"] == 1 and plan["chunks"] * plan["lanes"] >= d
        y, _ = emulate_fwd(tx, tg, plan)
        close(y.float().numpy(), ref.rmsnorm_ref(tx, tg).float().numpy(), TOL[dt])


# ---------------------------------------------------------------------------
# the grid rule


@pytest.mark.parametrize("n", [1, 7, 37, 128, 1024, 8192, 16385])
@pytest.mark.parametrize("d", [16, 128, 768, 1000, 1001, 2048, 4096, 8192])
@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_row_once(n, d, elem_bytes, aligned):
    """The blocks' groups, one row each, cover rows 0..n-1 once each, in
    order, and no block is empty; a group's lanes cover the row's columns;
    the instance is one the source builds; one device kernel; the
    order-setting entries do not follow n."""
    p = K5.fwd_plan(n, d, elem_bytes, aligned)
    assert p == K5.fwd_plan(n, d, elem_bytes, aligned)
    rows = [r for b in range(p["blocks"]) for g in range(p["gpb"])
            for r in [b * p["gpb"] + g] if r < n]
    assert rows == list(range(n))
    assert (p["blocks"] - 1) * p["gpb"] < n <= p["blocks"] * p["gpb"]
    assert p["threads"] == p["lanes"] * p["gpb"] <= K5.FWD_THREADS and p["threads"] % 32 == 0
    assert p["lanes"] & (p["lanes"] - 1) == 0 and 1 <= p["lanes"] <= K5.FWD_THREADS
    vw = 16 // elem_bytes
    assert p["vec"] == (vw if aligned and d % vw == 0 else 1)
    assert p["chunks"] in K5.FWD_CHUNKS[p["vec"]] and p["chunks"] * p["lanes"] * p["vec"] >= d
    assert p["instance"] == (p["vec"], p["chunks"]) and p["device_kernels"] == 1
    one = K5.fwd_plan(1, d, elem_bytes, aligned)
    assert (one["vec"], one["lanes"], one["chunks"]) == (p["vec"], p["lanes"], p["chunks"])


def _source_instances():
    """(vec > 1, chunks) of every ``rmsnorm_fwd_kernel`` instance the
    source's dispatch names, per element size."""
    src = (build.CSRC / "rmsnorm.cu").read_text()
    body = src[src.index("FwdKernel fwd_kernel(bool vec, int chunks) {"):]
    body = body[:body.index("\n}\n")]
    vec_part, one_part = body.split("return nullptr;\n  }", 1)
    pat = r"case (\d+):(\s*if constexpr \(VW == 4\))?"
    vec_cases = [(int(c), bool(only4)) for c, only4 in re.findall(pat, vec_part)]
    one_cases = [int(c) for c, _ in re.findall(pat, one_part)]
    return {4: sorted(c for c, _ in vec_cases), 8: sorted(c for c, o in vec_cases if not o),
            1: sorted(one_cases)}


def test_every_instance_the_plan_can_name_is_built():
    """``FWD_CHUNKS`` is the source's dispatch, and every plan for d up to
    MAX_D names one of its instances."""
    built = _source_instances()
    assert {v: list(c) for v, c in K5.FWD_CHUNKS.items()} == built
    for es in (4, 2):
        for d in list(range(1, 300)) + [767, 768, 1000, 1001, 2047, 2048, 4095, 4096, 8191,
                                        8192]:
            for aligned in (True, False):
                p = K5.fwd_plan(5, d, es, aligned)
                assert p["chunks"] in built[p["vec"]], (es, d, p)


@pytest.mark.parametrize("n,d,elem_bytes,want", [
    (8192, 128, 2, dict(vec=8, lanes=16, chunks=1, gpb=8, blocks=1024)),
    (2048, 128, 2, dict(vec=8, lanes=16, chunks=1, gpb=8, blocks=256)),
    (512, 128, 2, dict(vec=8, lanes=16, chunks=1, gpb=8, blocks=64)),
    (16384, 128, 4, dict(vec=4, lanes=8, chunks=4, gpb=16, blocks=1024)),
    (1024, 4096, 2, dict(vec=8, lanes=256, chunks=2, gpb=1, blocks=1024)),
    (32, 4096, 2, dict(vec=8, lanes=256, chunks=2, gpb=1, blocks=32)),
    (1024, 2048, 4, dict(vec=4, lanes=128, chunks=4, gpb=1, blocks=1024)),
    (1024, 2048, 2, dict(vec=8, lanes=128, chunks=2, gpb=1, blocks=1024)),
    (1024, 768, 4, dict(vec=4, lanes=64, chunks=4, gpb=2, blocks=512)),
    (16, 768, 2, dict(vec=8, lanes=128, chunks=1, gpb=1, blocks=16)),
    (257, 1000, 4, dict(vec=4, lanes=64, chunks=4, gpb=2, blocks=129)),
    (257, 1001, 2, dict(vec=1, lanes=256, chunks=4, gpb=1, blocks=257)),
    (2048, 4096, 4, dict(vec=4, lanes=256, chunks=4, gpb=1, blocks=2048)),
])
def test_plan_at_phase_2c_cases(n, d, elem_bytes, want):
    p = K5.fwd_plan(n, d, elem_bytes)
    assert {k: p[k] for k in want} == want


def test_forced_entries_are_honoured_or_refused():
    p = K5.fwd_plan(1000, 128, 2, True, lanes=8, gpb=4)
    assert (p["lanes"], p["chunks"], p["gpb"]) == (8, 2, 4)
    assert p["blocks"] == 250 and p["threads"] == 32
    for kw, match in [(dict(lanes=24), "power of two"), (dict(lanes=512), "power of two"),
                      (dict(lanes=1), "no forward kernel"),
                      (dict(lanes=64, gpb=8), "at most 256 threads")]:
        with pytest.raises(ValueError, match=match):
            K5.fwd_plan(1000, 2048, 4, True, **kw)
    with pytest.raises(ValueError, match="whole warps"):
        K5.fwd_plan(1000, 128, 2, True, lanes=8, gpb=2)


def test_forced_sweep_plans_are_legal():
    """The plans ``tools/rmsnorm_variants.py --fwd`` forces."""
    plans = list(legal_fwd_plans(K5, 8192, 128, 2))
    keys = {(p["lanes"], p["threads"]) for p in plans}
    assert len(keys) == len(plans) and {p["lanes"] for p in plans} == {4, 8, 16}
    for p in plans:
        assert p["chunks"] * p["lanes"] * p["vec"] >= 128 and p["threads"] <= K5.FWD_THREADS


@pytest.mark.parametrize("name", sorted({**rmsnorm_variants.VARIANTS,
                                         **rmsnorm_variants.FWD_VARIANTS}))
def test_every_sweep_variant_applies_to_the_source(name):
    """Each source variant the sweep builds on the card finds each of its
    substitution targets exactly once in ``csrc/rmsnorm.cu`` (``base``,
    none, is the source as it is)."""
    subs = {**rmsnorm_variants.VARIANTS, **rmsnorm_variants.FWD_VARIANTS}[name]
    src = (build.CSRC / "rmsnorm.cu").read_text()
    out = rmsnorm_variants.variant_source(src, name, subs)
    assert (out != src) == bool(subs)


# ---------------------------------------------------------------------------
# the wrapper, through stand-ins for the card


def _stand_in_for_the_card(monkeypatch, calls):
    def fake_invoke(entry, dev, *args):
        calls.append(args)
        return 0
    monkeypatch.setattr(K5, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K5, "invoke", fake_invoke)
    monkeypatch.setattr(K5.FWD, "launches", K5.FWD.launches)


@pytest.mark.parametrize("n,d,dt,save", [(8192, 128, torch.bfloat16, False),
                                         (33, 1001, torch.bfloat16, True),
                                         (1024, 2048, torch.float32, True)])
def test_wrapper_hands_the_kernel_its_plan(monkeypatch, n, d, dt, save):
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    x, gamma = torch.zeros((n, d), dtype=dt), torch.ones(d, dtype=dt)
    before = K5.FWD.launches
    y, rstd = K5.rmsnorm_fwd_cuda(x, gamma, 1e-5, save_rstd=save)
    assert y.shape == (n, d) and y.dtype == dt and K5.FWD.launches == before + 1
    assert (rstd is not None) == save and (rstd is None or rstd.shape == (n,))
    (a,) = calls
    plan = K5.fwd_plan(n, d, x.element_size())
    # (dtype, x, gamma, y, rstd, n, d, eps, vec, lanes, chunks, gpb)
    assert a[0] == (0 if dt == torch.float32 else 1)
    assert a[1:4] == (x.data_ptr(), gamma.data_ptr(), y.data_ptr())
    assert a[4] == (rstd.data_ptr() if save else None)
    assert a[5:8] == (n, d, 1e-5) and a[8:] == tuple(plan[k] for k in K5.FWD_ARGS)


def test_wrapper_passes_one_value_accesses_for_an_unaligned_base(monkeypatch):
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    n, d = 16, 256
    x = torch.zeros(n * d + 1)[1:].view(n, d)   # 4 bytes past a 16-byte boundary
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    K5.rmsnorm_fwd_cuda(x, torch.ones(d))
    (a,) = calls
    assert a[8:] == tuple(K5.fwd_plan(n, d, 4, aligned=False)[k] for k in K5.FWD_ARGS)
    assert a[8] == 1


def test_wrapper_reads_the_memoised_grid(monkeypatch):
    """The wrapper's plan is one lookup a call: ``fwd_grid`` is computed
    once per (d, element size, alignment), whatever n."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    K5.fwd_grid.cache_clear()
    for n in (1, 16, 512, 16):
        K5.rmsnorm_fwd_cuda(torch.zeros((n, 4096), dtype=torch.bfloat16),
                            torch.ones(4096, dtype=torch.bfloat16))
    info = K5.fwd_grid.cache_info()
    assert (info.misses, info.hits) == (1, 3)
    assert len({a[8:] for a in calls}) == 1


@pytest.mark.parametrize("bad,match", [
    ("cpu_tensor", "CUDA device"), ("dtype", "dtype"), ("gamma", "gamma"),
    ("too_wide", "d <="), ("noncontig", "contiguous"), ("empty", "0 < d")])
def test_wrapper_refuses_what_the_kernel_cannot_take(bad, match):
    """On a CPU tensor the kernel's wrapper raises (only ``ops.rmsnorm``
    takes the plain version there), and it refuses what the kernel cannot
    take before any launch."""
    x, g = torch.randn(4, 64), torch.ones(64)
    if bad == "dtype":
        x, g = x.double(), g.double()
    elif bad == "gamma":
        g = torch.ones(32)
    elif bad == "too_wide":
        x, g = torch.randn(2, K5.MAX_D + 1), torch.ones(K5.MAX_D + 1)
    elif bad == "noncontig":
        x = torch.randn(64, 4).T
    elif bad == "empty":
        x = torch.randn(0, 64)
    launches = K5.FWD.launches
    with pytest.raises(ValueError, match=match):
        K5.rmsnorm_fwd_cuda(x, g)
    assert K5.FWD.launches == launches
