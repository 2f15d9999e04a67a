"""The arithmetic of K5's backward (``csrc/rmsnorm.cu``), emulated on the CPU
and held against the port's plain backward ``ref.rmsnorm_bwd_ref``, torch
autograd through the plain forward, and ``jax.vjp`` of the JAX model's
``rms_norm`` (``repro.models.common``), on the same numpy-seeded inputs.

The backward is two device kernels.  The rows kernel gives each unit of
``wpr`` warps a contiguous range of ``rpu`` rows; thread t of a unit owns
accesses j = t + k * 32 * wpr (k < chunks) of every row, ``vec`` values
each, and keeps their fp32 dgamma partial across the unit's rows.  A row's
sum of g * xh is each thread's own sum over its accesses in order, a
butterfly of shuffles inside each warp, then the unit's warps in order.
Each unit writes its partial once, row u of a [units, ldp] scratch.  The
combine gives each block ``strip`` 4-column groups x (256 / strip) row
groups: thread (rg, c) adds partial rows rg, rg + groups, ... in order, a
butterfly adds the row groups inside a warp, and the 8 warps are added in
order.  The emulation follows that order in fp32 (a multiply and an add
where the kernel fuses them, so it is not bit for bit the kernel's);
``chip_smoke.py`` holds the kernel itself on the card.

Also here: the grid rule ``bwd_plan`` as a plain function of shapes, and the
wrapper's scratch, arguments and refusals through stand-ins for the card.

Tolerances: fp32 1e-4 absolute plus relative (``chip_smoke.GRAD_TOL``:
sums over up to 4099 rows in another order); bf16 1e-2 against the plain
backward on the same bf16 inputs (only the summation order and the final
rounding differ; against fp32 autograd the bf16 rounding of xh alone moves
a near-zero dgamma entry by about 0.03).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as K5
from tools.rmsnorm_variants import legal_plans

SMS = 132                 # an H100's SMs, for the grid rule
TOL = 1e-4                # fp32 grads
BF16_TOL = 1e-2           # bf16 grads against the bf16 plain backward
EPS = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread_for_the_module():
    """Small CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(n, d, seed):
    """phase 2c's distributions: x of scale 3, gamma near 1, dy unit normal."""
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((n, d))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return x, gamma, dy


def round_to(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return v.to(dt).float()


def butterfly(v: torch.Tensor, lanes_dim: int, width: int, stop: int = 1) -> torch.Tensor:
    """``__shfl_xor_sync`` sums over the last ``width`` positions of dim
    ``lanes_dim`` grouped by 32 lanes: offsets 16, 8, ... down to ``stop``
    (in lane units), as the kernel's loops; a + b and b + a are equal, so
    every lane holds the same sum."""
    idx = torch.arange(width)
    o = 16
    while o >= stop:
        v = v + v.index_select(lanes_dim, idx ^ o)
        o //= 2
    return v


def emulate_rows(x, gamma, dy, rstd, plan):
    """The rows kernel at ``plan``: dx [n, d] in x's dtype and the fp32
    partials [units, ldp] (NaN in the pad columns, which it never writes)."""
    n, d = x.shape
    dt = x.dtype
    vec, wpr, chunks, rpu, units = (plan[k] for k in ("vec", "wpr", "chunks", "rpu", "units"))
    G = 32 * wpr
    # cols[k, t, e]: the column of value e of thread t's access k
    cols = ((torch.arange(G)[None, :, None] + G * torch.arange(chunks)[:, None, None]) * vec
            + torch.arange(vec)[None, None, :])
    valid = cols < d
    cidx = cols.clamp(max=d - 1)
    x32, dy32, g32 = x.float(), dy.float(), gamma.float()
    dg = torch.zeros((units, chunks, G, vec))
    dx = torch.empty((n, d), dtype=dt)
    for i in range(rpu):                        # each unit's i-th row, all units at once
        rows = torch.arange(units) * rpu + i
        live = rows < torch.minimum(torch.full_like(rows, n), (torch.arange(units) + 1) * rpu)
        rr = rows[live]
        xv = x32[rr][:, cidx]                   # [u, chunks, G, vec]
        dyv = dy32[rr][:, cidx]
        rs = rstd[rr][:, None, None, None]
        xh = xv * rs
        g = round_to(dyv * g32[cidx], dt)
        m = valid[None].expand_as(xh)
        dg[live] += torch.where(m, dyv * round_to(xh, dt), 0.0)
        dot = torch.zeros((rr.numel(), G))
        for k in range(chunks):                 # each thread's own sum, in access order
            for e in range(vec):
                dot = dot + torch.where(valid[k, :, e], g[:, k, :, e] * xh[:, k, :, e], 0.0)
        dot = butterfly(dot.reshape(-1, wpr, 32), 2, 32)[:, :, 0]
        tot = torch.zeros(rr.numel())
        for w in range(wpr):                    # the unit's warps in order
            tot = tot + dot[:, w]
        mean = (tot / d)[:, None, None, None]
        out = (rs * (g - xh * mean)).to(dt)
        for k in range(chunks):
            for e in range(vec):
                ok = valid[k, :, e]
                dx[rr[:, None], cols[k, ok, e][None, :]] = out[:, k, ok, e]
    part = torch.full((units, plan["ldp"]), float("nan"))
    for k in range(chunks):
        for e in range(vec):
            ok = valid[k, :, e]
            part[:, cols[k, ok, e]] = dg[:, k, ok, e]
    return dx, part


def emulate_combine(part, d, strip, dt):
    """The dgamma combine: fp32 sums of the partials' columns in the
    kernel's order, cast to gamma's dtype."""
    units, ldp = part.shape
    groups = K5.COMBINE_THREADS // strip
    p4 = part.reshape(units, ldp // 4, 4)
    s = torch.zeros((groups, ldp // 4, 4))
    for j in range(-(-units // groups)):        # thread (rg, c): rows rg + j * groups, in order
        rows = torch.arange(groups) + j * groups
        ok = rows < units
        s[ok] = s[ok] + p4[rows[ok]]
    per_warp = 32 // strip                      # row groups of one warp
    idx = torch.arange(groups)
    m = per_warp // 2
    while m >= 1:                               # lane offsets 16 .. strip
        s = s + s[idx ^ m]
        m //= 2
    tot = s[0]
    for w in range(1, K5.COMBINE_THREADS // 32):
        tot = tot + s[w * per_warp]
    return tot.reshape(-1)[:d].to(dt)


def emulate_bwd(x, gamma, dy, sms=SMS, aligned=True):
    n, d = x.shape
    plan = K5.bwd_plan(n, d, sms, x.element_size(), aligned)
    rstd = torch.rsqrt(x.float().square().mean(-1) + EPS)    # the forward's rstd
    dx, part = emulate_rows(x, gamma, dy, rstd, plan)
    return dx, emulate_combine(part, d, plan["strip"], gamma.dtype), plan, part


def jax_grads(x, gamma, dy):
    _, vjp = jax.vjp(jcm.rms_norm, jnp.asarray(x), jnp.asarray(gamma))
    return [np.asarray(g, dtype=np.float32) for g in vjp(jnp.asarray(dy))]


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= tol + tol * np.abs(want)), float(err.max())


# (n, d): rows that fill no unit evenly, widths with ragged last accesses
# (d 1000: 250 accesses over 64 threads), 2048 (the trainer), 768 (the draft)
FP32_SHAPES = [(7, 64), (128, 768), (257, 1000), (96, 2048), (300, 24)]


@pytest.mark.parametrize("n,d", FP32_SHAPES)
def test_fp32_emulation_matches_plain_autograd_and_jax(n, d):
    x, g, dy = make_inputs(n, d, seed=n + d)
    tx, tg, tdy = (torch.from_numpy(a) for a in (x, g, dy))
    dx, dgamma, plan, _ = emulate_bwd(tx, tg, tdy)
    assert plan["vec"] == 4
    leaf = [tx.clone().requires_grad_(True), tg.clone().requires_grad_(True)]
    for want in (ref.rmsnorm_bwd_ref(tx, tg, tdy),
                 torch.autograd.grad(ref.rmsnorm_ref(*leaf), leaf, tdy),
                 jax_grads(x, g, dy)):
        close(dx.numpy(), np.asarray(want[0]), TOL)
        close(dgamma.numpy(), np.asarray(want[1]), TOL)


@pytest.mark.parametrize("n,d", [(64, 2048), (33, 768), (257, 1000)])
def test_bf16_emulation_matches_the_bf16_plain_backward(n, d):
    x, g, dy = make_inputs(n, d, seed=3 * n + d)
    tx, tg, tdy = (torch.from_numpy(a).bfloat16() for a in (x, g, dy))
    dx, dgamma, plan, _ = emulate_bwd(tx, tg, tdy)
    assert plan["vec"] == 8 and dx.dtype == dgamma.dtype == torch.bfloat16
    wdx, wdg = ref.rmsnorm_bwd_ref(tx, tg, tdy)
    close(dx.float().numpy(), wdx.float().numpy(), BF16_TOL)
    close(dgamma.float().numpy(), wdg.float().numpy(), BF16_TOL)


@pytest.mark.parametrize("n,d,dt", [(9, 1001, torch.float32), (20, 333, torch.bfloat16)])
def test_one_value_accesses_for_widths_16_bytes_cannot_take(n, d, dt):
    """d whose rows are not 16-byte multiples: one value an access."""
    x, g, dy = make_inputs(n, d, seed=d)
    tx, tg, tdy = (torch.from_numpy(a).to(dt) for a in (x, g, dy))
    dx, dgamma, plan, _ = emulate_bwd(tx, tg, tdy)
    assert plan["vec"] == 1
    wdx, wdg = ref.rmsnorm_bwd_ref(tx, tg, tdy)
    tol = TOL if dt == torch.float32 else BF16_TOL
    close(dx.float().numpy(), wdx.float().numpy(), tol)
    close(dgamma.float().numpy(), wdg.float().numpy(), tol)


def test_unaligned_bases_take_one_value_accesses():
    plan = K5.bwd_plan(64, 2048, SMS, 4, aligned=False)
    assert plan["vec"] == 1 and plan["chunks"] * 32 * plan["wpr"] >= 2048


def test_pad_columns_never_reach_dgamma():
    """The partials' pad columns (d up to ldp) are never written; NaN there
    stays out of dgamma."""
    x, g, dy = make_inputs(40, 1001, seed=5)
    dx, dgamma, plan, part = emulate_bwd(*(torch.from_numpy(a) for a in (x, g, dy)))
    assert plan["ldp"] == 1004 and torch.isnan(part[:, 1001:]).all()
    assert torch.isfinite(dgamma).all() and torch.isfinite(part[:, :1001]).all()


@pytest.mark.parametrize("sms", [132, 16, 1])
def test_result_does_not_depend_on_the_grid_beyond_rounding(sms):
    """Other SM counts give other grids (units, strips) and other summation
    orders, all within the fp32 tolerance of the plain backward."""
    x, g, dy = make_inputs(300, 768, seed=11)
    tx, tg, tdy = (torch.from_numpy(a) for a in (x, g, dy))
    dx, dgamma, _, _ = emulate_bwd(tx, tg, tdy, sms=sms)
    wdx, wdg = ref.rmsnorm_bwd_ref(tx, tg, tdy)
    close(dx.numpy(), wdx.numpy(), TOL)
    close(dgamma.numpy(), wdg.numpy(), TOL)


def test_emulation_is_deterministic():
    x, g, dy = make_inputs(100, 2048, seed=2)
    a = emulate_bwd(*(torch.from_numpy(v) for v in (x, g, dy)))
    b = emulate_bwd(*(torch.from_numpy(v) for v in (x, g, dy)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the grid rule


@pytest.mark.parametrize("n", [1, 7, 128, 1024, 4099])
@pytest.mark.parametrize("d", [64, 768, 1000, 2048, 8192])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_plan_covers_every_row_and_column_once(n, d, elem_bytes):
    """Units cover rows 0..n-1 once each, in order, none empty; the blocks
    hold the units; a unit's threads cover the row's columns; the combine
    covers the columns; the scratch has a row a unit; same shapes, same
    plan."""
    p = K5.bwd_plan(n, d, SMS, elem_bytes)
    assert p == K5.bwd_plan(n, d, SMS, elem_bytes)
    rows = [r for u in range(p["units"]) for r in range(u * p["rpu"], min(n, (u + 1) * p["rpu"]))]
    assert rows == list(range(n))
    assert all(u * p["rpu"] < n for u in range(p["units"]))
    assert (p["blocks"] - 1) * p["upb"] < p["units"] <= p["blocks"] * p["upb"]
    assert p["wpr"] * p["upb"] <= K5.BLOCK_WARPS and p["threads"] == 32 * p["wpr"] * p["upb"]
    assert p["vec"] == 16 // elem_bytes and d % p["vec"] == 0
    assert p["chunks"] in K5.CHUNKS[p["vec"]] and p["chunks"] * 32 * p["wpr"] * p["vec"] >= d
    assert p["ldp"] % 4 == 0 and d <= p["ldp"] < d + 4
    assert p["combine_blocks"] * p["strip"] * 4 >= p["ldp"]
    assert p["strip"] in (1, 2, 4, 8, 16, 32) and p["partial_rows"] == p["units"]
    assert p["device_kernels"] == 2


@pytest.mark.parametrize("n,d,elem_bytes,want", [
    (1024, 2048, 4, dict(wpr=8, chunks=2, rpu=4, units=256, blocks=256, strip=2)),
    (1024, 768, 4, dict(wpr=4, chunks=2, rpu=2, units=512, blocks=512, strip=2)),
    (1024, 2048, 2, dict(wpr=8, chunks=1, rpu=4, units=256, blocks=256, strip=2)),
    (128, 2048, 4, dict(wpr=8, chunks=2, rpu=1, units=128, blocks=128, strip=2)),
    (257, 1000, 4, dict(wpr=4, chunks=2, rpu=1, units=257, blocks=257, strip=2)),
    (16, 64, 4, dict(wpr=1, chunks=1, rpu=1, units=16, blocks=16, strip=2)),
    (4, 8192, 4, dict(wpr=8, chunks=8, rpu=1, units=4, blocks=4, strip=2)),
    (4099, 8192, 4, dict(wpr=8, chunks=8, rpu=16, units=257, blocks=257)),
])
def test_plan_at_phase_2c_cases(n, d, elem_bytes, want):
    p = K5.bwd_plan(n, d, SMS, elem_bytes)
    assert {k: p[k] for k in want} == want


def test_forced_plans_are_legal():
    """The plans ``tools/rmsnorm_variants.py`` forces in its sweep."""
    plans = list(legal_plans(K5, 1024, 2048, SMS, 4))
    assert len({(p["wpr"], p["rpu"], p["strip"]) for p in plans}) == len(plans) == 60
    for p in plans:
        assert p["chunks"] * 32 * p["wpr"] * p["vec"] >= 2048 and p["chunks"] in K5.CHUNKS[4]
        assert p["wpr"] * p["upb"] <= K5.BLOCK_WARPS


# ---------------------------------------------------------------------------
# the wrapper, through stand-ins for the card


def _stand_in_for_the_card(monkeypatch, calls, empties):
    def fake_invoke(entry, dev, *args):
        calls.append(args)
        return 0
    real_empty = torch.empty

    def spy_empty(*shape, **kw):
        empties.append((tuple(shape[0]) if len(shape) == 1 else shape, kw.get("dtype")))
        return real_empty(*shape, **kw)
    monkeypatch.setattr(K5, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K5, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(K5, "invoke", fake_invoke)
    monkeypatch.setattr(K5.torch, "empty", spy_empty)
    monkeypatch.setattr(K5.BWD, "launches", K5.BWD.launches)


@pytest.mark.parametrize("n,d,dt", [(1024, 2048, torch.float32), (33, 1001, torch.bfloat16)])
def test_wrapper_hands_the_kernel_its_plan(monkeypatch, n, d, dt):
    calls, empties = [], []
    _stand_in_for_the_card(monkeypatch, calls, empties)
    x, gamma, dy = (torch.zeros(s, dtype=dt) for s in ((n, d), (d,), (n, d)))
    rstd = torch.ones(n)
    before = K5.BWD.launches
    dx, dgamma = K5.rmsnorm_bwd_cuda(x, gamma, dy, rstd)
    assert dx.shape == (n, d) and dx.dtype == dt and dgamma.shape == (d,)
    assert K5.BWD.launches == before + 1
    (a,) = calls
    plan = K5.bwd_plan(n, d, SMS, x.element_size())
    assert empties == [((plan["units"], plan["ldp"]), torch.float32)]
    # (dtype, x, gamma, dy, rstd, dx, dgamma, part, n, d, vec, wpr, chunks, upb, rpu,
    #  units, blocks, ldp, strip)
    assert a[0] == (0 if dt == torch.float32 else 1)
    assert a[1:6] == (x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), rstd.data_ptr(),
                      dx.data_ptr())
    assert a[6] == dgamma.data_ptr() and a[8:10] == (n, d)
    assert a[10:] == tuple(plan[k] for k in K5.BWD_ARGS)


def test_wrapper_passes_one_value_accesses_for_an_unaligned_base(monkeypatch):
    calls, empties = [], []
    _stand_in_for_the_card(monkeypatch, calls, empties)
    n, d = 16, 256
    flat = torch.zeros(n * d + 1)
    x = flat[1:].view(n, d)                    # 4 bytes past a 16-byte boundary
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    K5.rmsnorm_bwd_cuda(x, torch.ones(d), torch.zeros(n, d), torch.ones(n))
    (a,) = calls
    assert a[10] == 1
    plan = K5.bwd_plan(n, d, SMS, 4, aligned=False)
    assert a[10:] == tuple(plan[k] for k in K5.BWD_ARGS)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "dtype"), ("dy_shape", "dy must match"), ("dy_dtype", "dy must match"),
    ("gamma", "gamma"), ("too_wide", "d <="), ("noncontig", "contiguous"),
    ("rstd", "rstd must be"), ("empty", "0 < d")])
def test_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch, bad, match):
    calls, empties = [], []
    _stand_in_for_the_card(monkeypatch, calls, empties)
    n, d = 8, 64
    x, g, dy, rstd = torch.randn(n, d), torch.ones(d), torch.randn(n, d), torch.ones(n)
    if bad == "dtype":
        x, g, dy = x.double(), g.double(), dy.double()
    elif bad == "dy_shape":
        dy = torch.randn(n, d + 1)
    elif bad == "dy_dtype":
        dy = dy.bfloat16()
    elif bad == "gamma":
        g = torch.ones(d - 1)
    elif bad == "too_wide":
        x, g, dy = torch.randn(2, K5.MAX_D + 1), torch.ones(K5.MAX_D + 1), torch.randn(
            2, K5.MAX_D + 1)
        rstd = torch.ones(2)
    elif bad == "noncontig":
        x = torch.randn(d, n).T
    elif bad == "rstd":
        rstd = torch.ones(n, dtype=torch.float64)
    elif bad == "empty":
        x, dy, rstd = torch.randn(0, d), torch.randn(0, d), torch.ones(0)
    launches = K5.BWD.launches
    with pytest.raises(ValueError, match=match):
        K5.rmsnorm_bwd_cuda(x, g, dy, rstd)
    assert not calls and K5.BWD.launches == launches


def test_cpu_tensors_are_refused_without_a_fallback():
    """On a CPU tensor the kernel's wrapper raises; only ``ops.rmsnorm``
    takes the plain version there."""
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        K5.rmsnorm_bwd_cuda(x, torch.ones(64), torch.randn(4, 64), torch.ones(4))
