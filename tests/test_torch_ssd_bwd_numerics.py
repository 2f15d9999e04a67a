"""The arithmetic of K6's backward (``csrc/ssd_chunk.cu``, ``ssd_bwd_*``),
emulated on the CPU and held against the port's plain backward
``ref.ssd_chunked_bwd_ref`` evaluated in fp64 and in fp32, and against
``jax.vjp`` of the JAX model's ``Mamba2LM._ssd_chunked``, on the same
numpy-seeded inputs, by phase 2d's fp32 rules.

The kernel runs every product on the tensor cores as m16n8k8 tf32 products
with fp32 accumulators: an fp32 operand enters as big (its low 13 bits
cleared) + small (the rest, read as tf32), three products with small *
small dropped; a bf16 input (x, b, c of the bf16 build) is an exact tf32
operand whose small part is zero, so its product with the other's small
part is all that is left.  The emulation rounds operands so, and follows
the kernel's order:

- S = c b^T once per (batch, chunk, group), read by every head of it;
- key blocks of 64 rows walk the query rows at or after them in stages of
  32: D^T = x_j dy_i^T, the decay masked before its exp, dt_j folded into
  S o L and L o D, dx_j and db_j accumulated stage by stage, L o D o dt of
  each tile pair written once; then dh_out's terms;
- query blocks of 64 rows walk the key rows at or before them in stages of
  32, reading that L o D o dt (D once a tile pair; ``d_once=False``
  recomputes it, as ``tools/ssd_variants.py``'s ``d_twice`` does),
  accumulating dc_i and the row sums of (L o D o dt) o S; then h_in's term;
- a block takes ``heads_per_block`` heads of a group in order and sums
  their db or dc itself: the partials are one per head slab, summed over a
  group's slabs in order; every padded row is a zero row;
- the states of dh, the ordered reverse carry, the reverse cumsum of dcs
  and dA's direct form as the kernel's finish takes them.

It does not model the tensor cores' accumulation order within a product, nor
ex2.approx (torch.exp2 here); ``chip_smoke.py`` holds the kernel itself on
the card.  Also here: the backward's plan as a plain function of shapes.

Rules (phase 2d's fp32 gate): every gradient within 1e-4 of its largest
entry of the fp64 evaluation and of the fp32 plain backward, within 1e-4 of
each head's largest fp64 entry (each group's for dB, dC), and each head's dA
within 1e-4 of the magnitudes of the terms it sums (``ssd_dA_terms``); 1e-4
of each gradient's largest entry against ``jax.vjp``.  bf16 inputs:
elementwise 1e-2 absolute plus relative against the plain backward of the
same bf16 inputs, phase 2d's bf16 rule.
"""
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as K6
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_ssd_backward import NAMES, _jax_vjp, make_inputs
from test_torch_ssd_numerics import bf16, tf32_trunc

GATE = 1e-4              # phase 2d's fp32 rule
BF16_GATE = 1e-2         # phase 2d's bf16 rule
TB = K6.BWD_TILE         # rows of a key or query tile
KS = 32                  # rows of a ring stage
MAXQ = K6.MAX_Q
LOG2E = 1.4426950408889634


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    """``chip_smoke.py`` (phase 2d's per-head measure and dA scale), loaded
    once, at first use."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mm(eq, a, b, route="3xtf32", a_exact=False, b_exact=False):
    """``einsum(eq, a, b)`` as the tensor cores take it: ``3xtf32`` splits
    each fp32 operand into big + small and drops small * small (an exact
    operand's small part is zero: its product is skipped); ``tf32`` reads
    each operand once as tf32.  Products of tf32 values are exact in fp32."""
    ab, bb = tf32_trunc(a), tf32_trunc(b)
    out = torch.einsum(eq, ab, bb)
    if route == "tf32":
        return out
    if not a_exact:
        out = torch.einsum(eq, tf32_trunc(a - ab), bb) + out
    if not b_exact:
        out = torch.einsum(eq, ab, tf32_trunc(b - bb)) + out
    return out


def scan_runs(x):
    """The kernel's inclusive prefix sum of x [..., Q] (Q <= 256): runs of 8
    rows a lane summed in order, then a Hillis-Steele scan of the 32 run
    totals, each run's base added to its running sums.  Returns [..., 256],
    zeros of x past Q (the sums hold their last value)."""
    xz = torch.zeros(x.shape[:-1] + (MAXQ,), dtype=torch.float32)
    xz[..., :x.shape[-1]] = x
    runs = xz.reshape(x.shape[:-1] + (32, 8))
    v = torch.cumsum(runs, -1)
    acc = v[..., -1]
    incl, o = acc.clone(), 1
    while o < 32:
        shifted = torch.zeros_like(incl)
        shifted[..., o:] = incl[..., :-o]
        incl = incl + shifted
        o *= 2
    return ((incl - acc)[..., None] + v).reshape(x.shape[:-1] + (MAXQ,))


def pad(t, rows):
    """``t`` [..., Q, w] with zero rows up to ``rows``."""
    z = torch.zeros(t.shape[:-2] + (rows - t.shape[-2], t.shape[-1]), dtype=t.dtype)
    return torch.cat([t, z], -2)


def emulated_bwd(xh, B_, C_, dt, A, h0, chunk, dy, dh_final, *, route="3xtf32",
                 heads_per_block=None, d_once=True, exact_inputs=False):
    """K6's backward as the kernel computes it.  xh [B,T,H,P], B_/C_ [B,T,G,N]
    (bf16 values for the bf16 build, with ``exact_inputs``), dt [B,T,H], A
    [H], h0 [B,H,P,N] or None, dy [B,T,H,P], dh_final [B,H,P,N] or None.
    Returns (dxh, dB, dC, ddt, dA, dh0 or None) in fp32."""
    Bsz, T, H, P = xh.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = ref.ssd_chunk_len(T, chunk)
    nc, rep, nt = T // Q, H // G, -(-Q // TB)
    hb = heads_per_block or K6.ssd_bwd_plan(Bsz, T, H, G, P, N, Q, h0 is not None)[
        "heads_per_block"]
    R = nt * TB                                      # rows of the chunk's tiles
    EX = exact_inputs
    f32 = torch.float32

    def rows(t, bi, k, idx):                         # chunk k of batch bi, [idx, Q, w] padded
        return pad(t[bi, k * Q:(k + 1) * Q, idx].transpose(0, 1).to(f32), R)

    # the forward's carried-in states (what the forward returns and the backward reads)
    hin_all = _forward_states(xh, B_, C_, dt, A, h0, Q)
    dxh = torch.zeros((Bsz, T, H, P))
    dB = torch.zeros((Bsz, T, G, N))
    dC = torch.zeros((Bsz, T, G, N))
    ddt = torch.zeros((Bsz, T, H))
    dAp = torch.zeros((Bsz, nc, H))
    dh0 = torch.zeros((Bsz, H, P, N)) if h0 is not None else None
    for bi in range(Bsz):
        cs2 = [scan_runs(-dt[bi, k * Q:(k + 1) * Q].T * A[:, None]) * LOG2E for k in range(nc)]
        cds = [scan_runs(dt[bi, k * Q:(k + 1) * Q].T) for k in range(nc)]
        dts = [pad(dt[bi, k * Q:(k + 1) * Q].T[..., None], MAXQ)[..., 0] for k in range(nc)]
        # the states of dh (chunk 0's only with an h0), then the ordered reverse carry
        dstate = [None] * nc
        for k in range(nc):
            if k == 0 and h0 is None:
                continue
            dyk, ck = rows(dy, bi, k, slice(None)), rows(C_, bi, k, slice(None))
            f = torch.exp2(cs2[k][:, :R])                           # [H, R]
            acc = torch.zeros((H, P, N))
            for s0 in range(0, R, KS):
                sl = slice(s0, s0 + KS)
                acc = acc + mm("hip,hin->hpn", (f[:, sl, None] * dyk[:, sl]),
                               ck.repeat_interleave(rep, 0)[:, sl], route, b_exact=EX)
            dstate[k] = acc
        dh = torch.zeros((H, P, N)) if dh_final is None else dh_final[bi].clone()
        dh_out = [None] * nc
        for k in reversed(range(nc)):
            dh_out[k] = None if (k == nc - 1 and dh_final is None) else dh.clone()
            if k == 0 and h0 is None:
                break
            dh = torch.exp2(cs2[k][:, Q - 1])[:, None, None] * dh + dstate[k]
        if h0 is not None:
            dh0[bi] = dh
        for k in range(nc):
            x, g_ = rows(xh, bi, k, slice(None)), rows(dy, bi, k, slice(None))   # [H, R, .]
            b, c = rows(B_, bi, k, slice(None)), rows(C_, bi, k, slice(None))    # [G, R, N]
            hin = None if (k == 0 and h0 is None) else hin_all[bi, k]
            # S once per group (exact bf16 operands on m16n8k16 in the bf16 build)
            S = mm("gin,gjn->gij", c, b, route, a_exact=EX, b_exact=EX)
            c2, cd, d_ = cs2[k], cds[k], dts[k]
            ddir = torch.zeros((H, R))
            wst = torch.zeros((H, R))
            rrow = torch.zeros((H, R))
            urow = torch.zeros((H, R))
            dAt = torch.zeros((H, nt))
            lds = {}
            dbp = torch.zeros((H // hb, R, N))
            dcp = torch.zeros((H // hb, R, N))
            dxk = torch.zeros((H, R, P))
            # key blocks
            for slab in range(H // hb):
                grp = slab * hb // rep
                for jt in range(nt):
                    j0 = jt * TB
                    jj = torch.arange(j0, j0 + TB)
                    db = torch.zeros((TB, N))
                    for h in range(slab * hb, (slab + 1) * hb):
                        xj, bj = x[h, j0:j0 + TB], b[grp, j0:j0 + TB]
                        dx = torch.zeros((TB, P))
                        rs = torch.zeros(TB)
                        tda = torch.zeros(())
                        for i0 in range(j0, Q, KS):
                            ii = torch.arange(i0, i0 + KS)
                            dyi, ci = g_[h, i0:i0 + KS], c[grp, i0:i0 + KS]
                            Dt = mm("jp,ip->ji", xj, dyi, route, a_exact=EX)
                            ok = (ii[None, :] >= jj[:, None]) & (ii[None, :] < Q)
                            L = torch.where(ok, torch.exp2(torch.where(
                                ok, c2[h, ii][None, :] - c2[h, jj][:, None], 0.0)), 0.0)
                            St = torch.where(ok, S[grp, i0:i0 + KS, j0:j0 + TB].T, 0.0)
                            a = St * L
                            tv = a * Dt
                            rs = rs + tv.sum(1)
                            tda = tda + (tv * d_[h, jj][:, None]
                                         * (cd[h, ii][None, :] - cd[h, jj][:, None])).sum()
                            sl = a * d_[h, jj][:, None]
                            ld = L * Dt * d_[h, jj][:, None]
                            it = i0 // TB
                            lds.setdefault((h, it, jt), torch.zeros((TB, TB)))[
                                i0 - it * TB:i0 - it * TB + KS] = ld.T
                            dx = dx + mm("ji,ip->jp", sl, dyi, route)
                            db = db + mm("ji,in->jn", ld, ci, route, b_exact=EX)
                        e = torch.exp2(c2[h, Q - 1] - c2[h, jj])
                        sc = d_[h, jj] * e
                        xb = torch.zeros(TB)
                        if dh_out[k] is not None:
                            bdh = mm("jn,pn->jp", bj, dh_out[k][h], route, a_exact=EX)
                            xb = (xj * bdh).sum(1)
                            dx = dx + sc[:, None] * bdh
                            db = db + mm("jp,pn->jn", sc[:, None] * xj, dh_out[k][h], route)
                        dxk[h, j0:j0 + TB] = dx
                        ddir[h, j0:j0 + TB] = rs + e * xb
                        wst[h, j0:j0 + TB] = sc * xb
                        dAt[h, jt] = tda
                    dbp[slab, j0:j0 + TB] = db
            # query blocks
            for slab in range(H // hb):
                grp = slab * hb // rep
                for it in range(nt):
                    i0 = it * TB
                    ii = torch.arange(i0, i0 + TB)
                    dc = torch.zeros((TB, N))
                    for h in range(slab * hb, (slab + 1) * hb):
                        dyi = g_[h, i0:i0 + TB]
                        rr = torch.zeros(TB)
                        for j0 in range(0, min(Q, i0 + TB), KS):
                            jj = torch.arange(j0, j0 + KS)
                            ok = (jj[None, :] <= ii[:, None]) & (ii[:, None] < Q)
                            if d_once:
                                jt = j0 // TB
                                a = lds[(h, it, jt)][:, j0 - jt * TB:j0 - jt * TB + KS]
                            else:
                                D = mm("ip,jp->ij", dyi, x[h, j0:j0 + KS], route, b_exact=EX)
                                L = torch.exp2(torch.where(
                                    ok, c2[h, ii][:, None] - c2[h, jj][None, :], 0.0))
                                a = L * D * d_[h, jj][None, :]
                            a = torch.where(ok, a, 0.0)
                            rr = rr + (a * torch.where(ok, S[grp, i0:i0 + TB, j0:j0 + KS],
                                                       0.0)).sum(1)
                            dc = dc + mm("ij,jn->in", a, b[grp, j0:j0 + KS], route, b_exact=EX)
                        u = torch.zeros(TB)
                        if hin is not None:
                            f = torch.exp2(c2[h, i0:i0 + TB])
                            hv = mm("ip,pn->in", f[:, None] * dyi, hin[h], route)
                            u = (c[grp, i0:i0 + TB] * hv).sum(1)
                            dc = dc + hv
                        rrow[h, i0:i0 + TB] = rr + u
                        urow[h, i0:i0 + TB] = u
                    dcp[slab, i0:i0 + TB] = dc
            # finish: dcs, its reverse cumsum, ddt and the chunk's dA
            dot = torch.zeros(H) if (dh_out[k] is None or hin is None) else \
                (dh_out[k] * hin).sum((1, 2))
            eterm = torch.exp2(c2[:, Q - 1]) * dot
            cl = cd[:, Q - 1]
            dcs = torch.zeros((H, MAXQ))
            dcs[:, :Q] = rrow[:, :Q] - d_[:, :Q] * ddir[:, :Q]
            dcs[:, Q - 1] += eterm + wst[:, :Q].sum(1)
            dl = torch.flip(scan_runs(torch.flip(dcs, [1])), [1])
            ddt[bi, k * Q:(k + 1) * Q] = (ddir[:, :Q] - A[:, None] * dl[:, :Q]).T
            da = (wst[:, :Q] * (cl[:, None] - cd[:, :Q])).sum(1)
            if hin is not None:
                da = da + (urow[:, :Q] * cd[:, :Q]).sum(1)
            dAp[bi, k] = -(dAt.sum(1) + da + eterm * cl)
            dxh[bi, k * Q:(k + 1) * Q] = dxk[:, :Q].transpose(0, 1)
            # each group's slabs summed in order
            per = (H // hb) // G
            for sl in range(H // hb):
                dB[bi, k * Q:(k + 1) * Q, sl // per] += dbp[sl, :Q]
                dC[bi, k * Q:(k + 1) * Q, sl // per] += dcp[sl, :Q]
    dA = torch.zeros(H)
    for bi in range(Bsz):                            # dA over (batch, chunk) in order
        for k in range(nc):
            dA = dA + dAp[bi, k]
    return dxh, dB, dC, ddt, dA, dh0


def _forward_states(xh, B_, C_, dt, A, h0, Q):
    """Each chunk's carried-in state [B, nc, H, P, N] as the forward keeps
    it (the plain scan's carry; chunk 0's is h0 or zeros)."""
    Bsz, T, H, P = xh.shape
    N = B_.shape[3]
    h = torch.zeros((Bsz, H, P, N)) if h0 is None else h0.clone()
    states = []
    for k in range(T // Q):
        states.append(h)
        sl = slice(k * Q, (k + 1) * Q)
        _, h = ref.ssd_chunked_ref(xh[:, sl].float(), B_[:, sl].float(), C_[:, sl].float(),
                                   dt[:, sl], A, h, Q)
    return torch.stack(states, 1)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (name, B, T, H, P, G, N, chunk, options): phase 2d's smoke widths and mid
# shapes (two whole 64-row tiles, a ragged 150-row chunk, a group of 2 heads)
CASES = [
    ("smoke_widths_t24", 2, 24, 8, 32, 1, 16, 8, dict(h0=True, dh_final=True)),
    ("mid_q128_g2", 1, 256, 4, 16, 2, 32, 128, dict(h0=True, dh_final=True)),
    ("mid_q150_ragged", 1, 300, 4, 16, 1, 32, 256, {}),
    ("mid_strong_decay", 1, 256, 2, 16, 1, 16, 256, dict(strong=True, h0=True,
                                                           dh_final=True)),
]


def _case(case, seed=0):
    _, B, T, H, P, G, N, chunk, opt = case
    arrs = make_inputs(B, T, H, P, G, N, seed=seed + T + H, **opt)
    return arrs, chunk


def gate_errors(got, xh, Bm, Cm, dt, A, hinit, dy, dhf, chunk):
    """Phase 2d's fp32 gate: for each gradient the worst of (its error over
    its largest entry against fp64 and against the fp32 plain backward, its
    worst head's (group's) error over that head's largest fp64 entry, dA's
    against the magnitudes of its terms)."""
    f64 = [None if a is None else torch.from_numpy(a).double()
           for a in (xh, Bm, Cm, dt, A, hinit, dy, dhf)]
    exact = ref.ssd_chunked_bwd_ref(*f64[:6], chunk, f64[6], f64[7])
    plain = ref.ssd_chunked_bwd_ref(*(_t(a) for a in (xh, Bm, Cm, dt, A, hinit)), chunk,
                                    _t(dy), _t(dhf))
    cs = _chip_smoke()
    out = {}
    for n, g, e, w in zip(NAMES, got, exact, plain):
        if e is None:
            assert g is None, n
            continue
        g = g.double()
        worst = max(float((g - e).abs().max() / e.abs().max()),
                    float((g - w.double()).abs().max() / w.double().abs().max()))
        scale = None if n != "dA" else cs.ssd_dA_terms(
            f64[0], f64[3], f64[4], exact[0], exact[3]).abs().sum((0, 1))
        heads = cs.per_head_rel(torch, g, e, cs.SSD_GRAD_HEAD_AXIS[n], scale)
        out[n] = max(worst, float(heads.max()))
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_backward_meets_phase_2d_fp32_gate(case):
    """Three tf32 products, S once a group, D once a tile pair and the plan's
    head slabs: every gradient within 1e-4 of its max (fp64 and fp32 plain),
    of each head's (group's), and dA within 1e-4 of its terms, per head."""
    arrs, chunk = _case(case)
    got = emulated_bwd(*(_t(a) for a in arrs[:6]), chunk, _t(arrs[6]), _t(arrs[7]))
    errs = gate_errors(got, *arrs, chunk)
    assert max(errs.values()) <= GATE, errs


@pytest.mark.parametrize("case", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_emulated_backward_matches_jax(case):
    """The emulation against ``jax.vjp`` of ``Mamba2LM._ssd_chunked``: 1e-4
    of each gradient's largest entry."""
    arrs, chunk = _case(case)
    got = emulated_bwd(*(_t(a) for a in arrs[:6]), chunk, _t(arrs[6]), _t(arrs[7]))
    want = _jax_vjp(*arrs, chunk)
    for n, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None
            continue
        w = torch.from_numpy(np.asarray(w, np.float64))
        assert float((g.double() - w).abs().max()) <= GATE * float(w.abs().max()), n


@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=[CASES[0][0], CASES[3][0]])
def test_one_tf32_product_misses_the_gate(case):
    """Why three products: one tf32 product of each pair (10 bits of each
    operand) misses phase 2d's 1e-4 by far."""
    arrs, chunk = _case(case)
    got = emulated_bwd(*(_t(a) for a in arrs[:6]), chunk, _t(arrs[6]), _t(arrs[7]),
                       route="tf32")
    assert max(gate_errors(got, *arrs, chunk).values()) > GATE


@pytest.mark.parametrize("hb", [1, 2, 4])
def test_head_slabs_and_their_ordered_sums(hb):
    """A block's heads summed in its registers, then the slabs of a group in
    order: every slab size meets the gate, and dB, dC move by fp32 rounding
    alone (1e-6 of their max) from one head a slab; the other gradients do
    not depend on it at all."""
    case = ("g1_h8", 1, 128, 8, 16, 1, 16, 64, dict(h0=True, dh_final=True))
    arrs, chunk = _case(case)
    args = [_t(a) for a in arrs]
    one = emulated_bwd(*args[:6], chunk, *args[6:], heads_per_block=1)
    got = emulated_bwd(*args[:6], chunk, *args[6:], heads_per_block=hb)
    assert max(gate_errors(got, *arrs, chunk).values()) <= GATE
    for n, a, b in zip(NAMES, one, got):
        if n in ("dB", "dC"):
            assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max()), n
        else:
            assert torch.equal(a, b), n


def test_d_once_equals_d_recomputed():
    """L o D o dt of a tile pair written once by the key blocks and read by
    the query blocks gives what the query blocks recomputing D give, up to
    the rounding of D's operands taken in the other order (1e-6)."""
    arrs, chunk = _case(CASES[1])
    args = [_t(a) for a in arrs]
    once = emulated_bwd(*args[:6], chunk, *args[6:], d_once=True)
    twice = emulated_bwd(*args[:6], chunk, *args[6:], d_once=False)
    assert max(gate_errors(twice, *arrs, chunk).values()) <= GATE
    for n, a, b in zip(NAMES, once, twice):
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max()), n


def test_scores_once_per_group_serve_every_head():
    """G 2 at 4 heads a group: the emulation computes S twice (once a group)
    where the plain backward repeats B and C for all 8 heads, and meets the
    gate."""
    case = ("g2_h8", 1, 64, 8, 16, 2, 16, 64, dict(dh_final=True))
    arrs, chunk = _case(case)
    got = emulated_bwd(*(_t(a) for a in arrs[:6]), chunk, *(_t(a) for a in arrs[6:]))
    assert max(gate_errors(got, *arrs, chunk).values()) <= GATE


@pytest.mark.parametrize("name", ["smoke_widths_t24", "mid_q150_ragged"])
def test_bf16_build_meets_phase_2d_bf16_gate(name):
    """bf16 inputs: x, b, c exact tf32 operands (two products where one is an
    input), every fp32 intermediate split; dx, dB, dC rounded to bf16 within
    1e-2 elementwise of the plain backward of the same bf16 inputs."""
    case = next(c for c in CASES if c[0] == name)
    arrs, chunk = _case(case)
    t = [_t(a) for a in arrs]
    t[:3] = [bf16(a) for a in t[:3]]
    got = emulated_bwd(*t[:6], chunk, t[6], t[7], exact_inputs=True)
    want = ref.ssd_chunked_bwd_ref(*(a.bfloat16() for a in t[:3]), *t[3:6], chunk, t[6], t[7])
    for n, g, w in zip(NAMES, got, want):
        if w is None:
            continue
        g = g.bfloat16().float() if n in ("dxh", "dB", "dC") else g
        w = w.float()
        assert bool(((g - w).abs() <= BF16_GATE * (1 + w.abs())).all()), n


def test_exact_operands_need_no_small_part():
    """A bf16 value is a tf32 value: its small part is zero, so skipping its
    product changes nothing."""
    rng = np.random.default_rng(3)
    a = bf16(torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)))
    b = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    assert torch.equal(tf32_trunc(a), a)
    assert torch.equal(mm("ik,kj->ij", a, b, a_exact=True), mm("ik,kj->ij", a, b))


# ---------------------------------------------------------------------------
# the plan, as a plain function of shapes

SHAPES = [   # (B, T, H, G, P, N, Q, has_h0)
    (4, 512, 64, 1, 64, 128, 256, False), (2, 256, 64, 1, 64, 128, 256, False),
    (2, 256, 64, 1, 64, 128, 256, True), (2, 300, 64, 1, 64, 128, 150, False),
    (1, 512, 64, 8, 64, 128, 256, False), (2, 24, 8, 1, 32, 16, 8, True),
    (1, 512, 8, 1, 128, 64, 256, True), (1, 257, 64, 1, 64, 128, 1, False),
    (1, 16, 8, 4, 8, 16, 16, False), (2, 48, 6, 3, 16, 16, 16, True)]


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plan_is_a_legal_function_of_shapes(shape):
    """The heads a block takes divide a group's heads, key and query blocks
    cover every (batch, chunk, slab, 64-row tile) once, the S role's bands
    every group, the states of dh run only with several chunks or an h0,
    and the same shapes give the same plan."""
    B, T, H, G, P, N, Q, h0 = shape
    plan = K6.ssd_bwd_plan(B, T, H, G, P, N, Q, h0)
    assert plan == K6.ssd_bwd_plan(B, T, H, G, P, N, Q, h0)
    hb, nc, nt = plan["heads_per_block"], T // Q, math.ceil(Q / TB)
    assert hb in (1, 2, 4) and (H // G) % hb == 0
    assert hb == max(h for h in (1, 2, 4) if (H // G) % h == 0 and (
        h == 1 or B * nc * nt * (H // h) >= K6.BWD_MIN_BLOCKS))
    assert plan["tiles"] == nt
    assert plan["key_blocks"] == plan["query_blocks"] == B * nc * nt * (H // hb)
    assert plan["s_blocks"] == B * nc * G * math.ceil(math.ceil(Q / 16) / 4)
    states = nc > 1 or h0
    assert plan["state_blocks"] == (B * nc * H * (1 if P <= 64 else 2) if states else 0)
    assert plan["device_kernels"] == K6.ssd_bwd_device_kernels(nc, h0) == (6 if states else 5)
    assert set(plan) == {"tiles", "heads_per_block", "key_blocks", "query_blocks", "s_blocks",
                         "state_blocks", "finish_blocks", "reduce_blocks", "device_kernels"}
