"""The implicit-GEMM conv core (``csrc/conv_core.cuh``) on the CPU: what can
be checked without the card, cheaply (no JAX compile).

- The 3xTF32 product the fp32 kernels use, emulated bit for bit on float32
  (``cvt.rna.tf32``: round to nearest at 10 mantissa bits, ties away from
  zero), at the reduction depths of MSD layers 1 and 6: within FP32_TOL of
  the exact product's peak, and far closer than one TF32 product.
- The host planner ``plan_conv`` at every V1 MSD layer (3 scales, N = 2 and
  16) and every distinct distillation conv geometry, both dtypes, all three
  passes: tiles and splits cover the work exactly, shared memory and grid
  fit the card, the SIMT path is taken exactly at the narrow edges.
- A torch emulation of the kernels' tiled schedule (virtual-row windows
  staged once per tile and channel chunk, strided planes, per-phase dx, dz
  formed once, dW in splits summed in a fixed order) at narrow widths with
  the real kernel sizes, strides, groups, padding and dilations, against the
  plain versions of the conv stack and of the per-layer conv. Every window
  row it reads is checked to lie inside what the plan stages.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.ops import conv_stack as cs
from hifigan_tpu_torch.ops import msd_conv as tm
from hifigan_tpu_torch.ops.conv_stack import ConvShape, dw_plan, plan_conv, win_plan

FP32_TOL = 1e-4
SCHEDULE_TOL = 1e-5
DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# (a) 3xTF32
# ---------------------------------------------------------------------------

def tf32_rna(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mma_product(a: np.ndarray, b: np.ndarray, terms) -> np.ndarray:
    """A k8-step mma schedule: per step each (A part, B part) term's 8
    products are exact (TF32 x TF32 fits float32) and summed into the fp32
    accumulator in the kernel's order."""
    acc = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k0 in range(0, a.shape[1], 8):
        for pa, pb in terms:
            part = pa[:, k0:k0 + 8].astype(np.float64) @ pb[k0:k0 + 8].astype(np.float64)
            acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("depth", [41 * 32, 5 * 1024])  # MSD layers 1 and 6
def test_three_tf32_products_keep_fp32_parity(depth):
    rng = np.random.default_rng(depth)
    a = (rng.standard_normal((16, depth)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((depth, 16)) / np.sqrt(depth)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    peak = np.abs(exact).max()
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    three = mma_product(a, b, [(al, bh), (ah, bl), (ah, bh)])
    one = mma_product(a, b, [(ah, bh)])
    err3 = np.abs(three - exact).max()
    err1 = np.abs(one - exact).max()
    err32 = np.abs(a @ b - exact).max()
    assert err3 <= FP32_TOL * peak, (err3, peak)
    assert err1 >= 50 * err3, (err1, err3)
    assert err3 <= 4 * max(err32, 1e-7 * peak)  # the fp32 product's own error, within a few ulps
    assert err1 > FP32_TOL * peak  # one TF32 product alone breaks the parity


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    below, half, above = (np.float32(1.0 + f * 2.0 ** -10) for f in (0.49, 0.5, 0.51))
    np.testing.assert_array_equal(tf32_rna(np.array([below, half, above, -half])),
                                  np.array([one, one + ulp, one + ulp, -(one + ulp)]))


# ---------------------------------------------------------------------------
# (b) the planner
# ---------------------------------------------------------------------------

# V1 MSD (C_in, C_out, k, stride, groups, pad): conv_0, layers 1-6, conv_post
V1_MSD = [(1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 16, 20),
          (256, 512, 41, 4, 16, 20), (512, 1024, 41, 4, 16, 20), (1024, 1024, 41, 1, 16, 20),
          (1024, 1024, 5, 1, 1, 2), (1024, 1, 3, 1, 1, 1)]
# The distinct conv geometries of configs/distill.json's step (c_in, c_out, k,
# stride, dilation, groups, padding), as chip_smoke.py's phase 10 enumerates them.
DISTILL = [
    (1, 1, 3, 1, 2, 1, 2), (1, 1, 33, 1, 1, 1, 16), (1, 2, 21, 2, 1, 1, 10), (1, 4, 3, 1, 1, 1, 1),
    (2, 1, 3, 1, 2, 1, 2), (2, 2, 21, 1, 5, 1, 50), (2, 6, 21, 3, 1, 1, 10), (3, 1, 3, 1, 2, 1, 2),
    (3, 3, 21, 1, 5, 1, 50), (3, 15, 13, 5, 1, 1, 6), (4, 1, 3, 1, 1, 1, 1), (4, 2, 21, 1, 1, 1, 10),
    (4, 4, 3, 1, 1, 1, 1), (5, 1, 3, 1, 2, 1, 2), (5, 5, 13, 1, 5, 1, 30), (5, 40, 13, 8, 1, 1, 6),
    (6, 3, 21, 1, 1, 1, 10), (8, 1, 3, 1, 2, 1, 2), (8, 8, 13, 1, 5, 1, 30), (8, 104, 9, 13, 1, 1, 4),
    (10, 5, 13, 1, 1, 1, 6), (12, 12, 3, 1, 1, 1, 1), (13, 1, 3, 1, 2, 1, 2), (13, 13, 9, 1, 5, 1, 20),
    (13, 273, 9, 21, 1, 1, 4), (16, 8, 13, 1, 1, 1, 6), (21, 1, 3, 1, 2, 1, 2),
    (21, 21, 9, 1, 5, 1, 20), (21, 231, 5, 11, 1, 1, 2), (26, 13, 9, 1, 1, 1, 4),
    (26, 273, 3, 1, 3, 1, 3), (33, 1, 3, 1, 2, 1, 2), (33, 33, 5, 1, 5, 1, 10),
    (33, 594, 3, 18, 1, 1, 1), (54, 1, 3, 1, 2, 1, 2), (54, 54, 3, 1, 5, 1, 5),
    (54, 270, 1, 5, 1, 1, 0), (63, 21, 9, 1, 1, 1, 4), (66, 33, 5, 1, 1, 1, 2),
    (84, 84, 3, 1, 1, 1, 1), (90, 1, 3, 1, 2, 1, 2), (90, 90, 1, 1, 5, 1, 0),
    (90, 720, 1, 8, 1, 1, 0), (108, 54, 3, 1, 1, 1, 1), (117, 273, 3, 1, 3, 1, 3),
    (144, 1, 3, 1, 2, 1, 2), (144, 1, 33, 1, 1, 1, 16), (144, 144, 1, 1, 5, 1, 0),
    (270, 90, 1, 1, 1, 1, 0), (273, 26, 3, 1, 27, 1, 27), (273, 117, 3, 1, 27, 1, 27),
    (273, 273, 3, 1, 9, 1, 9), (288, 144, 1, 1, 1, 1, 0), (546, 273, 3, 1, 3, 1, 3),
    (1092, 1092, 3, 1, 1, 1, 1)]


def _t_out(t, k, s, d, pad):
    return (t + 2 * pad - ((k - 1) * d + 1)) // s + 1


def _v1_shapes():
    for t in (8192, 4097, 2049):  # the three scales' lengths at B x 8192 samples
        for n in (2, 16):
            tt = t
            for c_in, c_out, k, s, g, p in V1_MSD:
                t_out = _t_out(tt, k, s, 1, p)
                yield ConvShape(n, tt, c_in, t_out, c_out, k, s, 1, g, p)
                tt = t_out


def _distill_shapes():
    for c_in, c_out, k, s, d, g, p in DISTILL:
        for t in (17, 2730, 43680):
            t_out = _t_out(t, k, s, d, p)
            if t_out >= 1:
                yield ConvShape(3, t, c_in, t_out, c_out, k, s, d, g, p)


def _narrow(g, dtype, pass_):
    """The issue's narrow edges, written out independently of the planner."""
    kstep = 8 if dtype == torch.float32 else 16
    depth = {"fwd": g.k * g.ci_g, "dx": -(-g.k // g.s) * g.co_g, "dw": g.n * g.t_out}[pass_]
    return g.ci_g == 1 or g.co_g == 1 or depth < kstep


def _check_plan(g: ConvShape, dtype, pass_):
    plan = plan_conv(g, dtype, pass_)
    assert (plan["body"] == "simt") == _narrow(g, dtype, pass_), (g, pass_)
    x, y, z = plan["grid"]
    assert 1 <= z <= 65535 and y <= 65535 and x < 2 ** 31
    if plan["body"] == "simt":
        outs = {"fwd": g.n * g.t_out * g.c_out, "dx": g.n * g.t_in * g.c_in,
                "dw": g.k * g.ci_g * g.c_out}[pass_]
        assert x * 256 >= outs * plan["lanes"] > (x - 1) * 256
        return plan
    bm, bn = plan["bm"], plan["bn"]
    assert plan["smem"] <= cs.SMEM_LIMIT
    assert bn in (16, 32, 64) and bm in (64, 128) and (bm == 128 or bn >= 32)
    if pass_ == "dw":
        dp = dw_plan(g, dtype, bn, plan["kc"])
        assert plan["smem"] == dp["smem"] and plan["kc"] in (8, 16, 32, 64, 128)
        assert dp["chunks"] * dp["kc"] >= g.ci_g > (dp["chunks"] - 1) * dp["kc"]
        assert dp["ntt"] * dp["nt"] >= g.k > (dp["ntt"] - 1) * dp["nt"]
        assert x == dp["mtiles"] and y * bn >= g.co_g > (y - 1) * bn
        rows, sr, sp = g.n * g.t_out, plan["split_rows"], plan["splits"]
        assert z == g.groups * sp and sr % dp["bkt"] == 0
        ranges = [(i * sr, min(rows, (i + 1) * sr)) for i in range(sp)]
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:]))
        assert ranges[-1][0] < ranges[-1][1]
        assert plan["scratch"]["partial"] == sp * g.k * g.ci_g * g.c_out
    else:
        dx = pass_ == "dx"
        wp = win_plan(g, dx, dtype, bm, bn, plan["kc"])
        assert plan["smem"] == wp["smem"] and cs.kc_ok(g, dx, dtype, plan["kc"])
        m_rows = g.n * (-(-g.t_in // g.s) if dx else g.t_out)
        cols = g.ci_g if dx else g.co_g
        assert x * bm >= m_rows > (x - 1) * bm and y * bn >= cols > (y - 1) * bn
        assert z == (g.groups * g.s if dx else g.groups)
        assert wp["chunks"] * wp["kc"] >= wp["ch"] > (wp["chunks"] - 1) * wp["kc"]
        assert wp["kc"] % 8 == 0 and wp["p"] % 4 == 0
    assert plan["nrb"] * plan["rb_rows"] >= g.n * g.t_out > (plan["nrb"] - 1) * plan["rb_rows"]
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_plans_of_every_v1_msd_layer(dtype):
    bodies = set()
    for g in _v1_shapes():
        for pass_ in ("fwd", "dx", "dw"):
            bodies.add((g.c_in, g.c_out, pass_, _check_plan(g, dtype, pass_)["body"]))
    assert {b for (ci, co, _, b) in bodies if ci == 1 or co == 1} == {"simt"}  # conv_0, conv_post
    assert {b for (ci, co, _, b) in bodies if ci > 1 and co > 1} == {"mma"}  # layers 1-6


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_plans_of_every_distill_conv_geometry(dtype):
    n = 0
    for g in _distill_shapes():
        for pass_ in ("fwd", "dx", "dw"):
            _check_plan(g, dtype, pass_)
            n += 1
    assert n >= 3 * len(DISTILL) * 2


def test_plan_refuses_what_the_card_cannot_hold():
    with pytest.raises(ValueError, match="pass"):
        plan_conv(ConvShape(1, 64, 8, 62, 8, 3), torch.float32, "dW")
    with pytest.raises(ValueError, match="grid z"):  # groups x stride phases past grid z
        plan_conv(ConvShape(1, 1000, 2 ** 17, 250, 2 ** 17, 41, 4, 1, 2 ** 14, 20),
                  torch.float32, "dx")


# ---------------------------------------------------------------------------
# (c) the tiled schedule, emulated
# ---------------------------------------------------------------------------

def _staged_window(src, v0, lv, shift, S, npl, pr, wr, ch_idx, ch_ok):
    """The window of virtual rows [v0, v0 + wr) as stage_window lays it out:
    (npl * pr, kc), local row l at plane l mod S, index l // S; zeros outside
    the source, past the group's channels and in planes no tap reads."""
    n_b, t_src, c_src = src.shape
    win = torch.zeros((npl * pr, len(ch_idx)), dtype=torch.float64)
    l = torch.arange(wr)
    w = v0 + l
    nb, row = w // lv, w % lv + shift
    ok = (l % S < npl) & (nb < n_b) & (row >= 0) & (row < t_src)
    vals = src[nb[ok], row[ok]][:, ch_idx.clamp(max=c_src - 1)].double()
    win[((l % S) * pr + l // S)[ok]] = vals * ch_ok
    return win


def _rows_of(ms, rows, m0, estep):
    """Each tile row's first window row, (m - m0) + (n(m) - n(m0)) * E/S."""
    return (ms - m0) + (ms // rows - m0 // rows) * estep


def _direct(x, w, g: ConvShape):
    """The SIMT body's function: (n, c_out, t_out) pre-activations, zero outside the input."""
    z = F.conv1d(F.pad(x.transpose(1, 2), (g.pad_l, g.pad_l + g.k * g.d)), w.permute(2, 1, 0),
                 stride=g.s, dilation=g.d, groups=g.groups)
    return z[:, :, :g.t_out]


def emulate_fwd(x, w, bias, g: ConvShape, slope, dtype):
    """The forward kernel's tiles over a float64 copy of the operands."""
    plan = plan_conv(g, dtype, "fwd")
    xd, wd = x.double(), w.double()
    y = torch.zeros((g.n * g.t_out, g.c_out), dtype=torch.float64)
    if plan["body"] == "simt":
        y = _direct(xd, wd, g).transpose(1, 2).reshape(-1, g.c_out)
    else:
        bm = plan["bm"]
        wp = win_plan(g, False, dtype, bm, plan["bn"], plan["kc"])
        S, E, kc, pr, npl, wr = wp["S"], wp["E"], wp["kc"], wp["pr"], wp["npl"], wp["wr"]
        lv = g.t_out * S + E
        M = g.n * g.t_out
        taps = torch.arange(g.k)
        for grp in range(g.groups):
            for bx in range(plan["grid"][0]):
                m0 = bx * bm
                ms = torch.arange(m0, m0 + bm)
                live = ms < M
                ms = torch.where(live, ms, torch.full_like(ms, m0))
                v0 = (m0 // g.t_out) * lv + (m0 % g.t_out) * S
                base = _rows_of(ms, g.t_out, m0, E // S)
                acc = torch.zeros((bm, g.co_g), dtype=torch.float64)
                for c in range(wp["chunks"]):
                    chs = torch.arange(c * kc, c * kc + kc)
                    ok = chs < g.ci_g
                    win = _staged_window(x, v0, lv, -g.pad_l, S, npl, pr, wr,
                                         grp * g.ci_g + chs, ok)
                    off = taps * g.d
                    idx = base[:, None] + (off // S)[None, :]
                    assert int(idx.max()) < pr and int((off % S).max()) < npl
                    a = win[(off % S)[None, :] * pr + idx]  # (bm, k, kc)
                    wk = torch.zeros((g.k, kc, g.co_g), dtype=torch.float64)
                    wk[:, ok] = wd[:, chs[ok], grp * g.co_g:(grp + 1) * g.co_g]
                    acc += a.reshape(bm, -1) @ wk.reshape(-1, g.co_g)
                y[ms[live], grp * g.co_g:(grp + 1) * g.co_g] = acc[live]
    if bias is not None:
        y = y + bias.double()
    y = torch.where(y >= 0, y, y * slope)
    return y.reshape(g.n, g.t_out, g.c_out).to(dtype)


def emulate_dx(dz, w, g: ConvShape, dtype):
    """The dx kernel's per-phase tiles over a formed dz (working type)."""
    plan = plan_conv(g, dtype, "dx")
    dzd, wd = dz.double(), w.double()
    out = torch.zeros((g.n, g.t_in, g.c_in), dtype=torch.float64)
    if plan["body"] == "simt":
        xd = torch.zeros((g.n, g.t_in, g.c_in), dtype=torch.float64, requires_grad=True)
        (da,) = torch.autograd.grad(_direct(xd, wd, g), xd, dzd.transpose(1, 2))
        return da
    bm = plan["bm"]
    wp = win_plan(g, True, dtype, bm, plan["bn"], plan["kc"])
    E, kc, pr, wr = wp["E"], wp["kc"], wp["pr"], wp["wr"]
    for grp in range(g.groups):
        for ph in range(g.s):
            J = -(-(g.t_in - ph) // g.s) if ph < g.t_in else 0
            M = g.n * J
            k0 = (ph + g.pad_l) % g.s
            nq = -(-(g.k - k0) // g.s) if g.k > k0 else 0
            lv, shift = J + E, (ph + g.pad_l - k0) // g.s - (nq - 1) * g.d
            for bx in range(plan["grid"][0]):
                m0 = bx * bm
                if m0 >= M:
                    continue
                ms = torch.arange(m0, m0 + bm)
                live = ms < M
                ms = torch.where(live, ms, torch.full_like(ms, m0))
                acc = torch.zeros((bm, g.ci_g), dtype=torch.float64)
                if nq:
                    v0 = (m0 // J) * lv + m0 % J
                    base = _rows_of(ms, J, m0, E)
                    q = torch.arange(nq)
                    idx = base[:, None] + ((nq - 1 - q) * g.d)[None, :]
                    assert int(idx.max()) < min(pr, wr)
                    for c in range(wp["chunks"]):
                        chs = torch.arange(c * kc, c * kc + kc)
                        ok = chs < g.co_g
                        win = _staged_window(dz, v0, lv, shift, 1, 1, pr, wr,
                                             grp * g.co_g + chs, ok)
                        a = win[idx]  # (bm, nq, kc)
                        wk = torch.zeros((nq, kc, g.ci_g), dtype=torch.float64)
                        wk[:, ok] = wd[k0 + g.s * q][:, :, grp * g.co_g + chs[ok]].transpose(1, 2)
                        acc += a.reshape(bm, -1) @ wk.reshape(-1, g.ci_g)
                nb, j = ms // max(J, 1), ms % max(J, 1)
                out[nb[live], (ph + g.s * j)[live], grp * g.ci_g:(grp + 1) * g.ci_g] = acc[live]
    return out


def emulate_dz(dy, up, y, slope, dtype, plan):
    """The dz pass: dz once per element, its working-type copy, and db as
    row-block partials summed in order."""
    dz = torch.zeros(y.shape, dtype=torch.float32)
    if dy is not None:
        dz = dz + dy.float()
    if up is not None:
        dz = dz + up
    if slope != 1.0:
        dz = torch.where(y.float() < 0, dz * slope, dz)
    flat = dz.reshape(-1, dz.shape[2])
    db = torch.zeros(dz.shape[2], dtype=torch.float32)
    for r0 in range(0, flat.shape[0], plan["rb_rows"]):
        db = db + flat[r0:r0 + plan["rb_rows"]].sum(0)
    return dz.to(dtype), db


def emulate_dw(x, dz, g: ConvShape, dtype):
    """dW: (tap, channel) x column tiles over splits of (n, t), the window of
    each BKt-row chunk staged with its row offsets, partials summed in order."""
    plan = plan_conv(g, dtype, "dw")
    xd, dzd = x.double(), dz.double().reshape(-1, g.c_out)
    if plan["body"] == "simt":
        wd = torch.zeros((g.k, g.ci_g, g.c_out), dtype=torch.float64, requires_grad=True)
        (dw,) = torch.autograd.grad(_direct(xd, wd, g), wd, dz.double().transpose(1, 2))
        return dw.to(dtype)
    dp = dw_plan(g, dtype, plan["bn"], plan["kc"])
    S, E, kc, nt, pr, npl, wr, bkt = (dp[k] for k in ("S", "E", "kc", "nt", "pr", "npl", "wr",
                                                      "bkt"))
    lv, M = g.t_out * S + E, g.n * g.t_out
    partial = torch.zeros((plan["splits"], g.k * g.ci_g, g.c_out), dtype=torch.float32)
    rows = torch.arange(128)
    for sp in range(plan["splits"]):
        mb, me = sp * plan["split_rows"], min(M, (sp + 1) * plan["split_rows"])
        for grp in range(g.groups):
            for mt in range(dp["mtiles"]):
                chunk, tt = divmod(mt, dp["ntt"])
                tap0, ch0 = tt * nt, chunk * kc
                tq, c8 = rows // kc, rows % kc
                tq = torch.where(tap0 + tq < g.k, tq, torch.zeros_like(tq))
                off = tq * g.d
                assert int((off % S).max()) < npl
                acc = torch.zeros((128, g.co_g), dtype=torch.float64)
                for mc in range(mb, me, bkt):
                    nbc = mc // g.t_out
                    vc = nbc * lv + (mc - nbc * g.t_out) * S
                    ms = torch.arange(mc, mc + bkt)
                    live = ms < me
                    roff = torch.where(live, torch.arange(bkt) + (ms // g.t_out - nbc) * (E // S),
                                       torch.zeros_like(ms))
                    chs = torch.arange(ch0, ch0 + kc)
                    win = _staged_window(x, vc + tap0 * g.d, lv, -g.pad_l, S, npl, pr, wr,
                                         grp * g.ci_g + chs, chs < g.ci_g)
                    idx = roff[None, :] + (off // S)[:, None]
                    assert int(idx.max()) < pr
                    a = win[(off % S)[:, None] * pr + idx, c8[:, None]]  # (128, bkt)
                    b = torch.zeros((bkt, g.co_g), dtype=torch.float64)
                    b[live] = dzd[ms[live], grp * g.co_g:(grp + 1) * g.co_g]
                    acc += a @ b
                tap, ci = tap0 + rows // kc, ch0 + rows % kc
                ok = (tap0 + rows // kc < g.k) & (ci < g.ci_g)
                partial[sp, (tap * g.ci_g + ci)[ok], grp * g.co_g:(grp + 1) * g.co_g] = \
                    acc[ok].float()
    dw = torch.zeros_like(partial[0])
    for sp in range(plan["splits"]):
        dw = dw + partial[sp]
    return dw.reshape(g.k, g.ci_g, g.c_out).to(dtype)


def emulate_stack(x, kernels, biases, specs, dys, dtype):
    """The CUDA stack's forward and backward, layer by layer, as its entry
    points run them: (ys, dx, dWs, dbs)."""
    ys, h = [], x
    for kern, bias, sp in zip(kernels, biases, specs):
        g = ConvShape(h.shape[0], h.shape[1], h.shape[2], cs.out_len(h.shape[1], sp), sp.c_out,
                      sp.kernel, sp.stride, 1, sp.groups, sp.pad_l)
        h = emulate_fwd(h, kern.to(dtype), bias, g, sp.slope, dtype)
        ys.append(h)
    dks, dbs, up = [None] * len(specs), [None] * len(specs), None
    for l in range(len(specs) - 1, -1, -1):
        sp, y = specs[l], ys[l]
        x_in = x if l == 0 else ys[l - 1]
        g = ConvShape(x_in.shape[0], x_in.shape[1], x_in.shape[2], y.shape[1], sp.c_out,
                      sp.kernel, sp.stride, 1, sp.groups, sp.pad_l)
        dz, dbs[l] = emulate_dz(dys[l], up, y, sp.slope, dtype, plan_conv(g, dtype, "dw"))
        dks[l] = emulate_dw(x_in, dz, g, dtype)
        up = emulate_dx(dz, kernels[l].to(dtype), g, dtype).float()
    return ys, up.to(dtype), dks, dbs


_L = cs.LayerSpec
# MSD-shaped at narrow widths: the real kernel sizes, strides and padding,
# grouped layers with 8-16 channels a group, a dense k5 layer, a second
# channel chunk (80 input channels), conv_post; odd lengths
STACK = [_L(32, 41, 2, 4, 20, 20, 0.1), _L(64, 41, 4, 4, 20, 20, 0.1),
         _L(80, 41, 1, 4, 20, 20, 0.1), _L(72, 5, 1, 1, 2, 2, 0.1), _L(1, 3, 1, 1, 1, 1, 1.0)]


def _stack_operands(c0, t, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((n, t, c0)) * 0.5).astype(np.float32))
    ks, bs, c = [], [], c0
    for sp in STACK:
        fan = sp.kernel * (c // sp.groups)
        ks.append(torch.from_numpy((rng.standard_normal((sp.kernel, c // sp.groups, sp.c_out))
                                    * (1.5 / fan ** 0.5)).astype(np.float32)))
        bs.append(torch.from_numpy((rng.standard_normal(sp.c_out) * 0.1).astype(np.float32)))
        c = sp.c_out
    return x, ks, bs


def _close(got, want, tol=SCHEDULE_TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), 1e-30), (err, tol)


@pytest.mark.parametrize("n,t", [(2, 333), (3, 97)])
def test_stack_schedule_matches_the_plain_versions(n, t):
    x, ks, bs = _stack_operands(16, t, n, seed=t)
    want = cs.fused_conv_stack_reference(x, ks, bs, STACK)
    rng = np.random.default_rng(t + 1)
    dys = [torch.from_numpy((rng.standard_normal(y.shape) * 0.1).astype(np.float32)) for y in want]
    dys[1] = None  # a layer with no cotangent of its own
    ys, dx, dks, dbs = emulate_stack(x, ks, bs, STACK, dys, torch.float32)
    for got, ref in zip(ys, want):
        _close(got, ref)
    wdx, wdks, wdbs = cs.fused_conv_stack_backward_reference(x, ks, ys, dys, STACK)
    _close(dx, wdx)
    for a, b in zip(dks, wdks):
        _close(a, b)
    for a, b in zip(dbs, wdbs):
        _close(a, b)


# (C_in, C_out, k, stride, dilation, groups, padding, slope, T): B5 shapes at
# narrow widths: a strided grouped MSD layer, dilated convs (one across
# channel chunks), a stride above the kernel size, asymmetric padding at
# stride 3, conv_0's one input channel
B5_CASES = [(32, 32, 41, 4, 1, 4, 20, 0.1, 201), (24, 20, 3, 1, 9, 1, 9, 0.1, 77),
            (72, 40, 3, 1, 27, 1, 27, 0.1, 130), (16, 24, 3, 5, 1, 1, 1, 0.1, 64),
            (12, 18, 7, 3, 1, 3, (4, 1), 0.2, 101), (1, 16, 15, 1, 1, 1, 7, 0.1, 90)]


@pytest.mark.parametrize("case", B5_CASES, ids=[f"c{i}" for i in range(len(B5_CASES))])
def test_msd_conv_schedule_matches_the_plain_versions(case):
    ci, co, k, s, d, groups, p, slope, t = case
    rng = np.random.default_rng(t)
    x = torch.from_numpy((rng.standard_normal((2, t, ci)) * 0.5).astype(np.float32))
    kern = torch.from_numpy((rng.standard_normal((k, ci // groups, co))
                             / np.sqrt(k * ci // groups)).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32))
    kw = dict(stride=s, padding=p, dilation=d, groups=groups, slope=slope)
    want = tm.msd_conv1d_lrelu_reference(x, kern, bias, **kw)
    pad_l = p if isinstance(p, int) else p[0]
    g = ConvShape(2, t, ci, want.shape[1], co, k, s, d, groups, pad_l)
    y = emulate_fwd(x, kern, bias, g, slope, torch.float32)
    _close(y, want)
    dy = torch.from_numpy((rng.standard_normal(y.shape) * 0.1).astype(np.float32))
    dz = tm._masked_cotangent(dy, y, slope)
    dx = emulate_dx(dz, kern, g, torch.float32).float()
    wdx, _, _ = tm.msd_conv1d_lrelu_backward_reference(x, kern, y, dy, weight_grads=False, **kw)
    _close(dx, wdx)
