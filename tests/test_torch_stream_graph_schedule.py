"""The stream-graph kernels' schedule, emulated on the CPU.

``csrc/stream_graph.cu`` runs a segment in one cooperative launch per pass,
planned by ``ops/stream_graph.py`` (``forward_schedule``, ``dx_schedule``,
``dw_schedule``): units of tiles in phases separated by grid barriers. The
emulation here executes that plan tile by tile and split by split with the
kernel's index arithmetic (staged windows, chunks, stride phases, lanes,
split partials summed in split order), asserting that every staged read
lies inside what the tile staged, that shared memory holds it, that every
output is written by exactly one tile, and that no phase reads what the
same phase writes. It is held against the plain versions at 1e-5 in fp32
on small segments (narrow ops, strided and dilated edges, residuals, every
activation, three members, every backward-plan mask) and, through the
port's fused member, against the JAX package on a small production-shaped
member. The kernels themselves run on the card (``chip_smoke.py`` phase 8,
``tests/test_torch_cuda.py``).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.dsl.module import ConfigurableModule as JaxModule
from hifigan_tpu.dsl.parsing import parse_layers
from hifigan_tpu.dsl.static_configs import get_discriminator_config
from hifigan_tpu.ops.pallas import stream_graph as jsg
from hifigan_tpu_torch.dsl import fused_member as fm
from hifigan_tpu_torch.dsl.module import ConfigurableModule
from hifigan_tpu_torch.ops import stream_graph as sg
from tests.torch_port_helpers import dsl_pair, leaves, run_cheap

TOL = 1e-5
L, E, O = sg.Level, sg.Edge, sg.Op


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _stage(x, t0: int, rows: int, e, i0: int, cw: int):
    """A tile's staged window of edge ``e`` over source ``x`` (t_src, c_in):
    output rows [t0, t0 + rows), channels [i0, i0 + cw)."""
    n, _, _, compact = sg.window(rows, e.kernel, e.stride, e.dilation)
    assert n * (cw | 1) <= sg.WIN_CAP
    wr = torch.arange(n)
    if compact:
        src = (t0 + wr // e.kernel) * e.stride - e.pad + (wr % e.kernel) * e.dilation
    else:
        src = t0 * e.stride - e.pad + wr
    ok = (src >= 0) & (src < x.shape[0])
    win = torch.zeros((n, cw))
    win[ok] = x[src[ok], i0:i0 + cw]
    return win


def _product(win, step: int, kstep: int, taps: int, wsm, bm: int, rows: int):
    """The tile's rows x columns: row lr, tap k reads staged row
    lr * step + k * kstep (rows past ``rows`` read row 0, as the kernel's)."""
    lr = torch.arange(bm)
    idx = torch.where(lr < rows, lr * step, 0)[:, None] + torch.arange(taps)[None, :] * kstep
    assert int(idx.max()) < win.shape[0]
    return torch.einsum("rkc,kcn->rn", win[idx], wsm)


def emulate_forward(seg, inputs, tables, biases, members: int):
    """The forward launch, tile by tile, phase by phase."""
    b_all = inputs[0].shape[0]
    n_per, dtype = b_all // members, inputs[0].dtype
    sched = sg.forward_schedule(seg, b_all)
    vals, it = {}, iter(inputs)
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            vals[li] = next(it).float().reshape(b_all, -1)
    ready = set(vals)
    outs = {op.out: torch.full((b_all, seg.levels[op.out].t, seg.levels[op.out].c), math.nan)
            for op in seg.ops}
    hits = {li: torch.zeros(o.shape, dtype=torch.int32) for li, o in outs.items()}
    start = 0
    for end in sched.phase_end:
        for u in sched.units[start:end]:
            op = seg.ops[u.op]
            assert all(e.src in ready for e in op.edges) and (op.res_from is None
                                                             or op.res_from in ready)
            assert u.lanes * u.tx * u.ty <= sg.THREADS
            for idx in range(u.tiles):
                _fwd_tile(seg, u, idx, vals, tables, biases, n_per, dtype, outs, hits)
        for u in sched.units[start:end]:
            li = seg.ops[u.op].out
            vals[li] = outs[li].reshape(b_all, -1)
            ready.add(li)
        start = end
    for li, h in hits.items():
        assert bool((h == 1).all()), f"level {li} not written exactly once"
    return [outs[op.out].to(dtype) for op in seg.ops]


def _fwd_tile(seg, u, idx, vals, tables, biases, n_per, dtype, outs, hits):
    op = seg.ops[u.op]
    out = seg.levels[op.out]
    bm, bn = sg.TM * u.ty, u.tn * u.tx
    c = idx % u.ct
    idx //= u.ct
    t0, b = (idx % u.rt) * bm, idx // u.rt
    n0, rows, mem = c * bn, min(bm, out.t - t0), b // n_per
    nc = min(bn, out.c - n0)
    acc = torch.zeros((bm, bn))
    for ei in u.edges:
        e = seg.edges[ei][1]
        x = vals[e.src][b].reshape(-1, e.c_in)
        w = tables[ei][mem].to(dtype).float()
        _, step, kstep, _ = sg.window(rows, e.kernel, e.stride, e.dilation)
        for i0 in range(0, e.c_in, u.cw):
            cw = min(u.cw, e.c_in - i0)
            assert e.kernel * cw * bn <= sg.W_CAP
            win = _stage(x, t0, rows, e, i0, cw)
            wsm = torch.zeros((e.kernel, cw, bn))
            wsm[:, :, :nc] = w[:, i0:i0 + cw, n0:n0 + nc]
            acc += _product(win, step, kstep, e.kernel, wsm, bm, rows)
    z = acc[:rows, :nc]
    if biases[u.op] is not None:
        z = z + biases[u.op][mem, n0:n0 + nc].float()
    if op.res_from is not None:
        res = vals[op.res_from][b].reshape(-1, out.c)
        z = z + res[t0:t0 + rows, n0:n0 + nc]
    outs[op.out][b, t0:t0 + rows, n0:n0 + nc] = sg._act(z, op).to(dtype).float()
    hits[op.out][b, t0:t0 + rows, n0:n0 + nc] += 1


def emulate_backward(seg, inputs, ys, dys, tables, members: int, plan):
    """The dx launch then the dW launch, tile by tile and split by split.
    Returns (dxs, dWs, dbs) as ``fused_stream_graph_backward_reference``."""
    b_all = inputs[0].shape[0]
    n_per, dtype = b_all // members, inputs[0].dtype
    vals, it_in, it_out = {}, iter(inputs), iter(ys)
    for li, lvl in enumerate(seg.levels):
        vals[li] = next(it_in if lvl.is_input else it_out).float().reshape(b_all, -1)
    dy_of = {op.out: d for op, d in zip(seg.ops, dys)}
    sched = sg.dx_schedule(seg, tuple(plan), b_all)
    da = {li: (dy_of[li].to(dtype).float().reshape(b_all, -1).clone()
               if not seg.levels[li].is_input and dy_of.get(li) is not None
               else torch.zeros((b_all, seg.levels[li].size))) for li in sched.slots}
    pending = {}  # level -> ops still to add into its cotangent
    for u in sched.units:
        pending.setdefault(u.tgt, set()).add(u.op)
    start = 0
    for end in sched.phase_end:
        units = sched.units[start:end]
        by_target = {}
        for u in units:
            assert not pending.get(seg.ops[u.op].out), "dz read before its cotangent is complete"
            assert by_target.setdefault(u.tgt, u.op) == u.op, "two ops add into one level"
        for u in units:
            hits = torch.zeros((b_all, seg.levels[u.tgt].size), dtype=torch.int32)
            tile = _dx_compact_tile if u.compact else _dx_tile
            for idx in range(u.tiles):
                tile(seg, u, idx, vals, da, tables, b_all, n_per, dtype, hits)
            # a compact job leaves the rows between receptive fields untouched
            assert bool((hits <= 1).all() if u.compact else (hits == 1).all()), (
                f"job of op {u.op} into level {u.tgt}")
        for u in units:
            pending[u.tgt].discard(u.op)
        start = end
    dxs, ii = [], 0
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            dxs.append(da[li].to(dtype).reshape(inputs[ii].shape) if li in da else None)
            ii += 1
    dws, dbs = _emulate_dw(seg, plan, vals, da, tables, members, n_per, dtype)
    return dxs, dws, dbs


def _dz(seg, op, vals, da, b):
    out = seg.levels[op.out]
    y = vals[op.out][b].reshape(out.t, out.c)
    sq = vals[op.res_from][b][:out.t * out.c].reshape(out.t, out.c) if op.act == "square" else None
    return sg._act_vjp(da[op.out][b].reshape(out.t, out.c), y, op, sq)


def _dx_tile(seg, u, idx, vals, da, tables, b_all, n_per, dtype, hits):
    op = seg.ops[u.op]
    out = seg.levels[op.out]
    edges = [(ei, seg.edges[ei][1]) for ei in u.edges]
    c_tgt = edges[0][1].c_in if edges else out.c
    t_tgt = seg.levels[u.tgt].size // c_tgt
    bm, bn, s = sg.TM * u.ty, u.tn * u.tx, u.s
    assert u.lanes * u.tx * u.ty <= sg.THREADS
    c = idx % u.ct
    idx //= u.ct
    j0 = (idx % u.rt) * bm
    idx //= u.rt
    b, ph = idx % b_all, idx // b_all
    if ph >= t_tgt or j0 >= -(-(t_tgt - ph) // s):
        return
    rows = min(bm, -(-(t_tgt - ph) // s) - j0)
    n0, mem = c * bn, b // n_per
    nc = min(bn, c_tgt - n0)
    dz = _dz(seg, op, vals, da, b)
    dzr = dz.to(dtype).float()
    acc = torch.zeros((bm, bn))
    for ei, e in edges:
        w = tables[ei][mem].to(dtype).float()
        if s == 1:
            k0, nq, tb_off, dq = 0, e.kernel, e.pad, e.dilation
        else:
            k0 = (ph + e.pad) % s
            nq = -(-(e.kernel - k0) // s) if e.kernel > k0 else 0
            tb_off, dq = (ph + e.pad - k0) // s, 1
        if nq == 0:
            continue
        rows_w, base = rows + (nq - 1) * dq, j0 + tb_off - (nq - 1) * dq
        taps = k0 + s * (nq - 1 - torch.arange(nq))
        for o0 in range(0, out.c, u.cw):
            cw = min(u.cw, out.c - o0)
            assert rows_w * (cw | 1) <= sg.WIN_CAP and nq * cw * bn <= sg.W_CAP
            t = base + torch.arange(rows_w)
            ok = (t >= 0) & (t < out.t)
            win = torch.zeros((rows_w, cw))
            win[ok] = dzr[t[ok], o0:o0 + cw]
            wsm = torch.zeros((nq, cw, bn))
            wsm[:, :, :nc] = w[taps][:, n0:n0 + nc, o0:o0 + cw].transpose(1, 2)
            acc += _product(win, 1, dq, nq, wsm, bm, rows)
    u_rows = ph + s * (j0 + torch.arange(rows))
    v = acc[:rows, :nc]
    if u.res:
        ok = u_rows < out.t
        v[ok] += dz[u_rows[ok], n0:n0 + nc]
    dat = da[u.tgt][b].view(t_tgt, c_tgt)
    dat[u_rows, n0:n0 + nc] += v
    hits[b].view(t_tgt, c_tgt)[u_rows, n0:n0 + nc] += 1


def _dx_compact_tile(seg, u, idx, vals, da, tables, b_all, n_per, dtype, hits):
    op = seg.ops[u.op]
    out = seg.levels[op.out]
    ei = u.edges[0]
    e = seg.edges[ei][1]
    assert e.kernel <= u.s == e.stride and not u.res
    c_tgt = e.c_in
    t_tgt, ncols = seg.levels[u.tgt].size // c_tgt, e.kernel * c_tgt
    bm, bn = sg.TM * u.ty, u.tn * u.tx
    assert u.lanes * u.tx * u.ty <= sg.THREADS
    c = idx % u.ct
    idx //= u.ct
    t0, b = (idx % u.rt) * bm, idx // u.rt
    rows, n0, mem = min(bm, out.t - t0), c * bn, b // n_per
    nc = min(bn, ncols - n0)
    dzr = _dz(seg, op, vals, da, b).to(dtype).float()
    w = tables[ei][mem].to(dtype).float().reshape(ncols, out.c)  # rows n = k * c_tgt + i
    acc = torch.zeros((bm, bn))
    for o0 in range(0, out.c, u.cw):
        cw = min(u.cw, out.c - o0)
        assert rows * (cw | 1) <= sg.WIN_CAP and cw * bn <= sg.W_CAP
        win = dzr[t0:t0 + rows, o0:o0 + cw]
        wsm = torch.zeros((1, cw, bn))
        wsm[0, :, :nc] = w[n0:n0 + nc, o0:o0 + cw].T
        acc += _product(win, 1, 0, 1, wsm, bm, rows)
    n = n0 + torch.arange(nc)
    k, i = n // c_tgt, n % c_tgt
    t = t0 + torch.arange(rows)
    urow = t[:, None] * u.s - e.pad + k[None, :]
    ok = (urow >= 0) & (urow < t_tgt)
    dat = da[u.tgt][b].view(t_tgt, c_tgt)
    ii = i[None, :].expand_as(urow)
    dat.index_put_((urow[ok], ii[ok]), acc[:rows, :nc][ok], accumulate=True)
    hits[b].view(t_tgt, c_tgt).index_put_((urow[ok], ii[ok]), torch.ones_like(urow[ok],
                                          dtype=torch.int32), accumulate=True)


def _emulate_dw(seg, plan, vals, da, tables, members, n_per, dtype):
    sched = sg.dw_schedule(seg, tuple(plan), members * n_per, members)
    dws, dbs = [None] * len(tables), [None] * len(seg.ops)
    for u in sched.units:
        out = seg.levels[seg.ops[u.op].out]
        size = (tables[u.edges[0]][0].numel() // out.c if u.edges else 1, out.c)
        part = torch.full((members, u.splits) + size, math.nan)
        for idx in range(u.tiles):
            (_dw_tile if u.edges else _db_tile)(seg, u, idx, vals, da, n_per, dtype, part)
        assert not bool(part.isnan().any()), f"unit of op {u.op}: a partial never written"
        total = part[:, 0].clone()
        for sp in range(1, u.splits):  # split order, as the kernel sums
            total += part[:, sp]
        if u.edges:
            dws[u.edges[0]] = total.reshape(tables[u.edges[0]].shape).to(dtype)
        else:
            dbs[u.op] = total[:, 0]
    return dws, dbs


def _split_rows(u, sp, rows_m):
    beg = sp * u.split_rows
    return beg, min(rows_m, beg + u.split_rows)


def _dw_tile(seg, u, idx, vals, da, n_per, dtype, part):
    op = seg.ops[u.op]
    out = seg.levels[op.out]
    e = seg.edges[u.edges[0]][1]
    r_all, bmo, bn = e.kernel * e.c_in, sg.TM * u.ty, u.tn * u.tx
    assert u.lanes * u.tx * u.ty <= sg.THREADS and u.rc * bn <= sg.W_CAP
    c = idx % u.ct
    idx //= u.ct
    r0 = (idx % u.rt) * bmo
    idx //= u.rt
    sp, m = idx % u.splits, idx // u.splits
    r1, n0 = min(r_all, r0 + bmo), c * bn
    nc = min(bn, out.c - n0)
    ch_lo, span = sg.channel_span(r0, r1, e.c_in)
    row = torch.arange(r0, r1)
    k, ci = row // e.c_in, row % e.c_in - ch_lo
    assert int(ci.min()) >= 0 and int(ci.max()) < span
    acc = torch.zeros((u.lanes, r1 - r0, bn))
    mf, m_end = _split_rows(u, sp, n_per * out.t)
    while mf < m_end:
        n, ta = divmod(mf, out.t)
        nr = min(u.rc, out.t - ta, m_end - mf)
        b = m * n_per + n
        win = _stage(vals[e.src][b].reshape(-1, e.c_in), ta, nr, e, ch_lo, span)
        _, step, kstep, _ = sg.window(nr, e.kernel, e.stride, e.dilation)
        dzs = torch.zeros((nr, bn))
        dzs[:, :nc] = _dz(seg, op, vals, da, b)[ta:ta + nr, n0:n0 + nc].to(dtype).float()
        tt = torch.arange(nr)
        wrow = tt[:, None] * step + k[None, :] * kstep
        assert int(wrow.max()) < win.shape[0]
        a = win[wrow, ci[None, :]]  # (nr, rows of the tile)
        for lane in range(u.lanes):
            sel = tt % u.lanes == lane
            acc[lane] += a[sel].T @ dzs[sel]
        mf += nr
    total = acc[0].clone()
    for lane in range(1, u.lanes):
        total += acc[lane]
    p = part[m, sp, r0:r1, n0:n0 + nc]
    assert bool(p.isnan().all()), "a partial written twice"
    p.copy_(total[:, :nc])


def _db_tile(seg, u, idx, vals, da, n_per, dtype, part):
    op = seg.ops[u.op]
    out = seg.levels[op.out]
    c = idx % u.ct
    idx //= u.ct
    sp, m = idx % u.splits, idx // u.splits
    o = torch.arange(c * u.tx, min(out.c, (c + 1) * u.tx))
    beg, end = _split_rows(u, sp, n_per * out.t)
    acc = torch.zeros((u.lanes, len(o)))
    for mf in range(beg, end):
        n, t = divmod(mf, out.t)
        acc[(mf - beg) % u.lanes] += _dz(seg, op, vals, da, m * n_per + n)[t, o]
    total = acc[0].clone()
    for lane in range(1, u.lanes):
        total += acc[lane]
    p = part[m, sp, 0, o]
    assert bool(p.isnan().all())
    part[m, sp, 0, o] = total


# ---------------------------------------------------------------------------
# small segments
# ---------------------------------------------------------------------------


def _narrow_segment():
    """Narrow ops (1-3 channels) with every activation, a dilated and a
    strided edge, a rechannel (conv_rech) view, a residual-only op, a
    two-edge op with a second input and a stride above the kernel."""
    levels = (L(40, 1, True),  # 0
              L(40, 1),  # 1  lrelu, K5
              L(40, 2),  # 2  tanh, dilated
              L(20, 2),  # 3  strided (s2)
              L(20, 2, True),  # 4  a second input
              L(20, 2),  # 5  two edges + residual, square
              L(20, 2),  # 6  log1e5 of 5
              L(20, 2),  # 7  residual only (lrelu)
              L(10, 4),  # 8  conv_rech: s4 of level 2, read next as (40, 1)
              L(40, 3),  # 9  none, reads level 8 rechannelled
              L(10, 3))  # 10 stride 4 above the kernel (K2), from level 9
    ops = (O(1, (E(0, 1, 5, 1, 1, 2),), "lrelu", 0.1),
           O(2, (E(1, 1, 3, 1, 2, 2),), "tanh"),
           O(3, (E(1, 1, 5, 2, 1, 2),), "none"),
           O(5, (E(3, 2, 3, 1, 3, 3), E(4, 2, 3, 1, 1, 1)), "square", res_from=3),
           O(6, (E(5, 2, 1),), "log1e5"),
           O(7, (), "lrelu", 0.2, res_from=6),
           O(8, (E(2, 2, 4, 4, 1, 0),), "lrelu", 0.1),
           O(9, (E(8, 1, 3, 1, 1, 1),), "none"),
           O(10, (E(9, 3, 2, 4, 1, 1),), "tanh"))
    return sg.Segment(levels, ops)


def _wide_segment():
    """Wider ops: several row and column tiles (c_out 64 and 70), a dilated
    and a strided edge, a rechannel read, a residual."""
    levels = (L(150, 8, True),  # 0
              L(150, 64),  # 1  dilated, 1 column tile, 3 row tiles
              L(150, 20),  # 2  two edges
              L(50, 70),  # 3  strided (s3), 2 column tiles
              L(1000, 7),  # 4  reads level 3 as (500, 7), s1; residual of ... none
              L(1000, 7))  # 5  residual of 4, dilated
    ops = (O(1, (E(0, 8, 5, 1, 2, 4),), "lrelu", 0.1),
           O(2, (E(1, 64, 3, 1, 1, 1), E(0, 8, 1)), "tanh"),
           O(3, (E(2, 20, 4, 3, 1, 1),), "none"),
           O(4, (E(3, 7, 3, 1, 1, 1),), "lrelu", 0.1),
           O(5, (E(4, 7, 3, 1, 5, 5),), "none", res_from=4))
    return sg.Segment(levels, ops)


def _inputs(seg, members, per, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    b_all = members * per
    ins = [torch.from_numpy(rng.standard_normal((b_all, lvl.t, lvl.c)).astype(np.float32) * 0.5)
           .to(dtype) for lvl in seg.levels if lvl.is_input]
    tabs, bs = [], []
    for op in seg.ops:
        c_out = seg.levels[op.out].c
        for e in op.edges:
            scale = 1.0 / math.sqrt(e.kernel * e.c_in)
            tabs.append(torch.from_numpy(rng.standard_normal(
                (members, e.kernel, e.c_in, c_out)).astype(np.float32) * scale))
        bs.append(torch.from_numpy(rng.standard_normal((members, c_out)).astype(np.float32) * 0.1)
                  if op.edges else None)
    return ins, tabs, bs


SEGMENTS = {"narrow": _narrow_segment, "wide": _wide_segment}
MASKS = ["every input", "no input", "no dy on level 1", "no weights", "one table"]


@pytest.fixture
def tight(monkeypatch):
    """Shared-memory caps small enough to force channel chunks, row chunks
    and many dW splits at these sizes."""
    monkeypatch.setattr(sg, "WIN_CAP", 192)
    monkeypatch.setattr(sg, "W_CAP", 512)
    monkeypatch.setattr(sg, "DW_MIN_ROWS", 8)
    monkeypatch.setattr(sg, "DB_ROWS_PER_THREAD", 1)
    monkeypatch.setattr(sg, "DB_COLS", 2)


def _check_forward(seg, members):
    ins, tabs, bs = _inputs(seg, members, 2, 7)
    got = emulate_forward(seg, ins, tabs, bs, members)
    want = sg.fused_stream_graph_reference(seg, ins, tabs, bs, members)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL * max(1.0, float(w.abs().max())))
    return ins, tabs, bs, want


def _masks(seg, case, n_in, n_tab):
    dx = [case != "no input"] * n_in
    dw = [case != "no weights"] * n_tab
    if case == "one table":
        dw = [i == 1 for i in range(n_tab)]
    db = [case not in ("no weights", "one table")] * len(seg.ops)
    return dx, dw, db


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_forward_schedule_matches_plain(name, members):
    _check_forward(SEGMENTS[name](), members)


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_forward_schedule_matches_plain_in_chunks(name, tight):
    _check_forward(SEGMENTS[name](), 3)


def _check_backward(seg, members, case):
    ins, tabs, bs, ys = _check_forward(seg, members)
    g = torch.Generator().manual_seed(3)
    dys = [torch.randn(y.shape, generator=g) for y in ys]
    if case == "no dy on level 1":
        dys[0] = None
    dx, dw, db = _masks(seg, case, len(ins), len(tabs))
    db = [m and b is not None for m, b in zip(db, bs)]
    plan = sg.backward_plan(seg, dx, dw, db, [d is not None for d in dys])
    got = emulate_backward(seg, ins, ys, dys, tabs, members, plan)
    want = sg.fused_stream_graph_backward_reference(seg, ins, ys, dys, tabs, members,
                                                    dx_mask=dx, dw_mask=dw, db_mask=db)
    for kind, gs, ws in zip(("dx", "dW", "db"), got, want):
        assert len(gs) == len(ws)
        for i, (a, b) in enumerate(zip(gs, ws)):
            assert (a is None) == (b is None), f"{kind}{i}"
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=TOL * max(1.0, float(b.abs().max())),
                                           msg=lambda m: f"{kind}{i}: {m}")


@pytest.mark.parametrize("case", MASKS)
@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_backward_schedule_matches_plain(name, case):
    _check_backward(SEGMENTS[name](), 3, case)


@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_backward_schedule_matches_plain_in_chunks(name, tight):
    _check_backward(SEGMENTS[name](), 3, "every input")


def test_backward_schedule_matches_plain_one_member():
    _check_backward(_narrow_segment(), 1, "every input")


# ---------------------------------------------------------------------------
# the schedule's structure
# ---------------------------------------------------------------------------


def test_tiles_cover_each_output_once_and_fit():
    """Column tiling: no padding column up to 4 channels, at most 64 a tile;
    every unit's tiles and shared memory within the kernel's limits."""
    for n in range(1, 800):
        tn, tx, ct = sg.col_tiling(n)
        assert tn * tx * ct >= n > tn * tx * (ct - 1) and tn * tx <= 64 and tx <= 16
        assert (tn * tx == n) if n <= 4 else tn == 4
    for name, make in SEGMENTS.items():
        seg = make()
        n_in = sum(lvl.is_input for lvl in seg.levels)
        plan = sg.backward_plan(seg, [True] * n_in, [True] * len(seg.edges),
                                [True] * len(seg.ops), [True] * len(seg.ops))
        for sched in (sg.forward_schedule(seg, 6), sg.dx_schedule(seg, tuple(plan), 6),
                      sg.dw_schedule(seg, tuple(plan), 6, 3)):
            for u in sched.units:
                assert 1 <= u.tn <= 4 and u.tx * u.ty * u.lanes <= sg.THREADS, (name, u)


def test_phases_respect_dependencies():
    seg = _narrow_segment()
    phases = sg.forward_phases(seg)
    assert phases == [[0], [1, 2], [3, 6], [4, 7], [5, 8]]
    plan = sg.backward_plan(seg, [True, True], [True] * len(seg.edges), [True] * len(seg.ops),
                            [True] * len(seg.ops))
    # an op runs after every op adding into its output's cotangent, and after
    # every later op adding into a level it adds into (ops 1 and 2 into level 1)
    dx = sg.dx_phases(seg, plan)
    flat = [oi for p in dx for oi in p]
    assert sorted(flat) == list(range(len(seg.ops)))
    where = {oi: p for p, ops in enumerate(dx) for oi in ops}
    for oi, g in enumerate(plan):
        for pj, gp in enumerate(plan):
            if pj > oi and (seg.ops[oi].out in {t for t, _, _ in gp.jobs} or
                            {t for t, _, _ in g.jobs} & {t for t, _, _ in gp.jobs}):
                assert where[pj] < where[oi], (oi, pj)


def _production_segments():
    cfg = json.load(open("configs/distill.json"))
    dcfg = get_discriminator_config(parse_layers(cfg["models"]["discriminator"]["layers"]),
                                    expansion_size=1, ensemble_size=1)
    tm = ConfigurableModule(dcfg, mel_sampling_rate_override=16000, member_impl="fused")
    tm.build(torch.zeros(1, 2730, 1))
    rec, real = [], fm.fused_stream_graph

    def spy(seg, inputs, tables, biases, members=1, weight_grads=True):
        rec.append((seg, len(inputs), [b is not None for b in biases]))
        return sg.fused_stream_graph_reference(seg, inputs, tables, biases, members)

    fm.fused_stream_graph = spy
    try:
        with torch.no_grad():
            tm(torch.zeros(1, 2730, 1))
    finally:
        fm.fused_stream_graph = real
    return rec


def test_production_launches_per_distill_step():
    """One launch per segment and pass: 4 discriminator forwards x 10
    segments = 40; dx: the frozen copy (every input needs a gradient) and
    the two live calls (the audio takes none) 10 each = 30; dW: the live
    calls 10 each = 20 (chip_smoke.py's distill_launches_per_step)."""
    segs = _production_segments()
    assert len(segs) == 10
    step = {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
    for j, (seg, n_in, has_b) in enumerate(segs):
        n_out, n_tab = len(seg.ops), len(seg.edges)
        chained = [j > 0 and i == 0 for i in range(n_in)]
        w_tabs = [has_b[oi] for oi, op in enumerate(seg.ops) for _ in op.edges]
        live = sg.backward_plan(seg, chained, w_tabs, has_b, [True] * n_out)
        frozen = sg.backward_plan(seg, [True] * n_in, [False] * n_tab, [False] * n_out,
                                  [True] * n_out)
        step["fwd"] += 4
        for plan, calls in ((live, 2), (frozen, 1)):
            for k, v in sg.pass_launches(seg, plan).items():
                step[k] += calls * v
        for plan in (live, frozen):  # each plans within the kernels' limits
            sg.dx_schedule(seg, tuple(plan), 9)
            sg.dw_schedule(seg, tuple(plan), 9, 3)
        sg.forward_schedule(seg, 9)
    assert step == {"fwd": 40, "bwd_dx": 30, "bwd_dw": 20}


def test_host_caches_stay_bounded_across_member_calls(monkeypatch):
    """The kernels' host path (segment check, backward plan, schedules and
    launch arrays) under the production member, which builds new Segment
    objects on every call: a second forward and backward hit the caches
    and add nothing to them. The launches are stubbed out, so this runs on
    CPU tensors."""
    cfg = json.load(open("configs/distill.json"))
    dcfg = get_discriminator_config(parse_layers(cfg["models"]["discriminator"]["layers"]),
                                    expansion_size=1, ensemble_size=1)
    tm = ConfigurableModule(dcfg, mel_sampling_rate_override=16000, member_impl="fused")
    tm.build(torch.zeros(1, 2730, 1))
    launched, segs = [], []

    def graph(seg, inputs, tables, biases, members=1, weight_grads=True):
        segs.append(seg)
        return sg._fused(seg, inputs, tables, biases, members, weight_grads)

    monkeypatch.setattr(fm, "fused_stream_graph", graph)
    monkeypatch.setattr(sg, "_launch", lambda pas, prep, x0, ptrs: launched.append(pas))
    caches = (sg._checked, sg._plan, sg._prepared)
    sizes = []
    for _ in range(2):
        x = torch.zeros(1, 2730, 1, requires_grad=True)
        loss = sum(v.sum() for v in leaves(tm(x)))
        loss.backward()
        sizes.append([f.cache_info() for f in caches])
    assert len(segs) == 20 and segs[0] is not segs[10] and segs[0] == segs[10]
    assert launched[:30] == launched[30:] and launched.count("fwd") == 20
    assert [i.currsize for i in sizes[1]] == [i.currsize for i in sizes[0]]
    assert sizes[1][2].hits - sizes[0][2].hits == 30  # every launch of the second call


# ---------------------------------------------------------------------------
# against the JAX package: a small production-shaped member
# ---------------------------------------------------------------------------

LAYERS = ["roll:1,9,1", "roll:1,5,2", "roll:2,5,2", "all:3,5,2", "roll:4,3,1"]
SR = 16000


class _Emulated(torch.autograd.Function):
    """The emulated launches as the CUDA path's autograd Function runs them."""

    @staticmethod
    def forward(ctx, seg, members, n_in, n_tab, *args):
        ins, tabs, bs = args[:n_in], args[n_in:n_in + n_tab], args[n_in + n_tab:]
        ys = emulate_forward(seg, ins, tabs, bs, members)
        ctx.seg, ctx.members, ctx.n_in = seg, members, n_in
        ctx.bias = [b is not None for b in bs]
        ctx.save_for_backward(*ins, *ys, *tabs)
        ctx.set_materialize_grads(False)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        seg, n_in = ctx.seg, ctx.n_in
        saved = ctx.saved_tensors
        ins, ys, tabs = saved[:n_in], saved[n_in:n_in + len(seg.ops)], saved[n_in + len(seg.ops):]
        need = ctx.needs_input_grad[4:]
        plan = sg.backward_plan(seg, need[:n_in], need[n_in:n_in + len(tabs)],
                                need[n_in + len(tabs):], [d is not None for d in dys])
        dxs, dws, dbs = emulate_backward(seg, ins, ys, dys, tabs, ctx.members, plan)
        zero = [torch.zeros_like(t) for t in (*ins, *tabs)]
        return (None, None, None, None,
                *[d if d is not None or not n else z for d, n, z in zip(
                    [*dxs, *dws], need, zero)],
                *[d if n else None for d, n in zip(dbs, need[n_in + len(tabs):])])


def _emulated_graph(seg, inputs, tables, biases, members=1, weight_grads=True):
    assert weight_grads
    return list(_Emulated.apply(seg, members, len(inputs), len(tables), *inputs, *tables,
                                *biases))


def _loss_jax(jm, variables, x):
    out = jm.apply(variables, x, mutable=["spectral"])[0]
    return sum(jnp.sum(jnp.abs(v)) for v in jax.tree_util.tree_leaves(out["output"])) + 0.1 * sum(
        jnp.mean(jnp.abs(f)) for f in jax.tree_util.tree_leaves(out["features"]))


def test_emulated_member_matches_jax(monkeypatch):
    """The small production-shaped member of tests/test_torch_stream_graph.py
    through the emulated launches against the JAX package's fused member
    (its XLA reference executor): outputs and input gradient."""
    cfg = get_discriminator_config(parse_layers(LAYERS), expansion_size=1, ensemble_size=2)
    x = np.random.default_rng(5).standard_normal((2, 144, 1)).astype(np.float32)
    kw = {"mel_sampling_rate_override": SR, "update_spectral": True}
    _, variables, tm = dsl_pair(cfg, x, jax_kw=dict(kw, member_impl="interpret"),
                                torch_kw=dict(kw, member_impl="fused"))
    monkeypatch.setattr(jsg, "REFERENCE_EXECUTOR", True)
    jm = JaxModule(config=cfg, member_impl="fused_interpret", **kw)
    want = jax.tree_util.tree_leaves(run_cheap(
        lambda v, xx: jm.apply(v, xx, mutable=["spectral"])[0], variables, jnp.asarray(x)))
    gx = run_cheap(jax.grad(lambda xx: _loss_jax(jm, variables, xx)), jnp.asarray(x))
    monkeypatch.setattr(fm, "fused_stream_graph", _emulated_graph)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    got = leaves(out)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=2e-5, rtol=0)
    loss = sum(v.abs().sum() for v in leaves(out["output"])) + 0.1 * sum(
        f.abs().mean() for f in leaves(out["features"]))
    (gt,) = torch.autograd.grad(loss, [xt])
    np.testing.assert_allclose(gt.numpy(), np.asarray(gx), rtol=2e-4, atol=2e-3)
