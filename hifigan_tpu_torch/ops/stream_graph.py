"""One stream-graph segment (a DAG of narrow conv1d ops) forward and backward
in CUDA, and its plain version.

Replaces ``hifigan_tpu/ops/pallas/stream_graph.py::fused_stream_graph``
(:786; forward ``_fwd_pallas`` :388, call :428; fused backward
``_bwd_pallas`` :600, call :678). The port's IR is in sample space:

- a :class:`Level` is an activation of ``t`` time steps and ``c`` channels
  per batch element, stored (B, t, c) time-major and channel-last;
- an :class:`Edge` reads its source level as ``(t*c // c_in, c_in)``, so
  ``conv_rech``'s rechannel and ``roll``'s period reshape are views of the
  same memory (what the TPU kernel's time fold gave it), and convolves it
  with a (K, c_in, c_out) kernel at stride, dilation and left padding
  ``pad``, with zeros past the source's own end;
- an :class:`Op` sums its edges in fp32 from its bias, adds an optional
  residual level (read with the op's ``c_out`` channels, its first ``t_out``
  rows), applies ``act`` in {none, lrelu, tanh, square, log1e5} and rounds to
  the working dtype; ops produce the non-input levels in level order.

The ``members`` of an ensemble share one call: batch element b belongs to
member ``b // (B // members)``, tables are stacked (members, K, c_in, c_out)
and biases (members, c_out) in fp32.

The backward follows the Pallas one: dz from the op's fp32 output cotangent
and its saved output (lrelu mask from the output's sign, tanh 1 - y^2,
log1e5 exp(-y) and zero where clipped, square 2 * its residual source), db
from the unrounded dz, dz rounded to the working dtype for dx and dW, the
residual source getting dz in fp32. What runs is decided by
:func:`backward_plan`: ``weight_grads=False`` or a table/bias without grad
skips its dW/db (and returns zeros under ``weight_grads=False``), an input
without grad skips its dx, a produced level whose cotangent is ``None`` adds
no dy, and a level that nothing needing a gradient reads is not
differentiated at all.

- :func:`fused_stream_graph_reference` is the plain PyTorch version
  (``F.conv1d`` grouped over members, autograd backward);
  :func:`fused_stream_graph_backward_reference` is the plain backward over
  given saved outputs (what the kernels are held against: two forwards that
  differ by rounding can flip a leaky-ReLU mask).
- :func:`fused_stream_graph` takes the plain version for CPU tensors; for
  CUDA tensors it launches ``csrc/stream_graph.cu`` or raises: one
  cooperative launch per segment and pass, planned here
  (:func:`forward_schedule`, :func:`dx_schedule`, :func:`dw_schedule`: the
  op phases and their grid barriers, each op's tile shape and channel
  chunk, the dW splits and their reduction order) and checked again by the
  C entry before it launches.
- ``LAUNCHES_FWD``, ``LAUNCHES_BWD_DX`` and ``LAUNCHES_BWD_DW`` count the
  launches of the three passes, one per segment each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

LAUNCHES_FWD = 0
LAUNCHES_BWD_DX = 0
LAUNCHES_BWD_DW = 0

ACTS = {"none": 0, "lrelu": 1, "tanh": 2, "square": 3, "log1e5": 4}
LOG_CLIP = 1e-5
MAX_EDGES = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class Level:
    t: int
    c: int
    is_input: bool = False

    @property
    def size(self) -> int:
        return self.t * self.c


@dataclasses.dataclass(frozen=True)
class Edge:
    src: int
    c_in: int
    kernel: int
    stride: int = 1
    dilation: int = 1
    pad: int = 0


@dataclasses.dataclass(frozen=True)
class Op:
    out: int
    edges: tuple = ()
    act: str = "none"
    slope: float = 0.1
    res_from: int | None = None


@dataclasses.dataclass(frozen=True)
class Segment:
    levels: tuple
    ops: tuple

    @property
    def edges(self) -> list[tuple[int, Edge]]:
        """(op index, edge) in table order (op-major)."""
        return [(oi, e) for oi, op in enumerate(self.ops) for e in op.edges]


def reset_launches() -> None:
    global LAUNCHES_FWD, LAUNCHES_BWD_DX, LAUNCHES_BWD_DW
    LAUNCHES_FWD = LAUNCHES_BWD_DX = LAUNCHES_BWD_DW = 0


def launches() -> dict[str, int]:
    return {"fwd": LAUNCHES_FWD, "bwd_dx": LAUNCHES_BWD_DX, "bwd_dw": LAUNCHES_BWD_DW}


def edge_t_src(seg: Segment, e: Edge) -> int:
    return seg.levels[e.src].size // e.c_in


def check_segment(seg: Segment) -> None:
    """Raise ValueError on a segment the kernels do not take."""
    produced = [i for i, lvl in enumerate(seg.levels) if not lvl.is_input]
    if [op.out for op in seg.ops] != produced:
        raise ValueError("ops must produce the non-input levels in level order")
    for oi, op in enumerate(seg.ops):
        out = seg.levels[op.out]
        if op.act not in ACTS:
            raise ValueError(f"op {oi}: unknown act {op.act!r}")
        if not op.edges and op.res_from is None:
            raise ValueError(f"op {oi}: no edge and no residual")
        if len(op.edges) > MAX_EDGES:
            raise ValueError(f"op {oi}: more than {MAX_EDGES} edges")
        if op.act == "square" and op.res_from is None:
            raise ValueError(f"op {oi}: square needs its residual source")
        for e in op.edges:
            if e.src >= op.out or seg.levels[e.src].size % e.c_in:
                raise ValueError(f"op {oi}: edge {e} does not read an earlier level")
            if e.stride > 1 and e.dilation > 1:
                raise ValueError(f"op {oi}: stride and dilation both above 1")
            if min(e.kernel, e.stride, e.dilation) < 1 or e.pad < 0:
                raise ValueError(f"op {oi}: bad edge {e}")
        if op.res_from is not None:
            src = seg.levels[op.res_from]
            if op.res_from >= op.out or src.size % out.c or src.size // out.c < out.t:
                raise ValueError(f"op {oi}: residual level is shorter than the output")


# ---------------------------------------------------------------------------
# backward plan (shared by the kernels and the plain backward)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpGrad:
    """What one op's backward does: dx jobs as (target level, edge indices
    into op.edges, residual?), dW per table index, db."""

    jobs: tuple
    dw: tuple
    db: bool


def backward_plan(seg: Segment, dx_mask: Sequence[bool], dw_mask: Sequence[bool],
                  db_mask: Sequence[bool], dy_mask: Sequence[bool]) -> list[OpGrad | None]:
    """Per op, its backward work or None.

    ``dx_mask`` per input level, ``dw_mask`` per table, ``db_mask`` per op,
    ``dy_mask`` per produced level (an external cotangent is given). A level
    needs a cotangent if it is an input with grad, or the output of an op
    with weight grads or with a source that needs one; it has one if it got
    a dy or a contribution. An op runs if its output needs and has one.
    """
    n_lvl = len(seg.levels)
    needs = [False] * n_lvl
    ii = 0
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            needs[li] = bool(dx_mask[ii])
            ii += 1
    tab = 0
    tab_base = []
    for oi, op in enumerate(seg.ops):
        tab_base.append(tab)
        tab += len(op.edges)
        src_need = any(needs[e.src] for e in op.edges) or (
            op.res_from is not None and needs[op.res_from])
        w_need = any(dw_mask[tab_base[oi] + k] for k in range(len(op.edges))) or db_mask[oi]
        needs[op.out] = src_need or w_need
    has = [False] * n_lvl
    oi_level = [li for li, lvl in enumerate(seg.levels) if not lvl.is_input]
    for k, li in enumerate(oi_level):
        has[li] = bool(dy_mask[k])
    plan: list[OpGrad | None] = [None] * len(seg.ops)
    for oi in range(len(seg.ops) - 1, -1, -1):
        op = seg.ops[oi]
        if not (needs[op.out] and has[op.out]):
            continue
        targets: dict[int, list] = {}
        for k, e in enumerate(op.edges):
            if needs[e.src]:
                targets.setdefault(e.src, []).append(k)
        res_live = op.res_from is not None and needs[op.res_from]
        if res_live:
            targets.setdefault(op.res_from, [])
        jobs = []
        for tgt, ks in targets.items():
            strides = {op.edges[k].stride for k in ks}
            views = {op.edges[k].c_in for k in ks}
            res = res_live and tgt == op.res_from
            if len(strides) > 1 or len(views) > 1 or (res and ks and (
                    strides != {1} or views != {seg.levels[op.out].c})):
                raise NotImplementedError(
                    f"op {oi}: edges reading level {tgt} differ in stride or channel view")
            jobs.append((tgt, tuple(ks), res))
            has[tgt] = True
        if len(jobs) > MAX_EDGES:
            raise NotImplementedError(f"op {oi}: more than {MAX_EDGES} source levels")
        dw = tuple(bool(dw_mask[tab_base[oi] + k]) for k in range(len(op.edges)))
        plan[oi] = OpGrad(tuple(jobs), dw, bool(db_mask[oi]))
    return plan


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _act(z: torch.Tensor, op: Op) -> torch.Tensor:
    if op.act == "lrelu":
        return torch.where(z >= 0, z, z * op.slope)
    if op.act == "tanh":
        return torch.tanh(z)
    if op.act == "square":
        return z * z
    if op.act == "log1e5":
        return torch.log(torch.clamp(z, min=LOG_CLIP))
    return z


def _act_vjp(da: torch.Tensor, y: torch.Tensor, op: Op, src: torch.Tensor | None):
    if op.act == "lrelu":
        return torch.where(y >= 0, da, da * op.slope)
    if op.act == "tanh":
        return da * (1.0 - y * y)
    if op.act == "square":
        return da * (2.0 * src)
    if op.act == "log1e5":
        return torch.where(y > math.log(LOG_CLIP), da * torch.exp(-y), torch.zeros_like(da))
    return da


def _conv_geom(seg: Segment, e: Edge, t_out: int) -> tuple[int, int, int]:
    """(t_src, right padding, conv output length >= t_out) of an edge."""
    t_src = edge_t_src(seg, e)
    need = (t_out - 1) * e.stride + (e.kernel - 1) * e.dilation + 1
    right = max(0, need - e.pad - t_src)
    n_out = (t_src + e.pad + right - (e.kernel - 1) * e.dilation - 1) // e.stride + 1
    return t_src, right, n_out


def _grouped(x: torch.Tensor, members: int) -> torch.Tensor:
    """(B, C, L) -> (N, members*C, L) with B = members * N."""
    b, c, l = x.shape
    return x.reshape(members, b // members, c, l).transpose(0, 1).reshape(b // members,
                                                                          members * c, l)


def _ungrouped(y: torch.Tensor, members: int) -> torch.Tensor:
    """(N, members*C, L) -> (B, C, L)."""
    n, mc, l = y.shape
    return y.reshape(n, members, mc // members, l).transpose(0, 1).reshape(n * members,
                                                                          mc // members, l)


def _edge_input(seg: Segment, e: Edge, x: torch.Tensor, t_out: int, members: int):
    t_src, right, n_out = _conv_geom(seg, e, t_out)
    xe = x.reshape(x.shape[0], t_src, e.c_in).transpose(1, 2)
    return _grouped(F.pad(xe, (e.pad, right)), members), n_out


def _table_oik(w: torch.Tensor) -> torch.Tensor:
    """(M, K, I, O) -> (M*O, I, K), the grouped conv weight."""
    m, k, i, o = w.shape
    return w.permute(0, 3, 2, 1).reshape(m * o, i, k)


def _forward_plain(seg: Segment, inputs, tables, biases, members: int) -> list[torch.Tensor]:
    dtype = inputs[0].dtype
    vals: dict[int, torch.Tensor] = {}
    ii = 0
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            vals[li] = inputs[ii].float()
            ii += 1
    b = inputs[0].shape[0]
    n = b // members
    tab = 0
    outs = []
    for oi, op in enumerate(seg.ops):
        lvl = seg.levels[op.out]
        acc = torch.zeros((b, lvl.c, lvl.t), dtype=torch.float32, device=inputs[0].device)
        if biases[oi] is not None:
            acc = acc + biases[oi].float().repeat_interleave(n, 0)[:, :, None]
        for e in op.edges:
            xg, _ = _edge_input(seg, e, vals[e.src], lvl.t, members)
            y = F.conv1d(xg, _table_oik(tables[tab].to(dtype).float()), stride=e.stride,
                         dilation=e.dilation, groups=members)
            acc = acc + _ungrouped(y, members)[:, :, :lvl.t]
            tab += 1
        if op.res_from is not None:
            res = vals[op.res_from].reshape(b, -1, lvl.c)[:, :lvl.t]
            acc = acc + res.transpose(1, 2)
        y = _act(acc.transpose(1, 2), op).to(dtype)
        vals[op.out] = y.float()
        outs.append(y.contiguous())
    return outs


class _ZeroGrad(torch.autograd.Function):
    """Identity whose gradient is zero: weights under ``weight_grads=False``."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


def fused_stream_graph_reference(seg: Segment, inputs: Sequence[torch.Tensor],
                                 tables: Sequence[torch.Tensor],
                                 biases: Sequence[torch.Tensor | None], members: int = 1,
                                 weight_grads: bool = True) -> list[torch.Tensor]:
    """Plain PyTorch version of :func:`fused_stream_graph` (autograd backward)."""
    check_segment(seg)
    if not weight_grads:
        tables = [_ZeroGrad.apply(t) for t in tables]
        biases = [None if b is None else _ZeroGrad.apply(b) for b in biases]
    return _forward_plain(seg, list(inputs), list(tables), list(biases), members)


def fused_stream_graph_backward_reference(seg: Segment, inputs: Sequence[torch.Tensor],
                                          ys: Sequence[torch.Tensor],
                                          dys: Sequence[torch.Tensor | None],
                                          tables: Sequence[torch.Tensor], members: int = 1,
                                          dx_mask=None, dw_mask=None, db_mask=None, plan=None):
    """Plain version of the CUDA backward over given outputs ``ys``.

    Returns (dxs, dWs, dbs): one dx per input (None where ``dx_mask`` is
    False), one dW per table in the working dtype (None where not wanted or
    not reached), one fp32 db (members, c_out) per op (likewise). ``plan``
    overrides :func:`backward_plan` (a timing of the dW pass alone drops the
    dx jobs).
    """
    check_segment(seg)
    dtype = inputs[0].dtype
    n_in = len(inputs)
    dx_mask = [True] * n_in if dx_mask is None else list(dx_mask)
    dw_mask = [True] * len(tables) if dw_mask is None else list(dw_mask)
    db_mask = [True] * len(seg.ops) if db_mask is None else list(db_mask)
    if plan is None:
        plan = backward_plan(seg, dx_mask, dw_mask, db_mask, [d is not None for d in dys])
    b = inputs[0].shape[0]
    vals: dict[int, torch.Tensor] = {}
    da: dict[int, torch.Tensor] = {}
    ii = oi_ = 0
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            vals[li] = inputs[ii].float().reshape(b, -1)
            ii += 1
        else:
            vals[li] = ys[oi_].float().reshape(b, -1)
            if dys[oi_] is not None:
                da[li] = dys[oi_].to(dtype).float().reshape(b, -1).clone()
            oi_ += 1

    def cot(li):
        if li not in da:
            da[li] = torch.zeros((b, seg.levels[li].size), dtype=torch.float32,
                                 device=inputs[0].device)
        return da[li]

    tab_base = [0]
    for op in seg.ops:
        tab_base.append(tab_base[-1] + len(op.edges))
    dws: list = [None] * len(tables)
    dbs: list = [None] * len(seg.ops)
    for oi in range(len(seg.ops) - 1, -1, -1):
        g = plan[oi]
        if g is None:
            continue
        op = seg.ops[oi]
        lvl = seg.levels[op.out]
        flat = lvl.t * lvl.c
        sq = vals[op.res_from][:, :flat] if op.act == "square" else None
        dz = _act_vjp(da[op.out], vals[op.out], op, sq)  # (B, t*c) fp32
        dz3 = dz.reshape(b, lvl.t, lvl.c)
        if g.db:
            dbs[oi] = dz3.reshape(members, -1, lvl.c).sum(1)
        dzg = _grouped(dz3.to(dtype).float().transpose(1, 2), members)
        targets = {tgt: (ks, res) for tgt, ks, res in g.jobs}
        for k, e in enumerate(op.edges):
            ti = tab_base[oi] + k
            need_x = e.src in targets and k in targets[e.src][0]
            if not (g.dw[k] or need_x):
                continue
            xg, n_out = _edge_input(seg, e, vals[e.src], lvl.t, members)
            dzp = F.pad(dzg, (0, n_out - lvl.t))
            w = _table_oik(tables[ti].to(dtype).float())
            if g.dw[k]:
                dw = torch.nn.grad.conv1d_weight(xg, tuple(w.shape), dzp, stride=e.stride,
                                                 dilation=e.dilation, groups=members)
                m_, k_, i_, o_ = tables[ti].shape
                dws[ti] = dw.reshape(m_, o_, i_, k_).permute(0, 3, 2, 1).to(dtype).contiguous()
            if need_x:
                dxg = torch.nn.grad.conv1d_input(tuple(xg.shape), w, dzp, stride=e.stride,
                                                 dilation=e.dilation, groups=members)
                t_src = edge_t_src(seg, e)
                dx = _ungrouped(dxg, members)[:, :, e.pad:e.pad + t_src].transpose(1, 2)
                cot(e.src).add_(dx.reshape(b, -1))
        if op.res_from is not None and op.res_from in targets:
            cot(op.res_from)[:, :flat].add_(dz)
    dxs = []
    ii = 0
    for li, lvl in enumerate(seg.levels):
        if not lvl.is_input:
            continue
        if not dx_mask[ii]:
            dxs.append(None)
        elif li in da:
            dxs.append(da[li].to(dtype).reshape(inputs[ii].shape))
        else:
            dxs.append(torch.zeros_like(inputs[ii]))
        ii += 1
    return dxs, dws, dbs


# ---------------------------------------------------------------------------
# the kernels' schedule: one cooperative launch per segment and pass
# ---------------------------------------------------------------------------

THREADS = 256  # threads of a block (csrc/stream_graph.cu kThreads)
TM = 4  # rows of a thread's micro-tile (kTM)
WIN_CAP = 8192  # fp32 slots of a block's staged window (kWinCap)
W_CAP = 8192  # fp32 slots of its staged weights, or of dW's staged dz (kWCap)
# the launch's by-value description holds at most (kMaxLevels, kMaxEdges,
# kMaxOps, kMaxUnits, kMaxPhases)
MAX_LEVELS, MAX_SEG_EDGES, MAX_OPS, MAX_UNITS, MAX_PHASES = 16, 12, 10, 20, 20
DW_TARGET_TILES = 1056  # dW tiles a launch aims at: ~4 for each block of a 2-per-SM grid
MIN_TILES = 264  # a fwd/dx unit with fewer tiles splits its reduction's channels over lanes
MAX_LANES = 8
DW_MIN_TILES = 128  # a dW unit's splits give it this many tiles where its rows allow
DW_MIN_ROWS = 64  # fewest rows a dW split sums
DB_ROWS_PER_THREAD = 16  # rows each thread of a db tile sums
DB_COLS = 32  # columns of a db tile
_PASS = {"fwd": 0, "dx": 1, "dw": 2}
_CACHED = 256  # segments, plans and launches a host cache keeps (by value)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Unit:
    """One set of tiles of a pass: an op's forward, one dx job of an op
    (one target level), one dW edge of an op, or an op's db (``edges`` empty
    in the dW pass).

    A fwd/dx tile is ``TM * ty`` rows of one element (dx: of one stride
    phase of the target) by ``tn * tx`` columns; thread (i, j) of a lane
    takes rows j + r * ty (r < TM) and columns i * tn + c (c < tn), and the
    ``lanes`` split each staged chunk's channels. A dW tile is ``TM * ty``
    (tap, channel) rows of the table by ``tn * tx`` columns over one split of
    the member's rows, the lanes taking every lanes-th row; a db tile is
    ``tx`` columns, ``lanes`` threads to a column. A compact dx
    job (one edge of stride s > 1 whose taps do not overlap, K <= s) tiles
    the op's output rows by (tap, channel) columns instead of stride phases:
    each target row is one output row's tap, so nothing is staged twice.
    """

    op: int
    tn: int  # output columns a thread (1..4)
    tx: int  # threads across a tile's columns
    ty: int  # threads across its rows
    cw: int  # channels a staged window holds (fwd: of c_in; dx: of c_out)
    tiles: int
    rt: int  # row tiles (fwd: per element; dx: per element and phase; dW: over K * c_in)
    ct: int  # column tiles
    tgt: int = -1  # dx: the level whose cotangent the job adds into
    s: int = 1  # dx: the stride of the job's edges (its phases)
    res: bool = False  # dx: the target is the op's residual source
    compact: bool = False  # dx: one strided edge with K <= s, tiled by output rows
    edges: tuple = ()  # segment edge indices (table order)
    lanes: int = 1  # thread groups splitting the reduction, summed in lane order
    rc: int = 0  # dW: output rows staged at a time
    splits: int = 1  # dW, db
    split_rows: int = 0  # dW, db


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """The units of one launch in phase order; phase p runs units
    [phase_end[p - 1], phase_end[p]) and ends at a grid-wide barrier. The dx
    launch first sets every cotangent slot (``slots``) and ends by rounding
    the inputs' cotangents; the dW launch ends by summing its partials."""

    units: tuple
    phase_end: tuple
    slots: tuple = ()


def col_tiling(ncols: int) -> tuple[int, int, int]:
    """(tn, tx, column tiles) for ``ncols`` output columns: up to 4 columns
    take one thread's whole row (no padding column); wider ones 4 a thread,
    at most 64 a tile, split evenly."""
    if ncols <= 4:
        return ncols, 1, 1
    ct = _cdiv(ncols, 64)
    tx = _cdiv(_cdiv(ncols, ct), 4)
    return 4, tx, _cdiv(ncols, 4 * tx)


def window(rows: int, k: int, s: int, d: int) -> tuple[int, int, int, bool]:
    """(staged rows, row step, tap step, compact) of an edge's window for
    ``rows`` consecutive output rows: output row r, tap k reads staged row
    r * step + k * tap step. A dense window holds every source row the taps
    span; a compact one (receptive fields that do not overlap, (K-1)d < s)
    only each output row's K taps."""
    span = (k - 1) * d + 1
    if span <= s:
        return rows * k, k, 1, True
    return (rows - 1) * s + span, s, d, False


def channel_span(r0: int, r1: int, c_in: int) -> tuple[int, int]:
    """(first channel, channels) a dW tile of table rows [r0, r1) reads,
    row = tap * c_in + channel."""
    if r0 // c_in == (r1 - 1) // c_in:
        return r0 % c_in, r1 - r0
    return 0, c_in


def _fit_channels(c_max: int, win_rows: list[int], w_per_channel: list[int]) -> int:
    """Most channels (<= c_max) one staged window holds: every edge's
    window rows x (cw | 1) within WIN_CAP and its weights within W_CAP
    (0: not even one)."""
    cw = c_max
    while cw > 0 and any(r * (cw | 1) > WIN_CAP or w * cw > W_CAP
                         for r, w in zip(win_rows, w_per_channel)):
        cw -= 1
    return cw


def _rows_that_fit(ty: int, fits) -> int:
    """The most thread rows (ty, halved from the given) for which
    ``fits(ty)`` is true: a window too tall for shared memory takes fewer
    output rows a tile."""
    while not fits(ty):
        if ty == 1:
            raise NotImplementedError("one row's window does not fit in shared memory")
        ty //= 2
    return ty


def forward_phases(seg: Segment) -> list[list[int]]:
    """Ops by phase of the forward launch: an op runs one phase after the
    last op producing a level it reads."""
    producer = {op.out: oi for oi, op in enumerate(seg.ops)}
    phase: list[int] = []
    for op in seg.ops:
        reads = [e.src for e in op.edges] + ([op.res_from] if op.res_from is not None else [])
        phase.append(max((phase[producer[li]] + 1 for li in reads if li in producer), default=0))
    return [[oi for oi, p in enumerate(phase) if p == q] for q in range(max(phase) + 1)]


def dx_phases(seg: Segment, plan) -> list[list[int]]:
    """Ops with dx jobs by phase of the dx launch (ops in reverse order): an
    op runs after every op that adds into its output's cotangent, and after
    every later op adding into a level it adds into, so each cotangent sums
    its contributions in reverse op order as the plain backward does."""
    phase: dict[int, int] = {}
    for oi in range(len(seg.ops) - 1, -1, -1):
        g = plan[oi]
        if g is None or not g.jobs:
            continue
        mine = {tgt for tgt, _, _ in g.jobs}
        p = 0
        for pj, pp in phase.items():
            theirs = {tgt for tgt, _, _ in plan[pj].jobs}
            if seg.ops[oi].out in theirs or mine & theirs:
                p = max(p, pp + 1)
        phase[oi] = p
    n = max(phase.values(), default=-1) + 1
    return [[oi for oi in sorted(phase, reverse=True) if phase[oi] == q] for q in range(n)]


def cotangent_levels(seg: Segment, plan) -> tuple:
    """Levels with an fp32 cotangent slot in the backward: every level a dx
    job adds into and every output of an op that runs."""
    out = set()
    for oi, g in enumerate(plan):
        if g is not None:
            out.add(seg.ops[oi].out)
            out.update(tgt for tgt, _, _ in g.jobs)
    return tuple(sorted(out))


def _tab_base(seg: Segment) -> list[int]:
    base = [0]
    for op in seg.ops:
        base.append(base[-1] + len(op.edges))
    return base


def _check_caps(seg: Segment, units: list, phases: int) -> None:
    if (len(seg.levels) > MAX_LEVELS or len(seg.edges) > MAX_SEG_EDGES
            or len(seg.ops) > MAX_OPS or len(units) > MAX_UNITS or phases > MAX_PHASES):
        raise NotImplementedError(
            f"segment of {len(seg.levels)} levels, {len(seg.edges)} edges, {len(seg.ops)} ops, "
            f"{len(units)} units in {phases} phases exceeds the kernels' "
            f"({MAX_LEVELS}, {MAX_SEG_EDGES}, {MAX_OPS}, {MAX_UNITS}, {MAX_PHASES})")


def _lanes(c_max: int, tx: int, tiles) -> int:
    """Thread groups splitting each staged chunk's channels: a unit with
    fewer than MIN_TILES tiles (``tiles(ty)``) takes fewer rows a tile and
    more lanes, summed in lane order."""
    lanes = 1
    while lanes < MAX_LANES and c_max >= 2 * lanes and tiles(THREADS // tx // lanes) < MIN_TILES:
        lanes *= 2
    return lanes


def _fwd_unit(seg: Segment, oi: int, e0: int, batch: int) -> Unit:
    """An op's forward tiles (an op on a short level, as the heads, with
    lanes: see :func:`_lanes`)."""
    op = seg.ops[oi]
    out = seg.levels[op.out]
    tn, tx, ct = col_tiling(out.c)
    c_max = max((e.c_in for e in op.edges), default=0)
    lanes = _lanes(c_max, tx, lambda ty: batch * _cdiv(out.t, TM * ty) * ct)

    def chunk(ty):
        rows = min(TM * ty, out.t)
        return _fit_channels(c_max, [window(rows, e.kernel, e.stride, e.dilation)[0]
                                     for e in op.edges], [e.kernel * tn * tx for e in op.edges])

    ty = _rows_that_fit(THREADS // tx // lanes, lambda ty: chunk(ty) or not c_max)
    cw = chunk(ty)
    rt = _cdiv(out.t, TM * ty)
    return Unit(oi, tn, tx, ty, cw, batch * rt * ct, rt, ct,
                edges=tuple(range(e0, e0 + len(op.edges))), lanes=lanes)


def forward_schedule(seg: Segment, batch: int) -> PassPlan:
    base = _tab_base(seg)
    phases = forward_phases(seg)
    units, ends = [], []
    for ops in phases:
        units += [_fwd_unit(seg, oi, base[oi], batch) for oi in ops]
        ends.append(len(units))
    _check_caps(seg, units, len(ends))
    return PassPlan(tuple(units), tuple(ends))


def _dx_unit(seg: Segment, oi: int, job, e0: int, batch: int) -> Unit:
    tgt, ks, res = job
    op = seg.ops[oi]
    out = seg.levels[op.out]
    edges = [op.edges[k] for k in ks]
    c_tgt = edges[0].c_in if edges else out.c
    s = edges[0].stride if edges else 1
    if len(edges) == 1 and s > 1 and edges[0].kernel <= s:
        e = edges[0]
        tn, tx, ct = col_tiling(e.kernel * c_tgt)
        lanes = _lanes(out.c, tx, lambda ty: batch * _cdiv(out.t, TM * ty) * ct)

        def chunk(ty):
            return _fit_channels(out.c, [min(TM * ty, out.t)], [tn * tx])

        ty = _rows_that_fit(THREADS // tx // lanes, chunk)
        rt = _cdiv(out.t, TM * ty)
        return Unit(oi, tn, tx, ty, chunk(ty), batch * rt * ct, rt, ct, tgt=tgt, s=s,
                    edges=(e0 + ks[0],), lanes=lanes, compact=True)
    rows_ph = _cdiv(seg.levels[tgt].size // c_tgt, s)  # rows of phase 0, the most of any
    tn, tx, ct = col_tiling(c_tgt)
    taps = [(e.kernel, e.dilation) if s == 1 else (_cdiv(e.kernel, s), 1) for e in edges]
    c_max = out.c if edges else 0
    lanes = _lanes(c_max, tx, lambda ty: s * batch * _cdiv(rows_ph, TM * ty) * ct)

    def chunk(ty):
        rows = min(TM * ty, rows_ph)
        return _fit_channels(c_max, [rows + (nq - 1) * dq for nq, dq in taps],
                             [nq * tn * tx for nq, _ in taps])

    ty = _rows_that_fit(THREADS // tx // lanes, lambda ty: chunk(ty) or not c_max)
    cw = chunk(ty)
    rt = _cdiv(rows_ph, TM * ty)
    return Unit(oi, tn, tx, ty, cw, s * batch * rt * ct, rt, ct, tgt=tgt, s=s, res=res,
                edges=tuple(e0 + k for k in ks), lanes=lanes)


def dx_schedule(seg: Segment, plan: tuple, batch: int) -> PassPlan:
    base = _tab_base(seg)
    units, ends = [], []
    for ops in dx_phases(seg, plan):
        units += [_dx_unit(seg, oi, job, base[oi], batch) for oi in ops for job in plan[oi].jobs]
        ends.append(len(units))
    _check_caps(seg, units, len(ends))
    return PassPlan(tuple(units), tuple(ends), cotangent_levels(seg, plan))


def _dw_unit(seg: Segment, oi: int, e: Edge, ei: int) -> Unit:
    out = seg.levels[seg.ops[oi].out]
    tn, tx, ct = col_tiling(out.c)
    r_all = e.kernel * e.c_in
    _, _, _, compact = window(1, e.kernel, e.stride, e.dilation)
    taps = (e.kernel - 1) * e.dilation + 1

    def row_chunk(ty):
        """Output rows a staged chunk holds for tiles of TM * ty table rows."""
        bmo = TM * ty
        span = max(channel_span(r0, min(r_all, r0 + bmo), e.c_in)[1]
                   for r0 in range(0, r_all, bmo))
        cap = WIN_CAP // (span | 1)
        rc = cap // e.kernel if compact else (cap - taps) // e.stride + 1 if cap >= taps else 0
        return min(rc, W_CAP // (tn * tx))

    ty = _rows_that_fit(min(THREADS // tx, _cdiv(r_all, TM)), lambda ty: row_chunk(ty) >= 1)
    rc, bmo = row_chunk(ty), TM * ty
    return Unit(oi, tn, tx, ty, 0, 0, _cdiv(r_all, bmo), ct, edges=(ei,),
                lanes=THREADS // (tx * ty), rc=rc)


def _with_splits(u: Unit, splits: int, rows_m: int, members: int) -> Unit:
    split_rows = _cdiv(rows_m, max(1, splits))
    splits = _cdiv(rows_m, split_rows)
    return dataclasses.replace(u, splits=splits, split_rows=split_rows,
                               tiles=members * splits * u.rt * u.ct)


def dw_schedule(seg: Segment, plan: tuple, batch: int, members: int) -> PassPlan:
    """Every live dW edge and db of the segment in one phase; a dW unit's
    splits make its tiles about as large as the launch's average (about
    DW_TARGET_TILES tiles in all) and give it DW_MIN_TILES tiles at least,
    each split DW_MIN_ROWS rows or more; a db tile's threads sum
    DB_ROWS_PER_THREAD rows each."""
    base = _tab_base(seg)
    n_per = batch // members
    dw, db = [], []
    for oi, g in enumerate(plan):
        if g is None:
            continue
        rows_m = n_per * seg.levels[seg.ops[oi].out].t
        for k, e in enumerate(seg.ops[oi].edges):
            if g.dw[k]:
                dw.append((_dw_unit(seg, oi, e, base[oi] + k), rows_m,
                           rows_m * e.kernel * e.c_in * seg.levels[seg.ops[oi].out].c))
        if g.db:
            c = seg.levels[seg.ops[oi].out].c
            bn = min(c, DB_COLS)
            u = Unit(oi, 1, bn, 1, 0, 0, 1, _cdiv(c, bn), lanes=THREADS // bn)
            db.append(_with_splits(u, _cdiv(rows_m, DB_ROWS_PER_THREAD * u.lanes), rows_m,
                                   members))
    target = sum(w for _, _, w in dw) / DW_TARGET_TILES
    units = [_with_splits(u, min(max(1, round(w / (u.rt * u.ct) / max(target, 1.0)),
                                     _cdiv(DW_MIN_TILES, members * u.rt * u.ct)),
                                 max(1, rows_m // DW_MIN_ROWS)), rows_m, members)
             for u, rows_m, w in dw] + db
    _check_caps(seg, units, 1)
    return PassPlan(tuple(units), (len(units),) if units else ())


def pass_launches(seg: Segment, plan) -> dict[str, int]:
    """Launches of one backward call under ``plan``: one dx launch if any op
    runs (it also sets the cotangents the dW launch reads), one dW launch if
    any weight or bias gradient is wanted."""
    return {"bwd_dx": int(any(g is not None for g in plan)),
            "bwd_dw": int(any(g is not None and (any(g.dw) or g.db) for g in plan))}


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_KERNELS = None
_GRID: dict = {}  # (dtype code, pass, device index) -> co-resident blocks of the launch


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        from hifigan_tpu_torch.ops import _build

        lib = _build.load("stream_graph")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        run, occ = lib.hifigan_sg_run, lib.hifigan_sg_blocks_per_sm
        run.argtypes = [ci, ci, vp, vp, vp, vp, ci, vp]
        occ.argtypes = [ci, ci, vp]
        run.restype = occ.restype = ci
        _KERNELS = (run, occ)
    return _KERNELS


def _ints(vals) -> ctypes.Array:
    vals = list(vals)
    return (ctypes.c_int * max(1, len(vals)))(*vals)


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_stream_graph {what} kernel launch failed: cudaError {rc}")


@dataclasses.dataclass
class _Launch:
    """One pass over one segment, ready to launch: its schedule and the
    ctypes arrays csrc/stream_graph.cu reads."""

    sched: PassPlan
    geo: ctypes.Array
    units: ctypes.Array
    slopes: ctypes.Array
    n_ptrs: int


def _prepare(seg: Segment, sched: PassPlan, batch: int, members: int) -> _Launch:
    geo = [len(seg.levels), len(seg.edges), len(seg.ops), batch, members, batch // members]
    for lvl in seg.levels:
        geo += [lvl.t, lvl.c, int(lvl.is_input)]
    for _, e in seg.edges:
        geo += [e.src, e.c_in, edge_t_src(seg, e), e.kernel, e.stride, e.dilation, e.pad]
    base = _tab_base(seg)
    for oi, op in enumerate(seg.ops):
        geo += [op.out, -1 if op.res_from is None else op.res_from, ACTS[op.act], base[oi],
                len(op.edges)]
    units = [len(sched.units), len(sched.phase_end), *sched.phase_end]
    for u in sched.units:  # kUnitInts each
        units += [u.op, u.tn, u.tx, u.ty, u.cw, u.tiles, u.rt, u.ct, u.tgt, u.s, int(u.res),
                  len(u.edges), *u.edges, *[-1] * (4 - len(u.edges)), u.lanes, u.rc, u.splits,
                  u.split_rows, int(u.compact)]
    slopes = (ctypes.c_float * len(seg.ops))(*[op.slope for op in seg.ops])
    n_ptrs = 3 * len(seg.levels) + len(seg.edges) + len(seg.ops) + 2 * len(sched.units)
    return _Launch(sched, _ints(geo), _ints(units), slopes, n_ptrs)


# The host work of a call is cached by value: the distill step's fused
# member builds a new, equal Segment on every call, and :func:`_checked`
# hands back the first one seen, so later lookups match it by identity.


@functools.lru_cache(maxsize=_CACHED)
def _checked(seg: Segment) -> Segment:
    check_segment(seg)
    return seg


@functools.lru_cache(maxsize=_CACHED)
def _plan(seg: Segment, masks: tuple) -> tuple:
    return tuple(backward_plan(seg, *masks))


@functools.lru_cache(maxsize=_CACHED)
def _prepared(seg: Segment, pas: str, plan: tuple | None, batch: int, members: int) -> _Launch:
    sched = (forward_schedule(seg, batch) if pas == "fwd" else dx_schedule(seg, plan, batch)
             if pas == "dx" else dw_schedule(seg, plan, batch, members))
    return _prepare(seg, sched, batch, members)


def _launch(pas: str, prep: _Launch, x0: torch.Tensor, ptrs: list) -> None:
    """One cooperative launch of pass ``pas`` over the segment, on every
    co-resident block (the dx launch's set-up and rounding, and the dW
    launch's sums, are grid-stride loops). ``ptrs``: per level its values,
    fp32 cotangent slot and dy (produced) or dx out (input); per edge its
    table; per op its bias; per unit its output and partials (dW)."""
    run, occ = _kernels()
    code, p = _DTYPE_CODE[x0.dtype], _PASS[pas]
    key = (code, p, x0.device.index)
    if key not in _GRID:
        per_sm = ctypes.c_int(0)
        _raise_if(occ(code, p, ctypes.byref(per_sm)), f"{pas} occupancy query")
        _GRID[key] = per_sm.value * torch.cuda.get_device_properties(
            x0.device).multi_processor_count
    vals = [0 if t is None else t.data_ptr() for t in ptrs]
    vals += [0] * (prep.n_ptrs - len(vals))
    _raise_if(run(code, p, prep.geo, prep.units, prep.slopes, (ctypes.c_void_p * len(vals))(*vals),
                  _GRID[key], torch.cuda.current_stream(x0.device).cuda_stream), pas)


def _level_values(seg: Segment, inputs, ys) -> list:
    it_in, it_out = iter(inputs), iter(ys)
    return [next(it_in) if lvl.is_input else next(it_out) for lvl in seg.levels]


def _forward_cuda(seg: Segment, inputs, tables, biases, members: int) -> list[torch.Tensor]:
    global LAUNCHES_FWD
    x0 = inputs[0]
    b = x0.shape[0]
    prep = _prepared(seg, "fwd", None, b, members)
    ys = [torch.empty((b, lvl.t, lvl.c), dtype=x0.dtype, device=x0.device)
          for lvl in seg.levels if not lvl.is_input]
    n_lv = len(seg.levels)
    _launch("fwd", prep, x0,
            _level_values(seg, inputs, ys) + [None] * (2 * n_lv) + list(tables) + list(biases))
    LAUNCHES_FWD += 1
    return ys


def _dx_cuda(seg: Segment, plan, inputs, ys, dys, tables, members: int):
    """The dx launch: sets every cotangent slot (dy or zero), runs the dx
    jobs phase by phase and rounds the inputs' cotangents. Returns ({level:
    its fp32 cotangent (B, size)}, dx per input or None)."""
    global LAUNCHES_BWD_DX
    x0 = inputs[0]
    b, dtype = x0.shape[0], x0.dtype
    prep = _prepared(seg, "dx", plan, b, members)
    slots = prep.sched.slots
    if not slots:
        return {}, [None] * len(inputs)
    ws = torch.empty((b * sum(seg.levels[li].size for li in slots),), dtype=torch.float32,
                     device=x0.device)
    da, off = {}, 0
    for li in slots:
        n = seg.levels[li].size
        da[li] = ws[off * b:(off + n) * b].view(b, n)
        off += n
    dyx, dxs, it = [], [], iter(dys)
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            dx = torch.empty((b, lvl.t, lvl.c), dtype=dtype, device=x0.device) if li in da else None
            dxs.append(dx)
            dyx.append(dx)
        else:
            dy = next(it)
            dyx.append(None if dy is None else dy.to(dtype).contiguous())
    _launch("dx", prep, x0,
            _level_values(seg, inputs, ys) + [da.get(li) for li in range(len(seg.levels))] + dyx
            + list(tables))
    LAUNCHES_BWD_DX += 1
    return da, dxs


def _dw_cuda(seg: Segment, plan, inputs, ys, da: dict, tables, members: int):
    """The dW launch over the cotangents of :func:`_dx_cuda`: every live
    table's and bias's gradient, split partials summed in split order in
    the same launch. Returns (dW per table or None, db per op or None)."""
    global LAUNCHES_BWD_DW
    x0 = inputs[0]
    b = x0.shape[0]
    prep = _prepared(seg, "dw", plan, b, members)
    dws: list = [None] * len(tables)
    dbs: list = [None] * len(seg.ops)
    if not prep.sched.units:
        return dws, dbs
    counts, outs = [], []
    for u in prep.sched.units:
        if u.edges:
            t = tables[u.edges[0]]
            counts.append(members * u.splits * t[0].numel())
            dws[u.edges[0]] = torch.empty(t.shape, dtype=x0.dtype, device=x0.device)
            outs.append(dws[u.edges[0]])
        else:
            c = seg.levels[seg.ops[u.op].out].c
            counts.append(members * u.splits * c)
            dbs[u.op] = torch.empty((members, c), dtype=torch.float32, device=x0.device)
            outs.append(dbs[u.op])
    parts = torch.split(torch.empty((sum(counts),), dtype=torch.float32, device=x0.device), counts)
    n_lv = len(seg.levels)
    _launch("dw", prep, x0,
            _level_values(seg, inputs, ys) + [da.get(li) for li in range(n_lv)] + [None] * n_lv
            + list(tables) + [None] * len(seg.ops) + outs + list(parts))
    LAUNCHES_BWD_DW += 1
    return dws, dbs


def _backward_cuda(seg: Segment, plan, inputs, ys, dys, tables, members: int):
    da, dxs = _dx_cuda(seg, plan, inputs, ys, dys, tables, members)
    dws, dbs = _dw_cuda(seg, plan, inputs, ys, da, tables, members)
    return dxs, dws, dbs


class _StreamGraph(torch.autograd.Function):
    """The CUDA segment; tensors come prepared by the wrapper."""

    @staticmethod
    def forward(ctx, seg, members, weight_grads, n_in, n_tab, *args):
        inputs = args[:n_in]
        tables = args[n_in:n_in + n_tab]
        biases = args[n_in + n_tab:]
        ys = _forward_cuda(seg, inputs, tables, biases, members)
        ctx.seg, ctx.members, ctx.weight_grads, ctx.n_in, ctx.n_tab = (
            seg, members, weight_grads, n_in, n_tab)
        ctx.bias_shapes = [None if bb is None else bb.shape for bb in biases]
        ctx.save_for_backward(*inputs, *ys, *tables)
        ctx.set_materialize_grads(False)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        seg, members, n_in, n_tab = ctx.seg, ctx.members, ctx.n_in, ctx.n_tab
        saved = ctx.saved_tensors
        inputs = saved[:n_in]
        ys = saved[n_in:n_in + len(seg.ops)]
        tables = saved[n_in + len(seg.ops):]
        need = ctx.needs_input_grad[5:]
        dw_mask = [ctx.weight_grads and need[n_in + i] for i in range(n_tab)]
        db_mask = [ctx.weight_grads and need[n_in + n_tab + i] for i in range(len(seg.ops))]
        masks = (tuple(need[:n_in]), tuple(dw_mask), tuple(db_mask),
                 tuple(d is not None for d in dys))
        plan = _plan(seg, masks)
        dys = [None if d is None else d.contiguous() for d in dys]
        dxs, dws, dbs = _backward_cuda(seg, plan, inputs, ys, dys, tables, members)
        grads = []
        for i, x in enumerate(inputs):
            grads.append((dxs[i] if dxs[i] is not None else torch.zeros_like(x))
                         if need[i] else None)
        for i, t in enumerate(tables):
            grads.append((dws[i] if dws[i] is not None else torch.zeros_like(t))
                         if need[n_in + i] else None)
        for i, shape in enumerate(ctx.bias_shapes):
            ok = need[n_in + n_tab + i]
            grads.append((dbs[i] if dbs[i] is not None else
                          torch.zeros(shape, dtype=torch.float32, device=inputs[0].device))
                         if ok else None)
        return (None, None, None, None, None, *grads)


def _check(seg: Segment, inputs, tables, biases, members: int) -> None:
    x0 = inputs[0]
    if x0.dtype not in _DTYPE_CODE:
        raise TypeError(f"inputs must be float32 or bfloat16, got {x0.dtype}")
    if x0.shape[0] % members:
        raise ValueError(f"batch {x0.shape[0]} is not a multiple of members {members}")
    in_levels = [lvl for lvl in seg.levels if lvl.is_input]
    if len(inputs) != len(in_levels) or len(tables) != len(seg.edges) or len(biases) != len(
            seg.ops):
        raise ValueError("one input per input level, one table per edge, one bias per op")
    for x, lvl in zip(inputs, in_levels):
        if tuple(x.shape) != (x0.shape[0], lvl.t, lvl.c) or x.dtype != x0.dtype or (
                x.device != x0.device):
            raise ValueError(f"input must be ({x0.shape[0]}, {lvl.t}, {lvl.c}) {x0.dtype}, "
                             f"got {tuple(x.shape)} {x.dtype} {x.device}")
    for (oi, e), t in zip(seg.edges, tables):
        want = (members, e.kernel, e.c_in, seg.levels[seg.ops[oi].out].c)
        if tuple(t.shape) != want or t.device != x0.device:
            raise ValueError(f"op {oi}: table must be {want} on {x0.device}, got {tuple(t.shape)}")
    for op, bb in zip(seg.ops, biases):
        if bb is not None and (tuple(bb.shape) != (members, seg.levels[op.out].c)
                               or bb.device != x0.device):
            raise ValueError(f"bias of level {op.out} must be (members, c_out) on x's device")


def fused_stream_graph(seg: Segment, inputs: Sequence[torch.Tensor],
                       tables: Sequence[torch.Tensor], biases: Sequence[torch.Tensor | None],
                       members: int = 1, weight_grads: bool = True) -> list[torch.Tensor]:
    """Run one segment: inputs (B, t, c) per input level in level order,
    tables (members, K, c_in, c_out) per edge in op-major order, biases
    (members, c_out) or None per op. Returns every produced level (B, t, c)
    in level order, in the inputs' dtype; differentiable in all three.

    ``weight_grads=False`` declares the tables and biases frozen (the
    distill trainer's discriminator copy): no dW/db work runs and their
    gradients are zero. A CPU tensor takes :func:`fused_stream_graph_reference`;
    a CUDA tensor launches the kernels or raises.
    """
    x0 = inputs[0]
    if x0.device.type == "cpu":
        return fused_stream_graph_reference(seg, inputs, tables, biases, members, weight_grads)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_stream_graph runs on cpu or cuda, got {x0.device}")
    with torch.cuda.device(x0.device):
        return _fused(seg, inputs, tables, biases, members, weight_grads)


def _fused(seg: Segment, inputs, tables, biases, members: int, weight_grads: bool) -> list:
    """The kernels' path of :func:`fused_stream_graph`, on the current device."""
    seg = _checked(seg)
    _check(seg, inputs, tables, biases, members)
    dtype = inputs[0].dtype
    ins = [x.contiguous() for x in inputs]
    tabs = [t.to(dtype).contiguous() for t in tables]
    bs = [None if bb is None else bb.float().contiguous() for bb in biases]
    return list(_StreamGraph.apply(seg, members, bool(weight_grads), len(ins), len(tabs),
                                   *ins, *tabs, *bs))
