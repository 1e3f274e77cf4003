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
  CUDA tensors it launches ``csrc/stream_graph.cu`` or raises.
- ``LAUNCHES_FWD``, ``LAUNCHES_BWD_DX`` and ``LAUNCHES_BWD_DW`` count the
  launches of the three entry points: one per op and pass (the dW entry
  runs a partial-sum kernel and its reduction, counted once).
"""

from __future__ import annotations

import ctypes
import dataclasses
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
_DW_TARGET_BLOCKS = 264
_DW_MIN_ROWS = 256
_DW_SMALL_OUT = 1024  # csrc/stream_graph.cu kSmallOut


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
# CUDA path
# ---------------------------------------------------------------------------

_KERNELS = None


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        from hifigan_tpu_torch.ops import _build

        lib = _build.load("stream_graph")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd, dx, dw = lib.hifigan_sg_fwd, lib.hifigan_sg_dx, lib.hifigan_sg_dw
        fwd.argtypes = [ci, ci, vp, vp, vp, vp, vp, ci, vp, ci, ci, ci, cf, ci, ci, vp]
        dx.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci, ci, vp]
        dw.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci, ci,
                       ci, ci, vp]
        for fn in (fwd, dx, dw):
            fn.restype = ci
        _KERNELS = (fwd, dx, dw)
    return _KERNELS


def _ptrs(ts) -> ctypes.Array:
    vals = [0 if t is None else t.data_ptr() for t in ts]
    return (ctypes.c_void_p * max(1, len(vals)))(*vals)


def _ints(vals) -> ctypes.Array:
    vals = list(vals)
    return (ctypes.c_int * max(1, len(vals)))(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_stream_graph {what} kernel launch failed: cudaError {rc}")


def _edge_geom(seg: Segment, e: Edge) -> list[int]:
    return [edge_t_src(seg, e), e.c_in, e.kernel, e.stride, e.dilation, e.pad]


def _forward_cuda(seg: Segment, inputs, tables, biases, members: int) -> list[torch.Tensor]:
    global LAUNCHES_FWD
    fwd, _, _ = _kernels()
    x0 = inputs[0]
    b, n_per = x0.shape[0], x0.shape[0] // members
    vals: dict[int, torch.Tensor] = {}
    ii = 0
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            vals[li] = inputs[ii]
            ii += 1
    tab = 0
    outs = []
    for oi, op in enumerate(seg.ops):
        lvl = seg.levels[op.out]
        y = torch.empty((b, lvl.t, lvl.c), dtype=x0.dtype, device=x0.device)
        ws = tables[tab:tab + len(op.edges)]
        tab += len(op.edges)
        geom = [g for e in op.edges for g in _edge_geom(seg, e)]
        res = vals[op.res_from] if op.res_from is not None else None
        rc = fwd(_DTYPE_CODE[x0.dtype], len(op.edges), _ptrs([vals[e.src] for e in op.edges]),
                 _ptrs(ws), _ints(geom), None if biases[oi] is None else biases[oi].data_ptr(),
                 None if res is None else res.data_ptr(),
                 0 if res is None else seg.levels[op.res_from].size, y.data_ptr(), lvl.t, lvl.c,
                 ACTS[op.act], float(op.slope), members, n_per, _stream(x0))
        _raise_if(rc, "forward")
        LAUNCHES_FWD += 1
        vals[op.out] = y
        outs.append(y)
    return outs


def _dw_splits(kdim: int, c_out: int, rows: int, jobs: int, members: int) -> tuple[int, int]:
    """(splits, rows per split) of a member's dW reduction over N*T. Few
    outputs ((kdim + 1) * c_out <= 1024) take one block per job and split
    (the kernel's ``dw_small`` path); aim at twice as many blocks then."""
    if (kdim + 1) * c_out <= _DW_SMALL_OUT:
        tiles, target = max(jobs, 1) * members, 2 * _DW_TARGET_BLOCKS
    else:
        bn = 64 if c_out >= 64 else (32 if c_out >= 32 else (16 if c_out >= 16 else 8))
        tiles = -(-max(kdim, 1) // (4096 // bn)) * -(-c_out // bn) * max(jobs, 1) * members
        target = _DW_TARGET_BLOCKS
    splits = max(1, min(-(-target // tiles), rows // _DW_MIN_ROWS))
    split_rows = -(-rows // (16 * splits)) * 16
    return -(-rows // split_rows), split_rows


def _backward_cuda(seg: Segment, plan, inputs, ys, dys, tables, members: int):
    global LAUNCHES_BWD_DX, LAUNCHES_BWD_DW
    _, dx_fn, dw_fn = _kernels()
    x0 = inputs[0]
    dtype, dev = x0.dtype, x0.device
    b, n_per = x0.shape[0], x0.shape[0] // members
    vals: dict[int, torch.Tensor] = {}
    da: dict[int, torch.Tensor] = {}
    ii = oi_ = 0
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            vals[li] = inputs[ii]
            ii += 1
        else:
            vals[li] = ys[oi_]
            if dys[oi_] is not None:  # a copy: the kernels add into it in place
                da[li] = dys[oi_].to(dtype).to(torch.float32, copy=True).contiguous()
            oi_ += 1

    def cot(li):
        if li not in da:
            da[li] = torch.zeros((b, seg.levels[li].size), dtype=torch.float32, device=dev)
        return da[li]

    tab_base = [0]
    for op in seg.ops:
        tab_base.append(tab_base[-1] + len(op.edges))
    dws: list = [None] * len(tables)
    dbs: list = [None] * len(seg.ops)
    stream = _stream(x0)
    code = _DTYPE_CODE[dtype]
    for oi in range(len(seg.ops) - 1, -1, -1):
        g = plan[oi]
        if g is None:
            continue
        op = seg.ops[oi]
        lvl = seg.levels[op.out]
        sq = vals[op.res_from] if op.act == "square" else None
        sq_stride = seg.levels[op.res_from].size if sq is not None else 0
        common = (da[op.out].data_ptr(), vals[op.out].data_ptr(),
                  None if sq is None else sq.data_ptr(), sq_stride, lvl.t, lvl.c, ACTS[op.act],
                  float(op.slope))
        if g.jobs:
            targets, jgeom = [], []
            ws = [None] * (MAX_EDGES * len(g.jobs))  # job j's edge n at j * MAX_EDGES + n
            egeom = [0] * (3 * MAX_EDGES * len(g.jobs))
            for j, (tgt, ks, res) in enumerate(g.jobs):
                c_tgt = op.edges[ks[0]].c_in if ks else lvl.c
                s = op.edges[ks[0]].stride if ks else 1
                targets.append(cot(tgt))
                jgeom += [seg.levels[tgt].size // c_tgt, c_tgt, s, len(ks), int(res)]
                for n, k in enumerate(ks):
                    e = op.edges[k]
                    ws[j * MAX_EDGES + n] = tables[tab_base[oi] + k]
                    egeom[(j * MAX_EDGES + n) * 3:(j * MAX_EDGES + n) * 3 + 3] = [
                        e.kernel, e.dilation, e.pad]
            rc = dx_fn(code, len(g.jobs), _ptrs(targets), _ints(jgeom), _ptrs(ws), _ints(egeom),
                       *common, members, n_per, stream)
            _raise_if(rc, "dx")
            LAUNCHES_BWD_DX += 1
        live = [k for k in range(len(op.edges)) if g.dw[k]]
        if live or g.db:
            rows = n_per * lvl.t
            kdim = max([op.edges[k].kernel * op.edges[k].c_in for k in live], default=0)
            splits, split_rows = _dw_splits(kdim, lvl.c, rows, len(live), members)
            srcs, jgeom, parts, outs = [], [], [], []
            for k in live:
                e = op.edges[k]
                t = tables[tab_base[oi] + k]
                srcs.append(vals[e.src])
                jgeom += _edge_geom(seg, e)
                parts.append(torch.empty((members, splits, e.kernel * e.c_in, lvl.c),
                                         dtype=torch.float32, device=dev))
                outs.append(torch.empty(t.shape, dtype=dtype, device=dev))
            pdb = db = None
            if g.db:
                pdb = torch.empty((members, splits, lvl.c), dtype=torch.float32, device=dev)
                db = torch.empty((members, lvl.c), dtype=torch.float32, device=dev)
            rc = dw_fn(code, len(live), _ptrs(srcs), _ints(jgeom), _ptrs(parts), _ptrs(outs),
                       None if pdb is None else pdb.data_ptr(),
                       None if db is None else db.data_ptr(), *common, members, n_per, splits,
                       split_rows, stream)
            _raise_if(rc, "dW")
            LAUNCHES_BWD_DW += 1
            for k, o in zip(live, outs):
                dws[tab_base[oi] + k] = o
            dbs[oi] = db
    dxs = []
    ii = 0
    for li, lvl in enumerate(seg.levels):
        if lvl.is_input:
            dxs.append(da[li].to(dtype).reshape(inputs[ii].shape) if li in da else None)
            ii += 1
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
        plan = backward_plan(seg, need[:n_in], dw_mask, db_mask, [d is not None for d in dys])
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
    check_segment(seg)
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
    _check(seg, inputs, tables, biases, members)
    dtype = x0.dtype
    ins = [x.contiguous() for x in inputs]
    tabs = [t.to(dtype).contiguous() for t in tables]
    bs = [None if bb is None else bb.float().contiguous() for bb in biases]
    with torch.cuda.device(x0.device):
        return list(_StreamGraph.apply(seg, members, bool(weight_grads), len(ins), len(tabs),
                                       *ins, *tabs, *bs))
