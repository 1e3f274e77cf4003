"""Conv1d + bias + leaky-ReLU stacks (MSD layers 1-6 + conv_post), forward
and backward, in CUDA, and their plain version.

Replaces ``hifigan_tpu/ops/pallas/conv_stack.py::fused_conv_stack`` (:973;
forward kernel ``_fwd_pallas`` :374, fused backward ``_bwd_pallas`` :596).
Over x (N, T, C0) and layers ``LayerSpec(c_out, kernel, stride, groups,
pad_l, pad_r, slope)`` with kernels (K, C_in/groups, C_out) in the JAX
layout, each layer computes::

    y = lrelu(conv1d(x_l, W, stride, groups, zero pad (pad_l, pad_r)) + b)

accumulating in fp32, adding the bias in fp32, applying
``max(z, 0) + slope * min(z, 0)`` in fp32 and rounding to x's dtype; it
returns every layer's post-activation, T_out = (T + pad_l + pad_r - K)//s + 1.

The CUDA path (``csrc/conv_stack.cu`` on the implicit-GEMM core
``csrc/conv_core.cuh``, shared with ``ops/msd_conv.py``) makes one entry
call per layer and pass, and its backward follows the Pallas one:

- dz = (dy_l + upstream) * where(y_l >= 0, 1, slope) in fp32, from the saved
  post-activation, formed once per element and pass; db = sum dz in fp32
  (row-block partials summed in a fixed order); dz rounded to the working
  dtype feeds dW (rounded to the weight dtype) and dx; the upstream between
  layers stays fp32;
- a layer whose output gets no gradient and has nothing from above adds
  nothing; an input that needs no gradient skips layer 0's dx;
- ``weight_grads=False`` launches no dW/db work and returns zero weight and
  bias gradients.

What bounds it and what the design does about it is in the source note of
``csrc/conv_stack.cu``. The TPU kernel's lane folding, group densification
and backward chunking are VMEM devices and are not carried over.

The group time-fold ("zone") form of a grouped chain is carried over, with
the JAX layouts (``hifigan_tpu/ops/pallas/conv_stack.py:1117-1220``):
:func:`fold_group_zones` folds time into each group's lanes,
:func:`zone_grouped_layer` turns a grouped layer into a banded one over that
layout, and :func:`unfold_group_zones` undoes the fold at the chain's exit.
A sample count that does not divide the fold leaves a partial last row,
whose fold-padding lanes the layer's ``lane_period``/``lane_valid`` mask
zeroes: in the forward after the activation, and in dz before db sums it,
so dx and dW follow from the masked dz.

- :func:`fused_conv_stack_reference` is the plain PyTorch version: per-layer
  ``F.conv1d`` + bias + lrelu in fp32 with autograd.
- :func:`fused_conv_stack` takes the plain version for a CPU tensor; for a
  CUDA tensor it launches the kernels or raises.
- :func:`plan_conv` is the host planner of the core: the body (tensor
  cores, or the SIMT path of the narrow edges), tile, grid, shared memory,
  dW splits and scratch of one pass, mirroring the source's formulas.
- ``LAUNCHES_FWD``, ``LAUNCHES_BWD_DX`` and ``LAUNCHES_BWD_DW`` count the
  launches of the three entry points, each counted once: the dW entry runs
  the dz pass, the partial-sum kernel and its reduction; the dx entry the
  dz pass (when no dW entry formed dz for it) and the dx kernel.
  ``LAUNCHES_BY_LAYER`` counts the same launches by (pass, c_in, c_out,
  kernel, stride, groups), so the launches of given layers (a zone chain's)
  can be read apart.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.ops import _build
from hifigan_tpu_torch.parallel.mesh import data_axis, gather_rows, rows_are_local, split_rows

LAUNCHES_FWD = 0
LAUNCHES_BWD_DX = 0
LAUNCHES_BWD_DW = 0
LAUNCHES_BY_LAYER: dict[tuple, int] = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One conv1d (+ leaky-ReLU) layer of a stack; ``slope=1.0`` is no activation."""

    c_out: int
    kernel: int
    stride: int = 1
    groups: int = 1
    pad_l: int = 0
    pad_r: int = 0
    slope: float = 1.0
    # a partial last row (group time-fold of a length that does not divide
    # the fold): with lane_period > 0 the last output row of every element
    # keeps only the lanes with lane % lane_period < lane_valid; the rest
    # are fold padding and are zeroed
    lane_period: int = 0
    lane_valid: int = 0


def out_len(t: int, spec: LayerSpec) -> int:
    return (t + spec.pad_l + spec.pad_r - spec.kernel) // spec.stride + 1


def reset_launches() -> None:
    global LAUNCHES_FWD, LAUNCHES_BWD_DX, LAUNCHES_BWD_DW
    LAUNCHES_FWD = LAUNCHES_BWD_DX = LAUNCHES_BWD_DW = 0
    LAUNCHES_BY_LAYER.clear()


def layer_key(pass_: str, c_in: int, sp: LayerSpec) -> tuple:
    """The ``LAUNCHES_BY_LAYER`` key of one layer's pass ('fwd', 'bwd_dx', 'bwd_dw')."""
    return (pass_, c_in, sp.c_out, sp.kernel, sp.stride, sp.groups)


def _count(pass_: str, c_in: int, sp: LayerSpec) -> None:
    key = layer_key(pass_, c_in, sp)
    LAUNCHES_BY_LAYER[key] = LAUNCHES_BY_LAYER.get(key, 0) + 1


def launches() -> dict[str, int]:
    return {"fwd": LAUNCHES_FWD, "bwd_dx": LAUNCHES_BWD_DX, "bwd_dw": LAUNCHES_BWD_DW}


class _ZeroGrad(torch.autograd.Function):
    """Identity whose gradient is zero: weights under ``weight_grads=False``."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


def lane_mask(sp: LayerSpec, t_out: int, device=None) -> torch.Tensor | None:
    """(t_out, c_out) 0/1 fp32 mask of a partial last row's kept lanes, or
    None where the layer has none."""
    if sp.lane_period <= 0 or sp.lane_valid >= sp.lane_period:
        return None
    m = torch.ones((t_out, sp.c_out), dtype=torch.float32, device=device)
    m[-1] = (torch.arange(sp.c_out, device=device) % sp.lane_period < sp.lane_valid).float()
    return m


def _stack_reference(x: torch.Tensor, kernels, biases, specs) -> list[torch.Tensor]:
    ys = []
    h = x
    for kern, bias, sp in zip(kernels, biases, specs):
        z = F.conv1d(F.pad(h.float().transpose(1, 2), (sp.pad_l, sp.pad_r)),
                     kern.float().permute(2, 1, 0), None if bias is None else bias.float(),
                     stride=sp.stride, groups=sp.groups)
        if sp.slope != 1.0:
            z = torch.where(z >= 0, z, z * sp.slope)
        z = z.transpose(1, 2)
        mask = lane_mask(sp, z.shape[1], z.device)
        if mask is not None:
            z = z * mask
        h = z.to(x.dtype)
        ys.append(h)
    return ys


def fused_conv_stack_reference(x, kernels: Sequence[torch.Tensor],
                               biases: Sequence[torch.Tensor | None],
                               specs: Sequence[LayerSpec], weight_grads: bool = True):
    """Plain PyTorch version of :func:`fused_conv_stack` (autograd backward)."""
    if not weight_grads:
        kernels = [_ZeroGrad.apply(k) for k in kernels]
        biases = [None if b is None else _ZeroGrad.apply(b) for b in biases]
    if isinstance(x, (list, tuple)):
        return [_stack_reference(xi, kernels, biases, specs) for xi in x]
    return _stack_reference(x, kernels, biases, specs)


def reference_dz(y: torch.Tensor, dy: torch.Tensor | None, up: torch.Tensor | None,
                 sp: LayerSpec) -> torch.Tensor:
    """A layer's fp32 pre-activation cotangent in the plain backward: the
    map's cotangent dy (rounded to y's dtype) plus the fp32 upstream, through
    the leaky ReLU at the post-activation y and the lane mask."""
    dz = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
    if dy is not None:
        dz = dz + dy.to(y.dtype).float()
    if up is not None:
        dz = dz + up
    if sp.slope != 1.0:
        dz = torch.where(y.float() >= 0, dz, dz * sp.slope)
    mask = lane_mask(sp, y.shape[1], y.device)
    return dz if mask is None else dz * mask


def reference_dw(x_in: torch.Tensor, dz: torch.Tensor, kern: torch.Tensor,
                 sp: LayerSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's (dW, db) in the plain backward from its input and the fp32
    dz of :func:`reference_dz`: dz rounded to the input's dtype for the
    product, dW rounded to it, db the fp32 sum."""
    dtype = x_in.dtype
    dzr = dz.to(dtype).float().transpose(1, 2)
    xp = F.pad(x_in.float().transpose(1, 2), (sp.pad_l, sp.pad_r))
    k, ci_g, c_out = kern.shape
    dw = torch.nn.grad.conv1d_weight(xp, (c_out, ci_g, k), dzr, stride=sp.stride,
                                     groups=sp.groups)
    return dw.permute(2, 1, 0).to(dtype), dz.sum(dim=(0, 1))


def fused_conv_stack_backward_reference(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                                        ys: Sequence[torch.Tensor],
                                        dys: Sequence[torch.Tensor | None],
                                        specs: Sequence[LayerSpec], need_x: bool = True,
                                        weight_grads: bool = True):
    """Plain version of the CUDA backward over given post-activations ``ys``.

    Returns (dx or None, [dW_l], [db_l]) with the kernels' rounding points:
    dz in fp32 from ``ys``, db = sum dz, dz rounded to x's dtype for the
    products, dW rounded to x's dtype, the upstream kept in fp32. A check
    of the backward kernels hands both the same ``ys`` (the kernels'
    forward): two forwards that differ by rounding can put a pre-activation
    that lies within rounding of zero on either side, and the leaky-ReLU
    mask then differs there.
    """
    dtype = x.dtype
    n = len(specs)
    dks: list = [None] * n
    dbs: list = [None] * n
    up = None
    for l in range(n - 1, -1, -1):
        sp, y, kern = specs[l], ys[l], kernels[l]
        if dys[l] is None and up is None:
            continue
        dz = reference_dz(y, dys[l], up, sp)
        dzr = dz.to(dtype).float().transpose(1, 2)
        x_in = x if l == 0 else ys[l - 1]
        n_b, t_in, c_in = x_in.shape
        w = kern.to(dtype).float().permute(2, 1, 0)
        if weight_grads:
            dks[l], dbs[l] = reference_dw(x_in, dz, kern, sp)
        up = None
        if l or need_x:
            da = torch.nn.grad.conv1d_input((n_b, c_in, t_in + sp.pad_l + sp.pad_r), w, dzr,
                                            stride=sp.stride, groups=sp.groups)
            up = da[:, :, sp.pad_l:sp.pad_l + t_in].transpose(1, 2)
    dx = None
    if need_x:
        dx = up.to(dtype) if up is not None else torch.zeros_like(x)
    return dx, dks, dbs


# ---------------------------------------------------------------------------
# The host planner of the conv core (csrc/conv_core.cuh), shared with
# ops/msd_conv.py. Every size mirrors win_plan / dw_plan in the source; the
# entry points refuse a shared-memory value other than their own.
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)
SM_COUNT = 132  # the H100 SXM's; the wrappers pass the card's own
DW_ROWS = 64  # dW: reduction rows (n, t) a ring stage (kDwRows in the source)
DW_WAVES = 3  # dW blocks aimed at, in waves of SM_COUNT: its narrow layers have few tiles
STAGES = 3
THREADS = 256


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """One conv1d call: (n, t_in, c_in) -> (n, t_out, c_out), k taps,
    stride s, dilation d (s or d is 1), groups, left zero padding."""

    n: int
    t_in: int
    c_in: int
    t_out: int
    c_out: int
    k: int
    s: int = 1
    d: int = 1
    groups: int = 1
    pad_l: int = 0

    @property
    def ci_g(self) -> int:
        return self.c_in // self.groups

    @property
    def co_g(self) -> int:
        return self.c_out // self.groups


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def _pad816(v: int) -> int:
    """v (a multiple of 8) padded to 8 mod 16 elements."""
    return v + 8 if v % 16 == 0 else v + 16


def _pow2ceil(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _extra_rows(k: int, s: int, d: int) -> int:
    return _cdiv(max((k - 1) * d + 1 - s, 0), s) * s


def precision(dtype: torch.dtype) -> dict:
    """The core's per-dtype constants: mma k-step, weight-ring rows per
    stage, widest channel chunk, element size."""
    if dtype == torch.float32:
        return {"kstep": 8, "wk": 32, "kcmax": 64, "esize": 4}
    return {"kstep": 16, "wk": 64, "kcmax": 128, "esize": 2}


def kc_ok(g: ConvShape, dx: bool, dtype: torch.dtype, kc: int) -> bool:
    """A reduction channel chunk the forward or dx takes (``kc_ok`` in the
    source): a multiple of 8 up to the widest chunk, and with several chunks
    each spans two ring stages or more, for every dx phase too."""
    pr_ = precision(dtype)
    ch = g.co_g if dx else g.ci_g
    taps = (g.k if g.s == 1 else 1) if dx else g.k
    return (kc >= 8 and kc % 8 == 0 and kc <= pr_["kcmax"] and kc <= _round8(ch)
            and (_cdiv(ch, kc) == 1 or taps * kc > pr_["wk"]))


def win_plan(g: ConvShape, dx: bool, dtype: torch.dtype, bm: int, bn: int,
             kc: int | None = None) -> dict:
    """The forward (or dx) tile's window and shared memory (``win_plan`` in
    the source) with reduction channel chunks of ``kc`` (default: the
    widest); dx sizes for its widest phase."""
    pr_ = precision(dtype)
    if not dx:
        S, ch, ntaps, E, rows = g.s, g.ci_g, g.k, _extra_rows(g.k, g.s, g.d), g.t_out
    else:
        ntaps = _cdiv(g.k, g.s)
        S, ch, E, rows = 1, g.co_g, (ntaps - 1) * g.d, max(1, g.t_in // g.s)
    kc = kc or min(_round8(ch), pr_["kcmax"])
    chunks = _cdiv(ch, kc)
    nb = min(g.n - 1, _cdiv(bm - 1, rows))
    wr = (bm - 1) * S + nb * E + (ntaps - 1) * g.d + 1
    npl = 1 if S == 1 else min(S, ntaps)
    pr = _cdiv(wr, S)
    p = kc + 4 if dtype == torch.float32 else _pad816(kc)
    win = _round8(npl * pr * p)
    wb = 1 if chunks == 1 else 2
    groups8 = ntaps * kc // 8
    smem = _round8(groups8 + 1) * 4 + (wb * win + STAGES * pr_["wk"] * _pad816(bn)) * pr_["esize"]
    return {"S": S, "E": E, "ntaps": ntaps, "rows": rows, "ch": ch, "kc": kc, "chunks": chunks,
            "nb": nb, "wr": wr, "npl": npl, "pr": pr, "p": p, "win": win, "wb": wb,
            "groups8": groups8, "smem": smem}


def dw_kc(g: ConvShape) -> int:
    """dW's channels of a tap in a tile row group: a quarter of the group's
    width rounded up to a power of two, 8 to 64. A tile's 128 rows then
    take more taps of fewer channels, and the window a stage stages serves
    more of them (measured fastest at V1 MSD layers 1-5; even at layer 6)."""
    return max(8, min(_pow2ceil(_round8(g.ci_g)), 256) // 4)


def dw_plan(g: ConvShape, dtype: torch.dtype, bn: int, kc: int) -> dict:
    """The dW tile's (128 (tap, kc channels) rows x bn columns) stages and
    shared memory (``dw_plan`` in the source)."""
    pr_ = precision(dtype)
    nt = 128 // kc
    ntt, chunks = _cdiv(g.k, nt), _cdiv(g.ci_g, kc)
    S, E, bkt = g.s, _extra_rows(g.k, g.s, g.d), DW_ROWS
    nb = min(g.n - 1, _cdiv(bkt - 1, g.t_out))
    taps = min(nt, g.k)
    wr = (bkt - 1) * S + nb * E + (taps - 1) * g.d + 1
    npl = 1 if S == 1 else min(S, taps)
    pr = _cdiv(wr, S)
    p = _pad816(kc)
    win = _round8(npl * pr * p)
    stage = win + bkt * _pad816(bn)
    smem = STAGES * stage * pr_["esize"] + STAGES * bkt * 4
    return {"kc": kc, "nt": nt, "ntt": ntt, "chunks": chunks, "mtiles": chunks * ntt, "S": S,
            "E": E, "bkt": bkt, "nb": nb, "wr": wr, "npl": npl, "pr": pr, "p": p, "win": win,
            "stage": stage, "smem": smem}


def narrow(g: ConvShape, dtype: torch.dtype, pass_: str) -> bool:
    """Whether a pass takes the core's SIMT path: one input or one output
    channel per group, or a reduction shorter than one mma k-step."""
    if g.ci_g == 1 or g.co_g == 1:
        return True
    kstep = precision(dtype)["kstep"]
    if pass_ == "fwd":
        return g.k * g.ci_g < kstep
    if pass_ == "dx":
        return _cdiv(g.k, g.s) * g.co_g < kstep
    return g.n * g.t_out < kstep


def _bn(cols: int) -> int:
    return 16 if cols <= 16 else 32 if cols <= 32 else 64


@functools.lru_cache(maxsize=4096)
def plan_conv(g: ConvShape, dtype: torch.dtype, pass_: str, sm_count: int = SM_COUNT) -> dict:
    """How one pass ('fwd', 'dx' or 'dw') of one conv runs on the card.

    Returns ``body`` ('mma': the tensor-core core, or 'simt': the narrow
    edge), ``bm`` x ``bn`` (the tile; dW's rows are (tap, channel)),
    ``kc`` (channels of a reduction chunk; dW: of a tap in a tile row
    group), ``lanes`` (threads an output of the SIMT body), ``grid``,
    ``smem`` (bytes), ``splits`` / ``split_rows`` (dW's reduction over
    n*t_out), ``rb_rows`` / ``nrb`` (the dz pass's row blocks, db's
    partials) and ``scratch`` (elements of the device buffers the wrapper
    allocates).
    """
    if pass_ not in ("fwd", "dx", "dw"):
        raise ValueError(f"pass must be fwd, dx or dw, got {pass_!r}")
    rows = g.n * g.t_out
    rb_rows = max(64, _cdiv(rows, 1024))
    nrb = _cdiv(rows, rb_rows)
    plan = {"body": "simt", "bm": 0, "bn": 0, "kc": 0, "smem": 0, "lanes": 1, "splits": 0,
            "split_rows": 0, "rb_rows": rb_rows, "nrb": nrb,
            "scratch": {"dz": rows * g.c_out, "pdb": nrb * g.c_out, "partial": 0}}
    if narrow(g, dtype, pass_):
        red = {"fwd": g.k * g.ci_g, "dx": g.k * g.co_g, "dw": rows}[pass_]
        outs = {"fwd": rows * g.c_out, "dx": g.n * g.t_in * g.c_in,
                "dw": g.k * g.ci_g * g.c_out}[pass_]
        plan["lanes"] = 32 if red >= 64 else 1
        plan["grid"] = (_cdiv(outs * plan["lanes"], THREADS), 1, 1)
        return plan
    plan["body"] = "mma"
    if pass_ == "dw":
        bn, kc = _bn(g.co_g), dw_kc(g)
        dp = dw_plan(g, dtype, bn, kc)
        while dp["smem"] > SMEM_LIMIT and kc > 8:  # long dilated windows: fewer channels a tile
            kc //= 2
            dp = dw_plan(g, dtype, bn, kc)
        tiles = dp["mtiles"] * _cdiv(g.co_g, bn) * g.groups
        # splits of n * t_out up to ~DW_WAVES waves of blocks (each split >= 4 stages)
        splits = max(1, min(DW_WAVES * sm_count // tiles, rows // (4 * dp["bkt"])))
        split_rows = _cdiv(_cdiv(rows, splits), dp["bkt"]) * dp["bkt"]
        splits = _cdiv(rows, split_rows)
        plan.update(bm=128, bn=bn, kc=kc, smem=dp["smem"], splits=splits, split_rows=split_rows,
                    grid=(dp["mtiles"], _cdiv(g.co_g, bn), g.groups * splits))
        plan["scratch"]["partial"] = splits * g.k * g.ci_g * g.c_out
        smem, z = dp["smem"], g.groups * splits
    else:
        dx = pass_ == "dx"
        bn = _bn(g.ci_g if dx else g.co_g)
        m_rows = g.n * _cdiv(g.t_in, g.s) if dx else rows
        cols = g.ci_g if dx else g.co_g
        z = g.groups * g.s if dx else g.groups
        # 128-row tiles, the widest column tile and channel chunk (measured
        # fastest at every V1 MSD layer and scale); tall (dilated or strided)
        # windows past the card's shared memory take narrower chunks, then 64 rows
        bm = 128
        wp = win_plan(g, dx, dtype, bm, bn)
        kc = wp["kc"]
        while wp["smem"] > SMEM_LIMIT and kc > 8 and kc_ok(g, dx, dtype, _round8(kc // 2)):
            kc = _round8(kc // 2)
            wp = win_plan(g, dx, dtype, bm, bn, kc)
        if wp["smem"] > SMEM_LIMIT and bn >= 32:
            bm = 64
            wp = win_plan(g, dx, dtype, bm, bn, kc)
        smem = wp["smem"]
        plan.update(bm=bm, bn=bn, kc=kc, smem=smem,
                    grid=(_cdiv(m_rows, bm), _cdiv(cols, bn), z))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{pass_} of {g} needs {smem} bytes of shared memory, more than "
                         f"{SMEM_LIMIT}")
    if z > 65535:
        raise ValueError(f"{pass_} of {g}: grid z {z} is more than 65535")
    return plan


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_KERNELS = None  # the ctypes entries of csrc/conv_stack.cu, signatures set once


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        lib = _build.load("conv_stack")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        geom = [ci] * 9 + [cf, ci, ci]
        fwd, dx, dw = lib.hifigan_conv_fwd, lib.hifigan_conv_dx, lib.hifigan_conv_dw
        fwd.argtypes = [ci] + [vp] * 4 + geom + [ci] * 6 + [vp]
        dx.argtypes = [ci] + [vp] * 6 + [ci, vp] + geom + [ci] * 7 + [vp]
        dw.argtypes = [ci] + [vp] * 6 + [ci] + [vp] * 3 + geom + [ci] * 7 + [vp]
        for fn in (fwd, dx, dw):
            fn.restype = ci
        _KERNELS = (fwd, dx, dw)
    return _KERNELS


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def launch_args(plan: dict) -> list:
    """The body, tile, channel chunk, shared memory and lanes the forward
    and dx entry points take."""
    return [1 if plan["body"] == "mma" else 0, plan["bm"], plan["bn"], plan["kc"], plan["smem"],
            plan["lanes"]]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _shape(x_in: torch.Tensor, t_out: int, sp: LayerSpec) -> ConvShape:
    n, t_in, c_in = x_in.shape
    return ConvShape(n, t_in, c_in, t_out, sp.c_out, sp.kernel, sp.stride, 1, sp.groups, sp.pad_l)


def _geom(g: ConvShape, sp: LayerSpec) -> list:
    return [g.n, g.t_in, g.c_in, g.t_out, g.c_out, g.k, g.s, g.groups, g.pad_l, float(sp.slope),
            sp.lane_period, sp.lane_valid]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_conv_stack {what} kernel launch failed: cudaError {rc}")


def _layer_fwd(x_in, kern, bias, sp: LayerSpec, t_out: int) -> torch.Tensor:
    global LAUNCHES_FWD
    fwd, _, _ = _kernels()
    g = _shape(x_in, t_out, sp)
    plan = plan_conv(g, x_in.dtype, "fwd", sm_count(x_in.device))
    y = torch.empty((g.n, t_out, sp.c_out), dtype=x_in.dtype, device=x_in.device)
    rc = fwd(_DTYPE_CODE[x_in.dtype], x_in.data_ptr(), kern.data_ptr(), _ptr(bias), y.data_ptr(),
             *_geom(g, sp), *launch_args(plan), _stream(x_in))
    _raise_if(rc, "forward")
    LAUNCHES_FWD += 1
    _count("fwd", g.c_in, sp)
    return y


def _layer_dx(x_in, y, dy, up, kern, sp: LayerSpec, dz=None) -> torch.Tensor:
    """The layer's fp32 input cotangent; ``dz`` is the rounded cotangent the
    dW entry formed, else the entry forms it from dy, up and y."""
    global LAUNCHES_BWD_DX
    _, dx, _ = _kernels()
    g = _shape(x_in, y.shape[1], sp)
    plan = plan_conv(g, y.dtype, "dx", sm_count(y.device))
    wt = kern.permute(0, 2, 1).contiguous() if plan["body"] == "mma" else None
    ready = dz is not None
    if not ready:
        dz = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    da = torch.empty(x_in.shape, dtype=torch.float32, device=x_in.device)
    rc = dx(_DTYPE_CODE[y.dtype], _ptr(dy), _ptr(up), y.data_ptr(), kern.data_ptr(), _ptr(wt),
            dz.data_ptr(), int(ready), da.data_ptr(), *_geom(g, sp), *launch_args(plan),
            plan["rb_rows"], _stream(y))
    _raise_if(rc, "dx")
    LAUNCHES_BWD_DX += 1
    _count("bwd_dx", g.c_in, sp)
    return da


def _layer_dw(x_in, y, dy, up, kern, sp: LayerSpec):
    """(dW, db, dz): dz (the rounded cotangent, working type) goes on to the
    layer's dx."""
    global LAUNCHES_BWD_DW
    _, _, dw = _kernels()
    g = _shape(x_in, y.shape[1], sp)
    plan = plan_conv(g, y.dtype, "dw", sm_count(y.device))
    dev = y.device
    dz = torch.empty(y.shape, dtype=y.dtype, device=dev)
    pdb = torch.empty((plan["nrb"], g.c_out), dtype=torch.float32, device=dev)
    partial = (torch.empty((plan["scratch"]["partial"],), dtype=torch.float32, device=dev)
               if plan["body"] == "mma" else None)
    dkern = torch.empty_like(kern)
    dbias = torch.empty((g.c_out,), dtype=torch.float32, device=dev)
    body, _, bn, kc, smem, lanes = launch_args(plan)
    rc = dw(_DTYPE_CODE[y.dtype], x_in.data_ptr(), _ptr(dy), _ptr(up), y.data_ptr(),
            dz.data_ptr(), pdb.data_ptr(), plan["rb_rows"], _ptr(partial), dkern.data_ptr(),
            dbias.data_ptr(), *_geom(g, sp), body, bn, kc, plan["splits"], plan["split_rows"],
            smem, lanes, _stream(y))
    _raise_if(rc, "dW")
    LAUNCHES_BWD_DW += 1
    _count("bwd_dw", g.c_in, sp)
    return dkern, dbias, dz


class _FusedConvStack(torch.autograd.Function):
    """The CUDA stack over one input; weights come prepared by the wrapper."""

    @staticmethod
    def forward(ctx, specs, weight_grads, x, *wb):
        n = len(specs)
        kernels, biases = wb[:n], wb[n:]
        _build.probe("conv_stack", "fwd", _stack_reference, x, kernels, biases, specs)
        ys = []
        h, t = x, x.shape[1]
        for kern, bias, sp in zip(kernels, biases, specs):
            t = out_len(t, sp)
            h = _layer_fwd(h, kern, bias, sp, t)
            ys.append(h)
        ctx.specs, ctx.weight_grads = specs, weight_grads
        ctx.save_for_backward(x, *kernels, *ys)
        ctx.set_materialize_grads(False)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        specs = ctx.specs
        n = len(specs)
        x, *rest = ctx.saved_tensors
        kernels, ys = rest[:n], rest[n:]
        need_x = ctx.needs_input_grad[2]
        need_wb = ctx.needs_input_grad[3:]
        need_w = ctx.weight_grads and any(need_wb)
        _build.probe("conv_stack", ("bwd_dx", "bwd_dw"), fused_conv_stack_backward_reference,
                     x, kernels, ys, dys, specs, need_x, need_w)
        dkerns: list = [None] * n
        dbiases: list = [None] * n
        up = None
        for l in range(n - 1, -1, -1):
            dy = dys[l]
            if dy is not None:
                dy = dy.to(x.dtype).contiguous()
            if dy is None and up is None:
                continue
            x_in = x if l == 0 else ys[l - 1]
            dz = None
            if need_w:
                dkerns[l], dbiases[l], dz = _layer_dw(x_in, ys[l], dy, up, kernels[l], specs[l])
            up = (_layer_dx(x_in, ys[l], dy, up, kernels[l], specs[l], dz) if (l or need_x)
                  else None)
        grads = []
        for i, (need, g) in enumerate(zip(need_wb, dkerns + dbiases)):
            if need and g is None:  # weight_grads=False, or no gradient reached the layer
                g = (torch.zeros_like(kernels[i]) if i < n else
                     torch.zeros((specs[i - n].c_out,), dtype=torch.float32, device=x.device))
            grads.append(g if need else None)
        dx = None
        if need_x:
            dx = up.to(x.dtype) if up is not None else torch.zeros_like(x)
        return (None, None, dx, *grads)


def _check(xs: Sequence[torch.Tensor], kernels, biases, specs) -> None:
    x0 = xs[0]
    if x0.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x0.dtype}")
    for x in xs:
        if x.dim() != 3 or x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError(f"inputs must share one (N, T, C) shape, dtype and device, "
                             f"got {tuple(x.shape)} {x.dtype} {x.device}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
    if not (len(kernels) == len(biases) == len(specs)) or not specs:
        raise ValueError("kernels, biases and specs must be non-empty and of one length")
    c_in, t = x0.shape[2], x0.shape[1]
    for l, (kern, bias, sp) in enumerate(zip(kernels, biases, specs)):
        if c_in % sp.groups or sp.c_out % sp.groups:
            raise ValueError(f"layer {l}: channels {c_in}->{sp.c_out} do not divide "
                             f"groups {sp.groups}")
        want = (sp.kernel, c_in // sp.groups, sp.c_out)
        if tuple(kern.shape) != want:
            raise ValueError(f"layer {l}: kernel must be {want}, got {tuple(kern.shape)}")
        if kern.device != x0.device or (bias is not None and bias.device != x0.device):
            raise ValueError(f"layer {l}: weights must be on x's device")
        if bias is not None and tuple(bias.shape) != (sp.c_out,):
            raise ValueError(f"layer {l}: bias must be ({sp.c_out},), got {tuple(bias.shape)}")
        if (sp.stride < 1 or sp.pad_l < 0 or sp.pad_r < 0 or sp.lane_period < 0
                or not 0 <= sp.lane_valid <= max(sp.lane_period, 0)):
            raise ValueError(f"layer {l}: bad spec {sp}")
        t = out_len(t, sp)
        if t < 1:
            raise ValueError(f"layer {l}: the input is shorter than the kernel")
        c_in = sp.c_out


def fused_conv_stack(x, kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor | None],
                     specs: Sequence[LayerSpec], weight_grads: bool = True, *, mesh=None,
                     batch_axis: str = "data"):
    """x (N, T, C0) -> every layer's post-activation (N, T_l, C_l) in x's dtype.

    ``x`` may be a sequence of same-shape inputs (the GAN's real and fake
    traversals): the weights are then prepared once and one list of outputs
    is returned per input. A CPU tensor takes
    :func:`fused_conv_stack_reference`; a CUDA tensor launches the kernels
    (or raises). Differentiable in x, kernels and biases.

    ``mesh``: the batch-sharded form (a :class:`~hifigan_tpu_torch.parallel.
    mesh.Mesh` whose ``batch_axis`` has n > 1 ranks). Inside a
    data-parallel step (``parallel.mesh.data_parallel_rows``) x already
    holds this rank's rows and the unchanged kernels run on them. Elsewhere
    x is the logical batch on every rank: N must divide by n (else the JAX
    message), the kernels run on this rank's block of N / n rows, and the
    outputs are gathered back to N rows. Either way the kernel and bias
    gradients are this rank's rows' share: they are summed over the axis
    once, by the trainer's gradient reduction
    (``parallel.mesh.reduce_gradients``), never here.
    """
    multi = isinstance(x, (list, tuple))
    xs = list(x) if multi else [x]
    if data_axis(mesh, batch_axis) > 1 and not rows_are_local():
        local = [split_rows(xi, mesh, batch_axis, "fused_conv_stack") for xi in xs]
        outs = fused_conv_stack(local if multi else local[0], kernels, biases, specs,
                                weight_grads)
        gathered = [[gather_rows(y, mesh, batch_axis) for y in ys]
                    for ys in (outs if multi else [outs])]
        return gathered if multi else gathered[0]
    if xs[0].device.type == "cpu":
        return fused_conv_stack_reference(x, kernels, biases, specs, weight_grads=weight_grads)
    if xs[0].device.type != "cuda":
        raise ValueError(f"fused_conv_stack runs on cpu or cuda, got {xs[0].device}")
    specs = tuple(specs)
    _check(xs, kernels, biases, specs)
    dtype = xs[0].dtype
    ks = [k.to(dtype).contiguous() for k in kernels]
    bs = [torch.zeros((sp.c_out,), dtype=torch.float32, device=xs[0].device) if b is None
          else b.float().contiguous() for b, sp in zip(biases, specs)]
    with torch.cuda.device(xs[0].device):
        outs = [list(_FusedConvStack.apply(specs, bool(weight_grads), xi, *ks, *bs)) for xi in xs]
    return outs if multi else outs[0]


# ---------------------------------------------------------------------------
# The group time-fold ("zone") form of a grouped chain
# (hifigan_tpu/ops/pallas/conv_stack.py:1117-1220, the same layouts)
# ---------------------------------------------------------------------------
#
# For a chain of grouped convs that maps group j of its input to group j of
# its output, fold time into each group's lanes so that every group holds
# f * ci lanes:
#
#   X[r, (gg*f + phi)*ci + i] = x[r*f + phi, gg*ci + i]
#   Y[rho, (gg*f_out + psi)*co + o] = y[rho*f_out + psi, gg*co + o]
#
# Per group Y[rho] = sum_q X[sigma*rho + q] @ Wz[gg][q], sigma = f_out*s/f_in,
# with the banded kernel Wz[gg][q][phi*ci + i, psi*co + o] =
# W[q*f_in + phi - psi*s + pad][i, gg*co + o] (taps outside [0, K) are zero):
# an ordinary grouped layer of g groups over f_in*ci -> f_out*co lanes. A
# chain's layer l + 1 reads layer l's output layout when f_in[l+1] = f_out[l].


@functools.lru_cache(maxsize=64)
def _zone_taps(K: int, s: int, pad: int, f_in: int, f_out: int, d: int,
               device: torch.device) -> tuple:
    """(sigma, q_min, kk, the tap index of each (q, phi, psi) on ``device``,
    K for the zero tap) of one banded table, computed once per geometry."""
    if (f_out * s) % f_in:
        raise ValueError(f"f_out * stride ({f_out} * {s}) must divide by f_in ({f_in})")
    sigma = (f_out * s) // f_in
    d_min, d_max = -pad, (f_out - 1) * s + (K - 1) * d - pad
    q_min, q_max = d_min // f_in, d_max // f_in
    q_i, phi_i, psi_i = np.meshgrid(np.arange(q_min, q_max + 1), np.arange(f_in),
                                    np.arange(f_out), indexing="ij")
    kd_i = q_i * f_in + phi_i - psi_i * s + pad  # tap k times dilation
    valid = (kd_i >= 0) & (kd_i < (K - 1) * d + 1) & (kd_i % d == 0)
    taps = torch.from_numpy(np.where(valid, kd_i // d, K).reshape(-1).astype(np.int64))
    return sigma, q_min, q_max - q_min + 1, taps.to(device)


def zone_grouped_layer(kernel: torch.Tensor, bias: torch.Tensor | None, s: int, pad: int,
                       f_in: int, f_out: int, groups: int, slope: float, t_in: int,
                       dilation: int = 1):
    """Fold one grouped conv layer into the zone form.

    kernel: (K, ci, g*co) (the JAX layout; ci = a group's input channels).
    Returns (zkernel (kk, f_in*ci, g*f_out*co), zbias (g*f_out*co,) or None,
    spec) for :func:`fused_conv_stack` on the zone-layout activation of a
    ``t_in``-sample input: the table is one gather over the kernel and a
    zero tap, so gradients reach the kernel and bias through autograd; the
    spec's padding, stride, ``kk`` taps and lane mask are the JAX values.
    """
    K, ci, gco = kernel.shape
    g, d = groups, dilation
    co = gco // g
    sigma, q_min, kk, taps = _zone_taps(K, s, pad, f_in, f_out, d, kernel.device)
    rows_in = _cdiv(t_in, f_in)
    t_out = (t_in + 2 * pad - (K - 1) * d - 1) // s + 1
    rows_out = _cdiv(t_out, f_out)
    rem_out = t_out % f_out
    pad_l = -q_min
    need = (rows_out - 1) * sigma + kk - pad_l - rows_in
    pad_r = max(0, need)
    if need + sigma - 1 < 0 or pad_r > kk + sigma:
        raise ValueError(f"zone geometry out of range: pad_l {pad_l}, need {need}, kk {kk}")
    wp = torch.cat([kernel, kernel.new_zeros((1, ci, gco))])
    zk = (wp[taps].reshape(kk, f_in, f_out, ci, g, co).permute(0, 1, 3, 4, 2, 5)
          .reshape(kk, f_in * ci, g * f_out * co))
    zb = None if bias is None else bias.reshape(g, 1, co).expand(g, f_out, co).reshape(-1)
    spec = LayerSpec(g * f_out * co, kk, sigma, g, pad_l, pad_r, slope,
                     lane_period=f_out * co if rem_out else 0,
                     lane_valid=rem_out * co if rem_out else 0)
    return zk, zb, spec


def fold_group_zones(x: torch.Tensor, g: int, f: int) -> torch.Tensor:
    """(B, T, g*ci) group-major channels -> (B, ceil(T/f), g*f*ci) zone
    layout, contiguous; a T that does not divide by f zero-pads the last
    row's trailing phases (they read as conv padding inside the chain)."""
    b, t, c = x.shape
    ci = c // g
    rows = _cdiv(t, f)
    if t % f:
        x = F.pad(x, (0, 0, 0, rows * f - t))
    return x.reshape(b, rows, f, g, ci).permute(0, 1, 3, 2, 4).reshape(b, rows, g * f * ci)


def unfold_group_zones(z: torch.Tensor, g: int, f: int, t_out: int | None = None) -> torch.Tensor:
    """The inverse for the output layout: (B, R, g*f*co) -> (B, t_out, g*co)
    (t_out defaults to R*f; the true length drops the fold padding)."""
    b, r, lanes = z.shape
    co = lanes // (g * f)
    y = z.reshape(b, r, g, f, co).permute(0, 1, 3, 2, 4).reshape(b, r * f, g * co)
    return y if t_out is None or t_out == r * f else y[:, :t_out, :]
