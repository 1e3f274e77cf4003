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

The CUDA path (``csrc/conv_stack.cu``) runs one launch per layer and pass,
and its backward follows the Pallas one:

- dz = (dy_l + upstream) * where(y_l >= 0, 1, slope) in fp32, from the saved
  post-activation; db = sum dz in fp32; dz rounded to the working dtype
  feeds dW (rounded to the weight dtype) and dx; the upstream between
  layers stays fp32;
- a layer whose output gets no gradient and has nothing from above adds
  nothing; an input that needs no gradient skips layer 0's dx;
- ``weight_grads=False`` launches no dW/db work and returns zero weight and
  bias gradients.

What bounds it and what the design does about it is in the source note of
``csrc/conv_stack.cu``. The TPU kernel's zone layout, lane folding, group
densification and backward chunking are VMEM devices and are not carried
over (``zone_grouped_layer`` waits for the stream-graph kernel, which needs
it).

- :func:`fused_conv_stack_reference` is the plain PyTorch version: per-layer
  ``F.conv1d`` + bias + lrelu in fp32 with autograd.
- :func:`fused_conv_stack` takes the plain version for a CPU tensor; for a
  CUDA tensor it launches the kernels or raises.
- ``LAUNCHES_FWD``, ``LAUNCHES_BWD_DX`` and ``LAUNCHES_BWD_DW`` count the
  launches of the three entry points (the dW entry runs a partial-sum
  kernel and its reduction, counted once).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

LAUNCHES_FWD = 0
LAUNCHES_BWD_DX = 0
LAUNCHES_BWD_DW = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# dW partial sums: aim at this many blocks per launch before splitting N*T
_DW_TARGET_BLOCKS = 264
_DW_MIN_ROWS = 256


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


def out_len(t: int, spec: LayerSpec) -> int:
    return (t + spec.pad_l + spec.pad_r - spec.kernel) // spec.stride + 1


def reset_launches() -> None:
    global LAUNCHES_FWD, LAUNCHES_BWD_DX, LAUNCHES_BWD_DW
    LAUNCHES_FWD = LAUNCHES_BWD_DX = LAUNCHES_BWD_DW = 0


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


def _stack_reference(x: torch.Tensor, kernels, biases, specs) -> list[torch.Tensor]:
    ys = []
    h = x
    for kern, bias, sp in zip(kernels, biases, specs):
        z = F.conv1d(F.pad(h.float().transpose(1, 2), (sp.pad_l, sp.pad_r)),
                     kern.float().permute(2, 1, 0), None if bias is None else bias.float(),
                     stride=sp.stride, groups=sp.groups)
        if sp.slope != 1.0:
            z = torch.where(z >= 0, z, z * sp.slope)
        h = z.transpose(1, 2).to(x.dtype)
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
        dz = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
        if dys[l] is not None:
            dz = dz + dys[l].to(dtype).float()
        if up is not None:
            dz = dz + up
        if sp.slope != 1.0:
            dz = torch.where(y.float() >= 0, dz, dz * sp.slope)
        dzr = dz.to(dtype).float().transpose(1, 2)
        x_in = x if l == 0 else ys[l - 1]
        n_b, t_in, c_in = x_in.shape
        w = kern.to(dtype).float().permute(2, 1, 0)
        if weight_grads:
            xp = F.pad(x_in.float().transpose(1, 2), (sp.pad_l, sp.pad_r))
            dw = torch.nn.grad.conv1d_weight(xp, tuple(w.shape), dzr, stride=sp.stride,
                                             groups=sp.groups)
            dks[l] = dw.permute(2, 1, 0).to(dtype)
            dbs[l] = dz.sum(dim=(0, 1))
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
# CUDA path
# ---------------------------------------------------------------------------

_KERNELS = None  # the ctypes entries of csrc/conv_stack.cu, signatures set once


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        from hifigan_tpu_torch.ops import _build

        lib = _build.load("conv_stack")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        geom = [ci] * 9 + [cf]
        fwd, dx, dw = lib.hifigan_conv_fwd, lib.hifigan_conv_dx, lib.hifigan_conv_dw
        fwd.argtypes = [ci] + [vp] * 4 + geom + [vp]
        dx.argtypes = [ci] + [vp] * 5 + geom + [vp]
        dw.argtypes = [ci] + [vp] * 8 + geom + [ci, ci, vp]
        for fn in (fwd, dx, dw):
            fn.restype = ci
        _KERNELS = (fwd, dx, dw)
    return _KERNELS


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _geom(x_in: torch.Tensor, y: torch.Tensor, sp: LayerSpec) -> list:
    n, t_in, c_in = x_in.shape
    return [n, t_in, c_in, y.shape[1], sp.c_out, sp.kernel, sp.stride, sp.groups, sp.pad_l,
            float(sp.slope)]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_if(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_conv_stack {what} kernel launch failed: cudaError {rc}")


def _dw_splits(kdim: int, co_g: int, groups: int, rows: int) -> tuple[int, int]:
    """(splits, rows per split) of the dW reduction over N*T_out."""
    bn = 64 if co_g >= 64 else (32 if co_g >= 32 else 16)
    tiles = -(-kdim // (4096 // bn)) * -(-co_g // bn) * groups
    splits = max(1, min(-(-_DW_TARGET_BLOCKS // tiles), rows // _DW_MIN_ROWS))
    split_rows = -(-rows // (16 * splits)) * 16
    return -(-rows // split_rows), split_rows


def _layer_fwd(x_in, kern, bias, sp: LayerSpec, t_out: int) -> torch.Tensor:
    global LAUNCHES_FWD
    fwd, _, _ = _kernels()
    y = torch.empty((x_in.shape[0], t_out, sp.c_out), dtype=x_in.dtype, device=x_in.device)
    rc = fwd(_DTYPE_CODE[x_in.dtype], x_in.data_ptr(), kern.data_ptr(), _ptr(bias), y.data_ptr(),
             *_geom(x_in, y, sp), _stream(x_in))
    _raise_if(rc, "forward")
    LAUNCHES_FWD += 1
    return y


def _layer_dx(x_in, y, dy, up, kern, sp: LayerSpec) -> torch.Tensor:
    global LAUNCHES_BWD_DX
    _, dx, _ = _kernels()
    da = torch.empty(x_in.shape, dtype=torch.float32, device=x_in.device)
    rc = dx(_DTYPE_CODE[y.dtype], _ptr(dy), _ptr(up), y.data_ptr(), kern.data_ptr(),
            da.data_ptr(), *_geom(x_in, y, sp), _stream(y))
    _raise_if(rc, "dx")
    LAUNCHES_BWD_DX += 1
    return da


def _layer_dw(x_in, y, dy, up, kern, sp: LayerSpec) -> tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES_BWD_DW
    _, _, dw = _kernels()
    k, ci_g, c_out = kern.shape
    rows = y.shape[0] * y.shape[1]
    splits, split_rows = _dw_splits(k * ci_g, c_out // sp.groups, sp.groups, rows)
    partial = torch.empty((splits, k * ci_g, c_out), dtype=torch.float32, device=y.device)
    pdb = torch.empty((splits, c_out), dtype=torch.float32, device=y.device)
    dkern = torch.empty_like(kern)
    dbias = torch.empty((c_out,), dtype=torch.float32, device=y.device)
    rc = dw(_DTYPE_CODE[y.dtype], x_in.data_ptr(), _ptr(dy), _ptr(up), y.data_ptr(),
            partial.data_ptr(), pdb.data_ptr(), dkern.data_ptr(), dbias.data_ptr(),
            *_geom(x_in, y, sp), splits, split_rows, _stream(y))
    _raise_if(rc, "dW")
    LAUNCHES_BWD_DW += 1
    return dkern, dbias


class _FusedConvStack(torch.autograd.Function):
    """The CUDA stack over one input; weights come prepared by the wrapper."""

    @staticmethod
    def forward(ctx, specs, weight_grads, x, *wb):
        n = len(specs)
        kernels, biases = wb[:n], wb[n:]
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
            if need_w:
                dkerns[l], dbiases[l] = _layer_dw(x_in, ys[l], dy, up, kernels[l], specs[l])
            up = _layer_dx(x_in, ys[l], dy, up, kernels[l], specs[l]) if (l or need_x) else None
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
        if sp.stride < 1 or sp.pad_l < 0 or sp.pad_r < 0:
            raise ValueError(f"layer {l}: bad spec {sp}")
        t = out_len(t, sp)
        if t < 1:
            raise ValueError(f"layer {l}: the input is shorter than the kernel")
        c_in = sp.c_out


def fused_conv_stack(x, kernels: Sequence[torch.Tensor], biases: Sequence[torch.Tensor | None],
                     specs: Sequence[LayerSpec], weight_grads: bool = True):
    """x (N, T, C0) -> every layer's post-activation (N, T_l, C_l) in x's dtype.

    ``x`` may be a sequence of same-shape inputs (the GAN's real and fake
    traversals): the weights are then prepared once and one list of outputs
    is returned per input. A CPU tensor takes
    :func:`fused_conv_stack_reference`; a CUDA tensor launches the kernels
    (or raises). Differentiable in x, kernels and biases.
    """
    multi = isinstance(x, (list, tuple))
    xs = list(x) if multi else [x]
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
