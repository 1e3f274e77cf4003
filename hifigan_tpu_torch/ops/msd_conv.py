"""One conv1d + bias + leaky-ReLU, forward and input gradient in CUDA, and
its plain version.

Replaces ``hifigan_tpu/ops/pallas/msd_conv.py::msd_conv1d_lrelu`` (:191;
the tap-loop kernel ``_tapconv_pallas`` :77, call :96, which its backward
reuses for dx :165). Over x (B, T, C_in) channels-last and a kernel
(K, C_in/groups, C_out) in the JAX layout it computes::

    y = lrelu(conv1d(x, W, stride, dilation, groups, zero pad (pad_l, pad_r)) + b)

with torch integer-padding semantics, T_out = (T + pad_l + pad_r -
((K-1)*dilation + 1)) // stride + 1, stride or dilation (never both) above
1, ``slope=1.0`` meaning no activation. The kernel and bias are cast to x's
dtype (float32 or bfloat16); the products accumulate in fp32, the bias is
added in fp32, the activation applied in fp32 and the result rounded to x's
dtype.

The backward follows the JAX custom VJP (``msd_conv.py:136-167``): dz = dy
* where(y >= 0, 1, slope) formed in dy's dtype from the SAVED output y;
db = sum dz in fp32, rounded to the dtype; dW as fp32 products summed over
(batch, time), rounded to the dtype; dx by the CUDA kernel
(``csrc/msd_conv.cu``, on the implicit-GEMM core ``csrc/conv_core.cuh``
that the conv stack shares, planned by ``ops/conv_stack.py::plan_conv``)
in fp32 over dz formed once by a first kernel of the same entry, rounded
to x's dtype. dW and db are PyTorch
ops here (the weight-gradient conv and a sum) as they are XLA einsums
outside the Pallas call in JAX. An input that needs no gradient (the
waveform under conv_0) skips its dx launch.

- :func:`msd_conv1d_lrelu_reference` is the plain PyTorch version
  (``F.conv1d`` + bias + leaky ReLU, autograd backward);
  :func:`msd_conv1d_lrelu_backward_reference` is the plain backward over a
  given saved output, what the dx kernel is held against (two forwards that
  differ by rounding can flip a leaky-ReLU mask).
- :func:`msd_conv1d_lrelu` takes the plain version for a CPU tensor; for a
  CUDA tensor it launches the kernels or raises.
- ``LAUNCHES_FWD`` and ``LAUNCHES_BWD_DX`` count the launches of the two
  kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from hifigan_tpu_torch.ops.conv_stack import ConvShape, launch_args, plan_conv, sm_count

LAUNCHES_FWD = 0
LAUNCHES_BWD_DX = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class ConvGeom:
    """What a call fixes besides its tensors."""

    stride: int
    dilation: int
    groups: int
    pad_l: int
    pad_r: int
    slope: float


def reset_launches() -> None:
    global LAUNCHES_FWD, LAUNCHES_BWD_DX
    LAUNCHES_FWD = LAUNCHES_BWD_DX = 0


def launches() -> dict[str, int]:
    return {"fwd": LAUNCHES_FWD, "bwd_dx": LAUNCHES_BWD_DX}


def _geom(stride, padding, dilation, groups, slope) -> ConvGeom:
    pad_l, pad_r = (padding, padding) if isinstance(padding, int) else tuple(padding)
    return ConvGeom(int(stride), int(dilation), int(groups), int(pad_l), int(pad_r), float(slope))


def out_len(t: int, k: int, g: ConvGeom) -> int:
    return (t + g.pad_l + g.pad_r - ((k - 1) * g.dilation + 1)) // g.stride + 1


def _rounded_slope(slope: float, dtype: torch.dtype) -> float:
    """The slope in the working dtype, as the JAX backward casts its mask."""
    return float(torch.tensor(slope, dtype=torch.float32).to(dtype))


def _masked_cotangent(dy: torch.Tensor, y: torch.Tensor, slope: float) -> torch.Tensor:
    """dz = dy * where(y >= 0, 1, slope) in dy's dtype."""
    if slope == 1.0:
        return dy
    return torch.where(y >= 0, dy, dy * _rounded_slope(slope, dy.dtype))


def msd_conv1d_lrelu_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
                               *, stride: int = 1, padding: int | tuple[int, int] = 0,
                               dilation: int = 1, groups: int = 1,
                               slope: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`msd_conv1d_lrelu` (autograd backward)."""
    g = _geom(stride, padding, dilation, groups, slope)
    dtype = x.dtype
    z = F.conv1d(F.pad(x.float().transpose(1, 2), (g.pad_l, g.pad_r)),
                 kernel.to(dtype).float().permute(2, 1, 0), None, stride=g.stride,
                 dilation=g.dilation, groups=g.groups)
    if bias is not None:
        z = z + bias.to(dtype).float()[:, None]
    if g.slope != 1.0:
        z = torch.where(z >= 0, z, z * g.slope)
    return z.transpose(1, 2).to(dtype)


def _weight_grad(x: torch.Tensor, dz: torch.Tensor, k: int, g: ConvGeom) -> torch.Tensor:
    """dW (K, C_in/groups, C_out): the products of the zero-padded input and
    dz summed over (batch, time) in fp32 (PyTorch's weight-gradient conv,
    cuDNN on the card, in place of the JAX package's per-tap einsums),
    rounded to x's dtype."""
    xp = F.pad(x.float().transpose(1, 2), (g.pad_l, g.pad_r))
    dw = torch.nn.grad.conv1d_weight(xp, (dz.shape[2], x.shape[2] // g.groups, k),
                                     dz.float().transpose(1, 2), stride=g.stride,
                                     dilation=g.dilation, groups=g.groups)
    return dw.permute(2, 1, 0).to(x.dtype)


def msd_conv1d_lrelu_backward_reference(x: torch.Tensor, kernel: torch.Tensor, y: torch.Tensor,
                                        dy: torch.Tensor, *, stride: int = 1,
                                        padding: int | tuple[int, int] = 0, dilation: int = 1,
                                        groups: int = 1, slope: float = 1.0,
                                        weight_grads: bool = True):
    """Plain version of the backward over a given saved output ``y``:
    (dx, dkernel, dbias) with the rounding points of the JAX backward
    (dkernel and dbias None under ``weight_grads=False``)."""
    g = _geom(stride, padding, dilation, groups, slope)
    dtype = x.dtype
    dz = _masked_cotangent(dy.to(dtype), y, g.slope)
    n, t_in, c_in = x.shape
    w = kernel.to(dtype).float().permute(2, 1, 0)
    da = torch.nn.grad.conv1d_input((n, c_in, t_in + g.pad_l + g.pad_r), w,
                                    dz.float().transpose(1, 2), stride=g.stride,
                                    dilation=g.dilation, groups=g.groups)
    dx = da[:, :, g.pad_l:g.pad_l + t_in].transpose(1, 2).to(dtype)
    if not weight_grads:
        return dx, None, None
    return dx, _weight_grad(x, dz, kernel.shape[0], g), dz.float().sum(dim=(0, 1)).to(dtype)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_KERNELS = None  # the ctypes entries of csrc/msd_conv.cu, signatures set once


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        from hifigan_tpu_torch.ops import _build

        lib = _build.load("msd_conv")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd, dx = lib.hifigan_msd_fwd, lib.hifigan_msd_dx
        fwd.argtypes = [ci] + [vp] * 4 + [ci] * 10 + [cf] + [ci] * 6 + [vp]
        dx.argtypes = [ci] + [vp] * 6 + [ci] * 10 + [cf] + [ci] * 6 + [vp]
        for fn in (fwd, dx):
            fn.restype = ci
        _KERNELS = (fwd, dx)
    return _KERNELS


def conv_shape(x_shape, y_shape, k: int, g: ConvGeom) -> ConvShape:
    """The planner's view of one call: (n, t_in, c_in) -> (n, t_out, c_out)."""
    n, t_in, c_in = x_shape
    return ConvShape(n, t_in, c_in, y_shape[1], y_shape[2], k, g.stride, g.dilation, g.groups,
                     g.pad_l)


def _args(s: ConvShape, slope: float, plan: dict, x: torch.Tensor) -> list:
    return [s.n, s.t_in, s.c_in, s.t_out, s.c_out, s.k, s.s, s.d, s.groups, s.pad_l, slope,
            *launch_args(plan), torch.cuda.current_stream(x.device).cuda_stream]


def _launch_fwd(g: ConvGeom, x: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor | None) -> torch.Tensor:
    global LAUNCHES_FWD
    fwd, _ = _kernels()
    k, _, c_out = kernel.shape
    y = torch.empty((x.shape[0], out_len(x.shape[1], k, g), c_out), dtype=x.dtype,
                    device=x.device)
    s = conv_shape(x.shape, y.shape, k, g)
    plan = plan_conv(s, x.dtype, "fwd", sm_count(x.device))
    b32 = None if bias is None else bias.float().contiguous()
    rc = fwd(_DTYPE_CODE[x.dtype], x.data_ptr(), kernel.data_ptr(),
             None if b32 is None else b32.data_ptr(), y.data_ptr(), *_args(s, g.slope, plan, x))
    if rc != 0:
        raise RuntimeError(f"msd_conv1d_lrelu forward kernel launch failed: cudaError {rc}")
    LAUNCHES_FWD += 1
    return y


def _launch_dx(g: ConvGeom, dy: torch.Tensor, y: torch.Tensor, kernel: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES_BWD_DX
    _, dx_fn = _kernels()
    s = conv_shape(x.shape, y.shape, kernel.shape[0], g)
    plan = plan_conv(s, x.dtype, "dx", sm_count(x.device))
    wt = kernel.permute(0, 2, 1).contiguous() if plan["body"] == "mma" else None
    dz = torch.empty_like(dy)
    dx = torch.empty_like(x)
    rc = dx_fn(_DTYPE_CODE[x.dtype], dy.data_ptr(), y.data_ptr(), kernel.data_ptr(),
               None if wt is None else wt.data_ptr(), dz.data_ptr(), dx.data_ptr(),
               *_args(s, _rounded_slope(g.slope, x.dtype), plan, x))
    if rc != 0:
        raise RuntimeError(f"msd_conv1d_lrelu dx kernel launch failed: cudaError {rc}")
    LAUNCHES_BWD_DX += 1
    return dx


class _MsdConv(torch.autograd.Function):
    """The CUDA conv over prepared operands: x contiguous, kernel and bias in x's dtype."""

    @staticmethod
    def forward(ctx, g: ConvGeom, x, kernel, bias):
        y = _launch_fwd(g, x, kernel, bias)
        ctx.g = g
        ctx.save_for_backward(x, kernel, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel, y = ctx.saved_tensors
        g = ctx.g
        dy = dy.to(x.dtype).contiguous()
        dx = _launch_dx(g, dy, y, kernel, x) if ctx.needs_input_grad[1] else None
        dk = db = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dz = _masked_cotangent(dy, y, g.slope)
            if ctx.needs_input_grad[2]:
                dk = _weight_grad(x, dz, kernel.shape[0], g)
            if ctx.needs_input_grad[3]:
                db = dz.float().sum(dim=(0, 1)).to(x.dtype)
        return None, dx, dk, db


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None, g: ConvGeom) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or kernel.dim() != 3:
        raise ValueError(f"x must be (B, T, C) and the kernel (K, C_in/groups, C_out), got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    k, ci_g, c_out = kernel.shape
    c_in = x.shape[2]
    if g.groups < 1 or c_in % g.groups or c_out % g.groups or ci_g != c_in // g.groups:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit {c_in} input channels "
                         f"in {g.groups} groups")
    if kernel.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("the kernel and bias must be on x's device")
    if bias is not None and tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias must be ({c_out},), got {tuple(bias.shape)}")
    if g.stride < 1 or g.dilation < 1 or g.pad_l < 0 or g.pad_r < 0:
        raise ValueError(f"bad geometry {g}")
    if g.stride > 1 and g.dilation > 1:
        raise ValueError("stride and dilation are exclusive")
    if out_len(x.shape[1], k, g) < 1:
        raise ValueError("the input is shorter than the kernel")


def msd_conv1d_lrelu(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None, *,
                     stride: int = 1, padding: int | tuple[int, int] = 0, dilation: int = 1,
                     groups: int = 1, slope: float = 1.0) -> torch.Tensor:
    """x (B, T, C_in) -> (B, T_out, C_out) in x's dtype; kernel (K, C_in/groups,
    C_out), bias (C_out,) or None. A CPU tensor takes
    :func:`msd_conv1d_lrelu_reference`; a CUDA tensor launches the kernels
    (or raises). Differentiable in x, kernel and bias."""
    if x.device.type == "cpu":
        return msd_conv1d_lrelu_reference(x, kernel, bias, stride=stride, padding=padding,
                                          dilation=dilation, groups=groups, slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"msd_conv1d_lrelu runs on cpu or cuda, got {x.device}")
    g = _geom(stride, padding, dilation, groups, slope)
    _check(x, kernel, bias, g)
    dtype = x.dtype
    with torch.cuda.device(x.device):
        return _MsdConv.apply(g, x.contiguous(), kernel.to(dtype).contiguous(),
                              None if bias is None else bias.to(dtype))
