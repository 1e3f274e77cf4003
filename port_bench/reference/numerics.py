"""The precision the reference computes its convs in.

``FP32`` is the reference: fp32 inputs and weights, fp32 accumulation, with
both TF32 switches off (:func:`no_tf32`). ``BF16`` rounds every conv's input,
weight and output to bf16 (products summed in fp32): the rounding that a
pipeline stored in the configuration's bf16 serving precision implies, the
yardstick of a served waveform's error.
The two lower precisions are the controls that a correctness limit has to
reject, one step below what a configuration states:

- ``TF32`` (below fp32): every conv's input and weight rounded to TF32's
  10-bit mantissa (round to nearest even), products summed in fp32, and in
  the backward the incoming gradient rounded too, so that dx and dW are
  products of TF32 values as well: what the tensor cores compute with the
  TF32 switches on, emulated so that the CPU computes it too;
- ``FP8`` (below bf16): every conv's input, weight and output scaled per
  tensor to the e4m3 range (amax to 448), rounded to float8_e4m3fn and
  scaled back, products summed in fp32: a pipeline stored in fp8 with
  per-tensor scales.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties to even."""
    if x.dtype != torch.float32:
        raise TypeError(f"round_tf32 takes float32, got {x.dtype}")
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest bf16 value, back to fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> e4m3 with one scale per tensor (amax mapped to 448), back to fp32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _RoundForward(torch.autograd.Function):
    """q(x) forward; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, q):
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundBackward(torch.autograd.Function):
    """x forward; the gradient rounded by q on its way back."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g.contiguous()), None


@dataclasses.dataclass(frozen=True)
class Numerics:
    """How a conv computes: ``q`` rounds its input and weight (and, with
    ``storage``, its output: a format that tensors are stored in, where
    TF32 is only the tensor cores' input format and sums come out in fp32);
    under autograd the incoming gradient is rounded by ``q`` too."""

    name: str
    q: Callable[[torch.Tensor], torch.Tensor]
    storage: bool = False

    def _conv(self, op, x, w, b, kw) -> torch.Tensor:
        if self.q is _identity:
            return op(x, w, b, **kw)
        y = op(_RoundForward.apply(x, self.q), _RoundForward.apply(w, self.q), b, **kw)
        if self.storage:
            y = _RoundForward.apply(y, self.q)
        return _RoundBackward.apply(y, self.q) if y.requires_grad else y

    def conv1d(self, x, w, b=None, **kw) -> torch.Tensor:
        return self._conv(F.conv1d, x, w, b, kw)

    def conv2d(self, x, w, b=None, **kw) -> torch.Tensor:
        return self._conv(F.conv2d, x, w, b, kw)

    def conv_transpose1d(self, x, w, b=None, **kw) -> torch.Tensor:
        return self._conv(F.conv_transpose1d, x, w, b, kw)


FP32 = Numerics("float32", _identity)
TF32 = Numerics("tf32", round_tf32)
BF16 = Numerics("bfloat16", round_bf16, storage=True)
FP8 = Numerics("fp8_e4m3", round_fp8, storage=True)
BY_NAME = {n.name: n for n in (FP32, TF32, BF16, FP8)}


@contextlib.contextmanager
def no_tf32():
    """Both TF32 switches off while the reference runs, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
