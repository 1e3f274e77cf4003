"""Convolution primitives with the JAX package's layouts.

Layouts (as in ``hifigan_tpu/ops/conv.py``):
- 1D activations: (N, W, C), channels last.
- 1D kernels: (K, I, O) for forward convs.
- transposed 1D kernels: (K, I, O) with I the transposed conv's *input*
  feature count (torch ConvTranspose1d stores (I, O, K)).
- 2D activations: (N, H, W, C); 2D kernels: (KH, KW, I, O) (HWIO).

Inside, the convs run as ``F.conv1d`` / ``F.conv_transpose1d`` on (N, C, W)
views; the public functions keep the channels-last layout so the port and
the JAX package compare like with like.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def torch_same_padding(kernel_size: int, dilation: int = 1) -> int:
    """(k*d - d) // 2: the 'same' padding of an odd-k dilated conv."""
    return (kernel_size * dilation - dilation) // 2


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """w = g * v / ||v||, norm over ``axes`` (all axes but the norm dim).

    Forward convs (K, I, O): axes=(0, 1); transposed convs (K, I, O):
    axes=(0, 2).
    """
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    return v * (g.reshape(norm.shape) / norm)


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """(N, W, C_in) @ (K, C_in/groups, C_out) -> (N, W', C_out)."""
    if not isinstance(padding, int):
        x = F.pad(x.transpose(1, 2), tuple(padding))
        padding = 0
    else:
        x = x.transpose(1, 2)
    y = F.conv1d(x, kernel.permute(2, 1, 0), bias, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
) -> torch.Tensor:
    """torch ConvTranspose1d over (N, W, I) with a (K, I, O) kernel -> (N, W', O).

    W' = (W - 1) * stride - 2 * padding + K + output_padding.
    """
    y = F.conv_transpose1d(x.transpose(1, 2), kernel.permute(1, 2, 0), bias, stride=stride,
                           padding=padding, output_padding=output_padding)
    return y.transpose(1, 2)


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
    dilation: tuple[int, int] = (1, 1),
    groups: int = 1,
) -> torch.Tensor:
    """(N, H, W, C_in) @ (KH, KW, C_in/groups, C_out) -> (N, H', W', C_out)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias, stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def avg_pool1d(x: torch.Tensor, kernel_size: int, stride: int, padding: int = 0) -> torch.Tensor:
    """torch.nn.AvgPool1d (count_include_pad=True) over (N, W, C): each
    window of the zero-padded input summed in fp32 order and divided by
    ``kernel_size``. Not F.avg_pool1d: on CUDA its backward returns wrong
    input gradients for an input whose memory is channels-last or, with one
    channel, ambiguous (a per-layer conv kernel's output, the MSD's
    waveform), which the autograd of a window view and a sum does not."""
    xp = F.pad(x, (0, 0, padding, padding))
    return xp.unfold(1, kernel_size, stride).sum(-1) / kernel_size


def reflect_pad_1d(x: torch.Tensor, pad: tuple[int, int], axis: int = 1) -> torch.Tensor:
    """Reflect padding along ``axis`` (torch F.pad mode='reflect')."""
    moved = x.movedim(axis, -1)
    shape = moved.shape
    y = F.pad(moved.reshape(-1, 1, shape[-1]), tuple(pad), mode="reflect")
    return y.reshape(*shape[:-1], y.shape[-1]).movedim(-1, axis)
