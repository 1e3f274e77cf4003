"""Normed convolution modules (PyTorch port of ``hifigan_tpu/models/layers.py``).

Weights are held in torch's own layouts, so a module's state_dict keys and
shapes are the reference checkpoint's: Conv1d (O, I/groups, K), Conv2d
(O, I/groups, KH, KW), ConvTranspose1d (I, O, K).

- ``norm='weight'`` keeps ``weight_g``/``weight_v`` as the module's own
  parameters (w = g * v / ||v||, norm over every dim but 0, torch
  ``weight_norm(dim=0)``);
- ``norm='spectral'`` keeps the parameter ``weight_orig`` and the buffers
  ``weight_u`` (the power-iteration vector, (O,)) and ``weight_v``, the
  names torch's ``spectral_norm`` gives them. With ``update_spectral`` a call
  runs one power iteration, ``v = l2n(Wᵀu)``, ``u' = l2n(W v)``, with
  ``l2n(x) = x / (||x|| + 1e-12)``, stores u' and v, and divides W by
  ``σ = u'·W v``; gradients flow through W only. Written out by hand:
  torch's ``spectral_norm`` normalises with ``max(||x||, eps)``;
- ``norm='none'`` keeps a plain ``weight``.

Init is torch's: kaiming-uniform ``v`` (bound 1/sqrt(fan_in)), ``g = ||v||``,
uniform bias, a normal ``u``; ``norm='none'`` with ``init_std`` draws the
weight from N(0, init_std) (the DSL's ``init_weights``, which only reaches
un-normed convs); draws come from the caller's ``torch.Generator``. ``NormConv1d.forward`` takes torch's (N, C, W) layout;
``NormConv1d.kernel_nwc`` gives the kernel in the JAX layout,
``NormConv1d.fused_nwc`` runs conv + bias + leaky ReLU in one ``msd_conv1d_lrelu`` call and
``NormConv2d.nhwc`` runs on channels-last (N, H, W, C). Every conv casts
its input, kernel and bias to the input's dtype (or to ``dtype`` where
given), as the JAX modules' ``_cast`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from hifigan_tpu_torch.ops import msd_conv
from hifigan_tpu_torch.ops.conv import conv2d


def _uniform(shape, bound: float, generator: torch.Generator | None) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class _NormConvBase(nn.Module):
    def _init_params(self, shape: tuple[int, ...], n_bias: int, fan_in: int, norm: str,
                     generator: torch.Generator | None, init_std: float | None = None) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        v = _uniform(shape, bound, generator)
        if norm == "none" and init_std is not None:
            v = torch.randn(shape, generator=generator) * init_std
        if norm == "weight":
            dims = tuple(range(1, v.dim()))
            self.weight_g = nn.Parameter(torch.sqrt((v * v).sum(dim=dims, keepdim=True)))
            self.weight_v = nn.Parameter(v)
        elif norm == "spectral":
            self.weight_orig = nn.Parameter(v)
            u = _l2n(torch.randn((shape[0],), generator=generator))
            self.register_buffer("weight_u", u)
            self.register_buffer("weight_v", _l2n(v.reshape(shape[0], -1).t() @ u))
        elif norm == "none":
            self.weight = nn.Parameter(v)
        else:
            raise ValueError(f"unknown norm: {norm}")
        self.bias = nn.Parameter(_uniform((n_bias,), bound, generator))
        self.norm = norm

    def effective_weight(self, update_spectral: bool = False) -> torch.Tensor:
        """The conv weight after its norm, in torch layout."""
        if self.norm == "none":
            return self.weight
        if self.norm == "weight":
            v = self.weight_v
            dims = tuple(range(1, v.dim()))
            return v * (self.weight_g / torch.sqrt((v * v).sum(dim=dims, keepdim=True)))
        w = self.weight_orig
        w_mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = _l2n(w_mat.t() @ self.weight_u)
            u = _l2n(w_mat @ v)
            if update_spectral:
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return w / torch.dot(u, w_mat @ v)


class NormConv1d(_NormConvBase):
    """Conv1d with torch integer padding semantics."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1,
                 norm: str = "weight", generator: torch.Generator | None = None,
                 init_std: float | None = None) -> None:
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self._init_params((out_channels, in_channels // groups, kernel_size), out_channels,
                          (in_channels // groups) * kernel_size, norm, generator, init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, W) -> (N, O, W')."""
        return F.conv1d(x, self.effective_weight().to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride, padding=self.padding, dilation=self.dilation,
                        groups=self.groups)

    def fused_nwc(self, x: torch.Tensor, slope: float = 1.0, update_spectral: bool = False,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
        """(N, W, C) -> (N, W', O) in ``dtype`` (default: x's): the conv, its
        bias and a leaky ReLU at ``slope`` (1.0: none) in one
        :func:`~hifigan_tpu_torch.ops.msd_conv.msd_conv1d_lrelu` call on the
        effective kernel and bias (the JAX module's
        ``fused_impl='pallas_msd'``). The norm stays outside the op, so its
        chain differentiates through PyTorch."""
        dtype = dtype or x.dtype
        kern, bias = self.kernel_nwc(update_spectral, dtype)
        return msd_conv.msd_conv1d_lrelu(x.to(dtype), kern, bias, stride=self.stride,
                                         padding=self.padding, dilation=self.dilation,
                                         groups=self.groups, slope=slope)

    def kernel_nwc(self, update_spectral: bool = False,
                   dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
        """(kernel (K, I/groups, O), bias) in ``dtype``: the JAX layout. The
        effective weights, as the JAX module's ``weights_only`` returns them."""
        w = self.effective_weight(update_spectral).permute(2, 1, 0)
        return w.to(dtype), self.bias.to(dtype)


class NormConv2d(_NormConvBase):
    """Conv2d with torch integer padding semantics (port of the JAX NormConv2d)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
                 groups: int = 1, norm: str = "weight",
                 generator: torch.Generator | None = None, dilation: tuple[int, int] = (1, 1),
                 init_std: float | None = None) -> None:
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding, self.groups = tuple(stride), tuple(padding), groups
        self.dilation = tuple(dilation)
        self._init_params((out_channels, in_channels // groups, kh, kw), out_channels,
                          (in_channels // groups) * kh * kw, norm, generator, init_std)

    def nhwc(self, x: torch.Tensor, update_spectral: bool = False,
             dtype: torch.dtype | None = None) -> torch.Tensor:
        """(N, H, W, C) -> (N, H', W', O) in ``dtype`` (default: x's)."""
        dtype = dtype or x.dtype
        w = self.effective_weight(update_spectral).permute(2, 3, 1, 0).to(dtype)
        return conv2d(x.to(dtype), w, self.bias.to(dtype), stride=self.stride,
                      padding=self.padding, dilation=self.dilation, groups=self.groups)


class NormConvTranspose1d(_NormConvBase):
    """ConvTranspose1d over (N, C, W); weight (I, O, K), fan_in O * K as torch computes it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, norm: str = "weight",
                 generator: torch.Generator | None = None, output_padding: int = 0,
                 init_std: float | None = None) -> None:
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self._init_params((in_channels, out_channels, kernel_size), out_channels,
                          out_channels * kernel_size, norm, generator, init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.effective_weight().to(x.dtype), self.bias.to(x.dtype),
                                  stride=self.stride, padding=self.padding,
                                  output_padding=self.output_padding)

    def nwc(self, x: torch.Tensor, update_spectral: bool = False) -> torch.Tensor:
        """(N, W, I) -> (N, W', O) in x's dtype."""
        y = F.conv_transpose1d(x.transpose(1, 2), self.effective_weight(update_spectral).to(x.dtype),
                               self.bias.to(x.dtype), stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding)
        return y.transpose(1, 2)


def fold_weight_norm(state_dict: dict) -> dict:
    """Fold ``weight_g``/``weight_v`` pairs into plain ``weight`` entries.

    The functional form of the reference's ``remove_weight_norm``: load the
    result into modules built with ``norm='none'`` (``Generator(h,
    folded=True)``). In torch layouts the norm runs over every dim but 0 for
    forward and transposed convs alike.
    """
    out: dict = {}
    for key, val in state_dict.items():
        if key.endswith(".weight_v"):
            continue
        if key.endswith(".weight_g"):
            prefix = key[: -len(".weight_g")]
            v = state_dict[prefix + ".weight_v"]
            out[prefix + ".weight"] = v * (val / torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True)))
        else:
            out[key] = val
    return out
