"""Normed 1-D convolution modules (PyTorch port of ``hifigan_tpu/models/layers.py``).

Weights are held in torch's own layouts, so a module's state_dict keys and
shapes are the reference checkpoint's: Conv1d (O, I, K), ConvTranspose1d
(I, O, K). ``norm='weight'`` keeps ``weight_g``/``weight_v`` as the module's
own parameters (w = g * v / ||v||, norm over every dim but 0, torch
``weight_norm(dim=0)``); ``norm='none'`` keeps a plain ``weight``.

Init is torch's: kaiming-uniform ``v`` (bound 1/sqrt(fan_in)), ``g = ||v||``,
uniform bias; draws come from the caller's ``torch.Generator``. Activations
are (N, C, W), torch's layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _uniform(shape, bound: float, generator: torch.Generator | None) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class _NormConvBase(nn.Module):
    def _init_params(self, shape: tuple[int, ...], n_bias: int, fan_in: int, norm: str,
                     generator: torch.Generator | None) -> None:
        bound = 1.0 / math.sqrt(fan_in)
        v = _uniform(shape, bound, generator)
        if norm == "weight":
            self.weight_g = nn.Parameter(torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True)))
            self.weight_v = nn.Parameter(v)
        elif norm == "none":
            self.weight = nn.Parameter(v)
        else:
            raise ValueError(f"unknown norm: {norm}")
        self.bias = nn.Parameter(_uniform((n_bias,), bound, generator))
        self.norm = norm

    def effective_weight(self) -> torch.Tensor:
        if self.norm == "none":
            return self.weight
        v = self.weight_v
        return v * (self.weight_g / torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True)))


class NormConv1d(_NormConvBase):
    """Conv1d over (N, C, W) with torch integer padding semantics."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 norm: str = "weight", generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self._init_params((out_channels, in_channels, kernel_size), out_channels,
                          in_channels * kernel_size, norm, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.effective_weight(), self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation)


class NormConvTranspose1d(_NormConvBase):
    """ConvTranspose1d over (N, C, W); weight (I, O, K), fan_in O * K as torch computes it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, norm: str = "weight",
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_params((in_channels, out_channels, kernel_size), out_channels,
                          out_channels * kernel_size, norm, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.effective_weight(), self.bias,
                                  stride=self.stride, padding=self.padding)


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
