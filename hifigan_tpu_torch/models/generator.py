"""HiFi-GAN generator family V1/V2/V3 (PyTorch port of ``hifigan_tpu/models/generator.py``).

- ResBlock1: three (dilated conv, unit conv) pairs with 0.1-leaky
  pre-activations and additive residuals.
- ResBlock2: dilated convs with residuals.
- Generator: conv_pre k7 -> per stage [lrelu -> ConvTranspose1d upsample ->
  mean of num_kernels ResBlocks] -> lrelu(0.01) -> conv_post k7 -> tanh.

The boundary is (B, num_mels, T) -> (B, 1, T * hop) float32. Parameter names
are the reference state_dict's (``conv_pre.weight_g``, ``ups.0.weight_v``,
``resblocks.N.convs1.M.bias``), so a reference ``g_*`` generator loads with
``load_state_dict`` directly; ``folded=True`` takes plain ``weight`` entries
(:func:`hifigan_tpu_torch.models.layers.fold_weight_norm`). ``dtype`` is the
compute dtype (the JAX ``Generator.dtype``): the mel is cast to it and every
conv casts its kernel and bias to it; the waveform comes out float32.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn as nn

from hifigan_tpu_torch.models.layers import NormConv1d, NormConvTranspose1d
from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, leaky_relu, torch_same_padding


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5),
                 norm: str = "weight", generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.convs1 = nn.ModuleList(
            NormConv1d(channels, channels, kernel_size, padding=torch_same_padding(kernel_size, d),
                       dilation=d, norm=norm, generator=generator)
            for d in dilation
        )
        self.convs2 = nn.ModuleList(
            NormConv1d(channels, channels, kernel_size, padding=torch_same_padding(kernel_size, 1),
                       norm=norm, generator=generator)
            for _ in dilation
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(leaky_relu(c1(leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3),
                 norm: str = "weight", generator: torch.Generator | None = None) -> None:
        super().__init__()
        self.convs = nn.ModuleList(
            NormConv1d(channels, channels, kernel_size, padding=torch_same_padding(kernel_size, d),
                       dilation=d, norm=norm, generator=generator)
            for d in dilation
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(leaky_relu(x, LRELU_SLOPE)) + x
        return x


class Generator(nn.Module):
    """mel (B, num_mels, T) -> waveform (B, 1, T * prod(upsample_rates))."""

    def __init__(self, h: Any, folded: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        norm = "none" if folded else "weight"
        self.num_kernels = len(h["resblock_kernel_sizes"])
        ch0 = h["upsample_initial_channel"]
        resblock_cls = ResBlock1 if str(h["resblock"]) == "1" else ResBlock2
        self.conv_pre = NormConv1d(h["num_mels"], ch0, 7, padding=3, norm=norm,
                                   generator=generator)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
            ch = ch0 // (2 ** (i + 1))
            self.ups.append(NormConvTranspose1d(2 * ch, ch, k, stride=u, padding=(k - u) // 2,
                                                norm=norm, generator=generator))
            for rk, rd in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
                self.resblocks.append(resblock_cls(ch, rk, tuple(rd), norm=norm,
                                                   generator=generator))
        self.conv_post = NormConv1d(ch0 // (2 ** len(self.ups)), 1, 7, padding=3, norm=norm,
                                    generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x.to(self.dtype or self.conv_pre.bias.dtype))
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j in range(nk):
                out = self.resblocks[i * nk + j](x)
                xs = out if xs is None else xs + out
            x = xs / nk
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x).float()
