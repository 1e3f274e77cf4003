"""HiFi-GAN Generator, functional, upstream names (jik876/hifi-gan ``models.py``).

conv_pre (k7) -> per stage [leaky ReLU 0.1 -> ConvTranspose1d (stride u,
kernel k, padding (k - u) / 2) -> mean of the stage's ResBlocks] -> leaky
ReLU 0.01 -> conv_post (k7, C -> 1) -> tanh. ResBlock1: per dilation d,
x += c2(lrelu(c1(lrelu(x)))) with c1 dilated by d and c2 undilated;
ResBlock2: x += c(lrelu(x)). 'same' padding (k * d - d) / 2.

``params`` maps upstream keys to tensors: a folded ``<name>.weight`` or the
weight-norm pair ``<name>.weight_g`` / ``<name>.weight_v`` (w = g v / ||v||,
norm over every dim but 0, as ``torch.nn.utils.weight_norm(dim=0)``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from port_bench.reference.numerics import FP32, Numerics

LRELU_SLOPE = 0.1


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, slope)


def weight(params: dict, name: str) -> torch.Tensor:
    """The conv weight ``name`` in torch layout, weight norm folded."""
    folded = params.get(f"{name}.weight")
    if folded is not None:
        return folded
    v, g = params[f"{name}.weight_v"], params[f"{name}.weight_g"]
    dims = tuple(range(1, v.dim()))
    return v * (g / torch.sqrt((v * v).sum(dim=dims, keepdim=True)))


def same_padding(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def resblock_convs(h: Any, index: int) -> list[tuple[str, int, int]]:
    """ResBlock ``index``'s convs in execution order: (name, kernel, dilation)."""
    j = index % len(h["resblock_kernel_sizes"])
    k, dil = h["resblock_kernel_sizes"][j], h["resblock_dilation_sizes"][j]
    pre = f"resblocks.{index}"
    if str(h["resblock"]) == "1":
        return [c for i, d in enumerate(dil)
                for c in ((f"{pre}.convs1.{i}", k, d), (f"{pre}.convs2.{i}", k, 1))]
    return [(f"{pre}.convs.{i}", k, d) for i, d in enumerate(dil)]


def resblock(h: Any, params: dict, index: int, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    convs = resblock_convs(h, index)
    per = 2 if str(h["resblock"]) == "1" else 1
    for i in range(0, len(convs), per):
        xt = x
        for name, k, d in convs[i:i + per]:
            xt = num.conv1d(lrelu(xt), weight(params, name), params[f"{name}.bias"],
                            padding=same_padding(k, d), dilation=d)
        x = xt + x
    return x


def generator(h: Any, params: dict, mel: torch.Tensor, num: Numerics = FP32) -> torch.Tensor:
    """mel (B, num_mels, T) -> waveform (B, 1, T * prod(upsample_rates)), fp32."""
    nk = len(h["resblock_kernel_sizes"])
    x = num.conv1d(mel.float(), weight(params, "conv_pre"), params["conv_pre.bias"], padding=3)
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        x = num.conv_transpose1d(lrelu(x), weight(params, f"ups.{i}"), params[f"ups.{i}.bias"],
                                 stride=u, padding=(k - u) // 2)
        xs = None
        for j in range(nk):
            out = resblock(h, params, i * nk + j, x, num)
            xs = out if xs is None else xs + out
        x = xs / nk
    x = num.conv1d(lrelu(x, 0.01), weight(params, "conv_post"), params["conv_post.bias"],
                   padding=3)
    return torch.tanh(x)


class ConvShape(NamedTuple):
    """A conv's torch weight shape, its fan_in (torch's init bound is
    1 / sqrt(fan_in)), its bias length and its norm."""

    shape: tuple[int, ...]
    fan_in: int
    bias: int
    norm: str = "weight"


def conv_shapes(h: Any) -> dict[str, ConvShape]:
    """Every conv of the Generator by upstream name, in upstream order, all
    under weight norm (torch's ConvTranspose1d weight is (I, O, K), fan_in O * K)."""
    ch0, m = h["upsample_initial_channel"], h["num_mels"]
    out = {"conv_pre": ConvShape((ch0, m, 7), m * 7, ch0)}
    for i, (_, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        ch = ch0 // 2 ** (i + 1)
        out[f"ups.{i}"] = ConvShape((2 * ch, ch, k), ch * k, ch)
    nk = len(h["resblock_kernel_sizes"])
    for i in range(len(h["upsample_rates"])):
        ch = ch0 // 2 ** (i + 1)
        for j in range(nk):
            for name, k, _ in resblock_convs(h, i * nk + j):
                out[name] = ConvShape((ch, ch, k), ch * k, ch)
    c_last = ch0 // 2 ** len(h["upsample_rates"])
    out["conv_post"] = ConvShape((1, c_last, 7), c_last * 7, 1)
    return out


def receptive_field(h: Any) -> int:
    """One-sided receptive field of one output sample, in output samples:
    each layer's reach at its own rate (a transposed conv of stride u and
    kernel k reaches ceil(k / u) input steps), scaled to the output rate."""
    rates = list(h["upsample_rates"])
    total, scale = 3, 1  # conv_post at the output rate
    if str(h["resblock"]) == "1":
        mrf = max(sum((k - 1) // 2 * d + (k - 1) // 2 for d in ds)
                  for k, ds in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
    else:
        mrf = max(sum((k - 1) // 2 * d for d in ds)
                  for k, ds in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]))
    for u, k in zip(reversed(rates), reversed(h["upsample_kernel_sizes"])):
        total += mrf * scale
        scale *= u
        total += math.ceil(k / u) * scale
    return total + 3 * scale  # conv_pre at the mel rate
