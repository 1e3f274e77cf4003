"""MPD and MSD, functional, upstream names (jik876/hifi-gan ``models.py``).

DiscriminatorP(period p): reflect-pad the waveform to a multiple of p,
view it as (B, 1, T / p, p), four Conv2d (5, 1) of stride (3, 1) and one of
stride 1 (padding (2, 0)), each followed by leaky ReLU 0.1, then conv_post
(3, 1); periods 2, 3, 5, 7, 11, weight norm.

DiscriminatorS: Conv1d 1 -> 128 (k15), then (k41, groups 4, stride 2),
(k41, g16, s2) to 256, (k41, g16, s4) to 512, (k41, g16, s4) to 1024,
(k41, g16, s1), (k5) at 1024, each followed by leaky ReLU 0.1, conv_post
(k3) -> 1. Three scales, AvgPool1d(4, 2, padding=2) between them; scale 0
under spectral norm, the others under weight norm.

Spectral norm as ``torch.nn.utils.spectral_norm`` in training mode: every
traversal of scale 0 runs one power iteration on the stored ``weight_u``
(v = l2n(Wᵀu), u = l2n(W v), without gradient), stores u and v, and divides
W by sigma = u · W v. Feature maps come out in torch layout.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from port_bench.reference.generator import ConvShape, lrelu, weight
from port_bench.reference.numerics import FP32, Numerics

PERIODS = (2, 3, 5, 7, 11)
MPD_CHANNELS = (32, 128, 512, 1024)


def msd_specs(width: int = 128) -> list[tuple[int, int, int, int, int, int]]:
    """DiscriminatorS's convs: (c_in, c_out, kernel, stride, groups, padding)."""
    w = width
    return [(1, w, 15, 1, 1, 7), (w, w, 41, 2, 4, 20), (w, 2 * w, 41, 2, 16, 20),
            (2 * w, 4 * w, 41, 4, 16, 20), (4 * w, 8 * w, 41, 4, 16, 20),
            (8 * w, 8 * w, 41, 1, 16, 20), (8 * w, 8 * w, 5, 1, 1, 2)]


def widths(h: Any) -> tuple[tuple[int, ...], tuple[int, ...], int, int]:
    """(periods, MPD channels, MSD width, MSD scales) of a configuration."""
    return (tuple(h.get("mpd_periods", PERIODS)), tuple(h.get("mpd_channels", MPD_CHANNELS)),
            h.get("msd_width", 128), h.get("msd_num_scales", 3))


def conv_shapes(h: Any) -> dict[str, ConvShape]:
    """Every discriminator conv by name, prefixed ``mpd.`` and ``msd.`` as
    the trainer's modules hold them."""
    periods, chans, width, scales = widths(h)
    out = {}
    for i, _ in enumerate(periods):
        c = [1, *chans, chans[-1]]
        for j in range(len(chans) + 1):
            out[f"mpd.discriminators.{i}.convs.{j}"] = ConvShape((c[j + 1], c[j], 5, 1),
                                                                 c[j] * 5, c[j + 1])
        out[f"mpd.discriminators.{i}.conv_post"] = ConvShape((1, c[-1], 3, 1), c[-1] * 3, 1)
    for s in range(scales):
        norm = "spectral" if s == 0 else "weight"
        for j, (ci, co, k, _, g, _) in enumerate(msd_specs(width)):
            out[f"msd.discriminators.{s}.convs.{j}"] = ConvShape((co, ci // g, k), ci // g * k,
                                                                 co, norm)
        out[f"msd.discriminators.{s}.conv_post"] = ConvShape((1, 8 * width, 3), 8 * width * 3,
                                                             1, norm)
    return out


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + 1e-12)


def spectral_weight(params: dict, buffers: dict, name: str) -> torch.Tensor:
    """One power iteration on ``buffers[name.weight_u]`` (stored), then W / sigma."""
    w = params[f"{name}.weight_orig"]
    w_mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = _l2n(w_mat.t() @ buffers[f"{name}.weight_u"])
        u = _l2n(w_mat @ v)
        buffers[f"{name}.weight_u"].copy_(u)
        buffers[f"{name}.weight_v"].copy_(v)
    return w / torch.dot(u, w_mat @ v)


def disc_p(params: dict, prefix: str, period: int, n_convs: int, x: torch.Tensor,
           num: Numerics) -> tuple[torch.Tensor, list]:
    b, t = x.shape
    if t % period:
        x = F.pad(x[:, None], (0, period - t % period), mode="reflect")[:, 0]
        t = x.shape[1]
    x = x.reshape(b, 1, t // period, period)
    fmap = []
    for j in range(n_convs + 1):
        name = f"{prefix}.convs.{j}"
        x = lrelu(num.conv2d(x, weight(params, name), params[f"{name}.bias"],
                             stride=(3 if j < n_convs else 1, 1), padding=(2, 0)))
        fmap.append(x)
    x = num.conv2d(x, weight(params, f"{prefix}.conv_post"), params[f"{prefix}.conv_post.bias"],
                   padding=(1, 0))
    fmap.append(x)
    return x.flatten(1), fmap


def mpd(h: Any, params: dict, y: torch.Tensor, y_hat: torch.Tensor, num: Numerics = FP32):
    periods, chans, _, _ = widths(h)
    outs = ([], [], [], [])
    for i, p in enumerate(periods):
        prefix = f"mpd.discriminators.{i}"
        r, fr = disc_p(params, prefix, p, len(chans), y, num)
        g, fg = disc_p(params, prefix, p, len(chans), y_hat, num)
        for lst, v in zip(outs, (r, g, fr, fg)):
            lst.append(v)
    return outs


def disc_s(params: dict, buffers: dict, prefix: str, width: int, spectral: bool,
           x: torch.Tensor, num: Numerics) -> tuple[torch.Tensor, list]:
    def w(name):
        return spectral_weight(params, buffers, name) if spectral else weight(params, name)

    x = x[:, None]
    fmap = []
    for j, (_, _, _, s, g, p) in enumerate(msd_specs(width)):
        name = f"{prefix}.convs.{j}"
        x = lrelu(num.conv1d(x, w(name), params[f"{name}.bias"], stride=s, groups=g,
                             padding=p))
        fmap.append(x)
    x = num.conv1d(x, w(f"{prefix}.conv_post"), params[f"{prefix}.conv_post.bias"], padding=1)
    fmap.append(x)
    return x.flatten(1), fmap


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool1d(x[:, None], 4, 2, padding=2)[:, 0]


def msd(h: Any, params: dict, buffers: dict, y: torch.Tensor, y_hat: torch.Tensor,
        num: Numerics = FP32):
    """Every scale traverses real, then generated; scale 0's power iteration
    advances once per traversal."""
    _, _, width, scales = widths(h)
    outs = ([], [], [], [])
    for s in range(scales):
        if s:
            y, y_hat = avg_pool(y), avg_pool(y_hat)
        prefix = f"msd.discriminators.{s}"
        r, fr = disc_s(params, buffers, prefix, width, s == 0, y, num)
        g, fg = disc_s(params, buffers, prefix, width, s == 0, y_hat, num)
        for lst, v in zip(outs, (r, g, fr, fg)):
            lst.append(v)
    return outs
