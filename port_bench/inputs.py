"""Inputs made from the run's seed, on the device, in a few large calls.

Weights come in upstream key names, initialised as torch initialises each
layer (kaiming-uniform weight and uniform bias, bound 1 / sqrt(fan_in);
weight norm with g = ||v||; spectral norm with a normal ``weight_u``). All
of a model's draws come from two calls on one ``torch.Generator`` on the
device, then are cut into the tensors. The same tensors go to the program
and to the reference. Audio is seeded sine mixtures plus noise; mels are the
reference's log-mel of it.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from port_bench.reference.mel import log_mel


def generator_for(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """An independent generator on ``device`` for draw ``stream`` of a run."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63))
    return g


def conv_weights(shapes: dict, gen: torch.Generator, device: torch.device,
                 fold: bool = False) -> tuple[dict, dict]:
    """(parameters, buffers) for ``shapes`` ({name: ConvShape}): the g / v
    pair for a weight-normed conv (a folded ``weight`` with ``fold``),
    ``weight_orig`` and the ``weight_u`` / ``weight_v`` buffers for a
    spectral one."""
    n_uniform = sum(math.prod(c.shape) + c.bias for c in shapes.values())
    n_normal = sum(c.shape[0] for c in shapes.values() if c.norm == "spectral")
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(max(n_normal, 1), generator=gen, device=device)
    params, buffers = {}, {}
    at, at_normal = 0, 0
    for name, c in shapes.items():
        bound = 1.0 / math.sqrt(c.fan_in)
        n = math.prod(c.shape)
        v = uniform[at:at + n].view(c.shape) * bound
        params[f"{name}.bias"] = uniform[at + n:at + n + c.bias] * bound
        at += n + c.bias
        if c.norm == "spectral":
            params[f"{name}.weight_orig"] = v
            u = normal[at_normal:at_normal + c.shape[0]]
            at_normal += c.shape[0]
            u = u / (u.norm() + 1e-12)
            vv = v.reshape(c.shape[0], -1).t() @ u
            buffers[f"{name}.weight_u"] = u
            buffers[f"{name}.weight_v"] = vv / (vv.norm() + 1e-12)
        elif fold:
            params[f"{name}.weight"] = v
        else:
            params[f"{name}.weight_v"] = v
            params[f"{name}.weight_g"] = v.flatten(1).norm(dim=1).view(
                (c.shape[0],) + (1,) * (len(c.shape) - 1))
    return params, buffers


def synthetic_audio(n: int, length: int, sr: int, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """(n, length) fp32: four sines a row (amplitude 0.1-0.5, 80-4000 Hz,
    random phase) plus N(0, 0.02) noise, scaled to a peak of 0.95."""
    draws = torch.rand((3, n, 4, 1), generator=gen, device=device)
    amp, freq, phase = 0.1 + 0.4 * draws[0], 80.0 + 3920.0 * draws[1], 2 * math.pi * draws[2]
    t = torch.arange(length, device=device, dtype=torch.float32) / sr
    x = 0.02 * torch.randn((n, length), generator=gen, device=device)
    for k in range(4):
        x += amp[:, k] * torch.sin(2 * math.pi * freq[:, k] * t + phase[:, k])
    return 0.95 * x / x.abs().amax(dim=1, keepdim=True)


def mels_for(h: Any, frames: list[int], gen: torch.Generator, device: torch.device) -> list:
    """One (num_mels, f) log-mel per entry of ``frames``, from seeded audio of
    f * hop samples, made in one batch per distinct length."""
    out: list = [None] * len(frames)
    for f in sorted(set(frames)):
        idx = [i for i, x in enumerate(frames) if x == f]
        audio = synthetic_audio(len(idx), f * h["hop_size"], h["sampling_rate"], gen, device)
        mel = log_mel(h, audio)
        for j, i in enumerate(idx):
            out[i] = mel[j]
    return out
