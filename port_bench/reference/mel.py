"""Log-mel spectrogram, as the program under test states it computes it.

Reflect-pad the waveform by (n_fft - hop) / 2 a side, frame it without
centring, periodic Hann window (win_size, centred in n_fft), one-sided DFT,
power 2, an HTK mel filterbank without normalisation (torchaudio's
``melscale_fbanks`` defaults), log(max(x, 1e-5)). Upstream hifi-gan takes
the magnitude and a Slaney filterbank; the program follows its fork's
torchaudio convention, and the reference computes the program's stated
function. The filterbank is built here in float64 from its formula.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def htk_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None):
    """(n_fft // 2 + 1, n_mels) triangular filters on the HTK mel scale."""
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    rising = (freqs[:, None] - lo[None]) / (mid - lo)[None]
    falling = (hi[None] - freqs[:, None]) / (hi - mid)[None]
    return np.maximum(0.0, np.minimum(rising, falling))


def log_mel(h: Any, y: torch.Tensor, fmax_key: str = "fmax") -> torch.Tensor:
    """(B, T) waveform -> (B, num_mels, frames) log-mel, fp32."""
    n_fft, hop, win = h["n_fft"], h["hop_size"], h["win_size"]
    pad = (n_fft - hop) // 2
    y = F.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop)
    n = torch.arange(win, dtype=torch.float64, device=y.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win)
    off = (n_fft - win) // 2
    window = F.pad(window, (off, n_fft - win - off)).float()
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(htk_filterbank(h["sampling_rate"], n_fft, h["num_mels"], h["fmin"],
                                         h.get(fmax_key))).float().to(y.device)
    return torch.log(torch.clamp(power @ fb, min=1e-5)).transpose(1, 2)
