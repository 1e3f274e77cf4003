"""STFT building blocks (PyTorch port of ``hifigan_tpu/audio/stft.py``).

The spectrogram path is ``torch.fft.rfft``, following torch.stft conventions
(periodic Hann, window centre-padded to n_fft, onesided, ``center=False``
framing). The DFT as a product with a real basis (:func:`_rdft_basis`,
:func:`windowed_rdft_basis`) serves the stream-graph mel branch and the
fused log-mel kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(win_size: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, as torch.hann_window(periodic=True)."""
    n = np.arange(win_size, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_size))
    return w.astype(dtype)


@functools.lru_cache(maxsize=None)
def _rdft_basis(n_fft: int, win_size: int) -> np.ndarray:
    """Real-DFT basis (win_size, 2 * (n_fft//2 + 1)): [cos | -sin] columns at the
    window's centre-padded offsets, so frames @ basis = [Re | Im] of the
    onesided DFT (the stream-graph mel branch's strided conv table)."""
    n_bins = n_fft // 2 + 1
    offset = (n_fft - win_size) // 2
    t = np.arange(win_size, dtype=np.float64) + offset
    k = np.arange(n_bins, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(t, k) / n_fft
    return np.concatenate([np.cos(phase), -np.sin(phase)], axis=1).astype(np.float32)


def windowed_rdft_basis(n_fft: int, win_size: int) -> np.ndarray:
    """The Hann-windowed real-DFT basis (win_size, 2 * (n_fft//2 + 1)), fp32:
    frames @ basis = [Re | Im] of the windowed onesided DFT (the fused
    log-mel kernel's table, as ``hifigan_tpu/ops/pallas/logmel.py:90-91``
    builds it)."""
    return (_rdft_basis(n_fft, win_size) * hann_window(win_size)[:, None]).astype(np.float32)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, F, n_fft) frames, F = 1 + (T - n_fft) // hop."""
    return y.unfold(-1, n_fft, hop)


def stft_real_imag(y: torch.Tensor, n_fft: int, hop: int,
                   win_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Onesided STFT -> (real, imag), each (B, F, n_fft // 2 + 1). center=False."""
    window = torch.from_numpy(hann_window(win_size)).to(y.device)
    off = (n_fft - win_size) // 2
    window = torch.nn.functional.pad(window, (off, n_fft - win_size - off))
    z = torch.fft.rfft(frame_signal(y, n_fft, hop).float() * window, n=n_fft, dim=-1)
    return z.real, z.imag


def stft_power(y: torch.Tensor, n_fft: int, hop: int, win_size: int,
               power: float = 2.0) -> torch.Tensor:
    """|STFT|^power, shape (B, F, n_bins)."""
    re, im = stft_real_imag(y, n_fft, hop, win_size)
    p2 = re * re + im * im
    if power == 2.0:
        return p2
    if power == 1.0:
        return torch.sqrt(p2)
    return torch.pow(p2, power / 2.0)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_size: int) -> torch.Tensor:
    return stft_power(y, n_fft, hop, win_size, power=1.0)
