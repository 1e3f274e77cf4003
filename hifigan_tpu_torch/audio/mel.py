"""Log-mel spectrogram pipeline (PyTorch port of ``hifigan_tpu/audio/mel.py``).

Reflect-pad the waveform by (n_fft - hop)/2 on both sides, ``center=False``
STFT at power 2 (the fork's torchaudio convention) or 1 (upstream
hifi-gan), an HTK or Slaney mel filterbank, then log(clamp(x, 1e-5)).
The filterbank is the JAX package's numpy construction, copied.
``MelConfig(method='pallas')`` takes the fused log-mel kernel
(:mod:`hifigan_tpu_torch.ops.logmel`) for the geometries it supports.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.audio.stft import stft_power

MAX_WAV_VALUE = 32768.0


def _hz_to_mel(f, scale: str) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def _mel_to_hz(m, scale: str) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sampling_rate: int, n_fft: int, num_mels: int, fmin: float,
                   fmax: float | None, mel_scale: str = "htk",
                   norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank, shape (n_fft//2 + 1, num_mels).

    ``'htk', None`` matches torchaudio's melscale_fbanks defaults;
    ``'slaney', 'slaney'`` matches librosa.filters.mel defaults.
    """
    if fmax is None:
        fmax = sampling_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sampling_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel(fmin, mel_scale), _hz_to_mel(fmax, mel_scale), num_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:num_mels + 2] - f_pts[:num_mels]))[None, :]
    elif norm is not None:
        raise ValueError(f"unknown filterbank norm: {norm}")
    return fb.astype(np.float32)


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0) -> torch.Tensor:
    return torch.exp(x) / C


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Static mel parameters."""

    n_fft: int = 1024
    num_mels: int = 80
    sampling_rate: int = 22050
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 0.0
    fmax: float | None = 8000.0
    power: float = 2.0
    mel_scale: str = "htk"
    norm: str | None = None
    center: bool = False
    # 'pallas' runs the fused log-mel kernel (ops/logmel.py: CUDA for a CUDA
    # tensor, its plain matmul version for a CPU one) where
    # supports_fused_log_mel accepts the geometry, and torch.fft.rfft
    # otherwise; every other value takes torch.fft.rfft (the JAX package's
    # 'matmul' and 'fft' are TPU lowering choices with the same numerics)
    method: str = "auto"

    @classmethod
    def from_hparams(cls, h, fmax_key: str = "fmax", **over) -> "MelConfig":
        return cls(n_fft=h["n_fft"], num_mels=h["num_mels"], sampling_rate=h["sampling_rate"],
                   hop_size=h["hop_size"], win_size=h["win_size"], fmin=h["fmin"],
                   fmax=h.get(fmax_key, None), **over)


def _mel(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    if cfg.center:
        raise NotImplementedError("center=True is never used by the reference pipeline")
    squeeze = y.dim() == 1
    if squeeze:
        y = y[None]
    if cfg.method == "pallas":
        from hifigan_tpu_torch.ops.logmel import fused_log_mel, supports_fused_log_mel

        if supports_fused_log_mel(cfg):  # the JAX package's geometry gate
            mel = fused_log_mel(y, cfg)
            return mel[0] if squeeze else mel
    pad = int((cfg.n_fft - cfg.hop_size) / 2)
    y = F.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = stft_power(y, cfg.n_fft, cfg.hop_size, cfg.win_size, power=cfg.power)
    fb = torch.from_numpy(mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.num_mels, cfg.fmin,
                                         cfg.fmax, cfg.mel_scale, cfg.norm)).to(y.device)
    mel = dynamic_range_compression(spec @ fb).transpose(-1, -2)  # (B, num_mels, F)
    return mel[0] if squeeze else mel


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 22050, hop_size: int = 256, win_size: int = 1024,
                    fmin: float = 0.0, fmax: float | None = 8000.0, center: bool = False,
                    power: float = 2.0, mel_scale: str = "htk",
                    norm: str | None = None) -> torch.Tensor:
    """Log-mel spectrogram, (B, T) or (T,) -> (B, num_mels, frames) or (num_mels, frames)."""
    cfg = MelConfig(n_fft=n_fft, num_mels=num_mels, sampling_rate=sampling_rate,
                    hop_size=hop_size, win_size=win_size, fmin=fmin, fmax=fmax, power=power,
                    mel_scale=mel_scale, norm=norm, center=center)
    return _mel(y, cfg)


def log_mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Config-object form of :func:`mel_spectrogram` (same output layout)."""
    return _mel(y, cfg)
