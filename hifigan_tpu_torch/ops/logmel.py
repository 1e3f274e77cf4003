"""Fused log-mel spectrogram forward in CUDA, and its plain version.

Replaces ``hifigan_tpu/ops/pallas/logmel.py::fused_log_mel`` (:135; the
kernel ``_kernel`` :43, Pallas call :101). For the standard geometry
(n_fft == win_size == 4 * hop, power 2; :func:`supports_fused_log_mel`) it
maps y (B, T) to (B, num_mels, F): reflect pad (n_fft - hop) / 2 a side,
frames of n_fft every hop, the Hann-windowed real-DFT basis as a product
(fp32, no TF32), power, the mel filterbank, log(max(., 1e-5)). Output
values match :func:`hifigan_tpu_torch.audio.mel.log_mel_spectrogram`.

- :func:`fused_log_mel_reference` is the plain PyTorch version: frames @
  windowed basis, power, @ filterbank, log clamp, in fp32.
- :func:`fused_log_mel` takes the plain version for a CPU tensor; for a
  CUDA tensor the forward launches ``csrc/logmel.cu`` (or raises). The
  reflect pad and the crop to (F + 3) * hop samples stay in PyTorch, as
  they are XLA ops outside the Pallas call in JAX. There is no backward
  kernel: the backward recomputes the plain composition under autograd and
  pulls the cotangent through it, saving only ``y``, as the JAX custom VJP
  does (``logmel.py:153-162``).
- ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.audio.mel import MelConfig, mel_filterbank
from hifigan_tpu_torch.audio.stft import windowed_rdft_basis

LAUNCHES = 0
LOG_CLIP = 1e-5


def supports_fused_log_mel(cfg: MelConfig) -> bool:
    return (cfg.n_fft == cfg.win_size and cfg.n_fft == 4 * cfg.hop_size and cfg.power == 2.0
            and cfg.method != "fft")


@functools.lru_cache(maxsize=None)
def _tables(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(windowed real-DFT basis (n_fft, 2 * n_bins), filterbank (n_bins, mels)), fp32."""
    fb = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax,
                        cfg.mel_scale, cfg.norm)
    return windowed_rdft_basis(cfg.n_fft, cfg.win_size), fb


_DEVICE_TABLES: dict = {}


def _device_tables(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    key = (cfg, device)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = tuple(torch.from_numpy(t).to(device) for t in _tables(cfg))
    return _DEVICE_TABLES[key]


def num_frames(t: int, cfg: MelConfig) -> int:
    pad = (cfg.n_fft - cfg.hop_size) // 2
    return 1 + (t + 2 * pad - cfg.n_fft) // cfg.hop_size


def _pad_crop(y: torch.Tensor, cfg: MelConfig) -> tuple[torch.Tensor, int]:
    """The reflect-padded signal cropped to the samples the frames read:
    ((F - 1) * hop + n_fft) = (F + 3) * hop for the supported geometry."""
    pad = (cfg.n_fft - cfg.hop_size) // 2
    frames = num_frames(y.shape[-1], cfg)
    yp = F.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    return yp[:, : (frames - 1) * cfg.hop_size + cfg.n_fft], frames


def fused_log_mel_reference(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_log_mel` (autograd backward)."""
    yp, _ = _pad_crop(y, cfg)
    basis, fb = (torch.from_numpy(t).to(y.device) for t in _tables(cfg))
    n_bins = cfg.n_fft // 2 + 1
    spec = yp.unfold(-1, cfg.n_fft, cfg.hop_size) @ basis  # (B, F, 2 * n_bins)
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    mel = (re * re + im * im) @ fb
    return torch.log(torch.clamp(mel, min=LOG_CLIP)).transpose(-1, -2)


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

_KERNEL = None  # the ctypes entry of csrc/logmel.cu, signature set once


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        from hifigan_tpu_torch.ops import _build

        fn = _build.load("logmel").hifigan_logmel
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        fn.restype = ci
        _KERNEL = fn
    return _KERNEL


def _launch(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    global LAUNCHES
    yp, frames = _pad_crop(y, cfg)
    yp = yp.contiguous()
    basis, fb = _device_tables(cfg, y.device)
    n_bins = cfg.n_fft // 2 + 1
    out = torch.empty((y.shape[0], cfg.num_mels, frames), dtype=torch.float32, device=y.device)
    rc = _kernel()(yp.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(), y.shape[0],
                   frames, yp.shape[1], cfg.hop_size, cfg.n_fft, n_bins, cfg.num_mels,
                   torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_log_mel kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


class _FusedLogMel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(y)
        return _launch(y, cfg)

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        with torch.enable_grad():
            yy = y.detach().requires_grad_()
            (dy,) = torch.autograd.grad(fused_log_mel_reference(yy, ctx.cfg), yy, grad)
        return dy, None


def fused_log_mel(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, T) -> (B, num_mels, F) fp32 for a geometry :func:`supports_fused_log_mel`
    accepts. A CPU tensor takes :func:`fused_log_mel_reference`; a CUDA
    tensor launches the kernel (or raises). Differentiable in y."""
    if not supports_fused_log_mel(cfg):
        raise ValueError(f"unsupported mel geometry for the fused kernel: {cfg}")
    if y.dim() != 2:
        raise ValueError(f"y must be (B, T), got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return fused_log_mel_reference(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"fused_log_mel runs on cpu or cuda, got {y.device}")
    if not y.is_floating_point():
        raise TypeError(f"y must be a float tensor, got {y.dtype}")
    with torch.cuda.device(y.device):
        return _FusedLogMel.apply(y.float(), cfg)
