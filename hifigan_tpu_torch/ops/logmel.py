"""Fused log-mel spectrogram forward in CUDA, and its plain version.

Replaces ``hifigan_tpu/ops/pallas/logmel.py::fused_log_mel`` (:135; the
kernel ``_kernel`` :43, Pallas call :101). For the standard geometry
(n_fft == win_size == 4 * hop, power 2; :func:`supports_fused_log_mel`) it
maps y (B, T) to (B, num_mels, F): reflect pad (n_fft - hop) / 2 a side,
frames of n_fft every hop, the Hann-windowed onesided DFT (fp32, no TF32),
power, the mel filterbank, log(max(., 1e-5)). Output values match
:func:`hifigan_tpu_torch.audio.mel.log_mel_spectrogram`.

- :func:`fused_log_mel_reference` is the plain PyTorch version: frames @
  windowed basis, power, @ filterbank, log clamp, in fp32.
- :func:`fused_log_mel` takes the plain version for a CPU tensor; for a
  CUDA tensor the forward launches ``csrc/logmel.cu`` (or raises). The
  kernel has two bodies, chosen here by the geometry (:func:`uses_fft`):
  an n_fft = 2^a 3^b 5^c whose buffers fit shared memory (every shipped
  config's 1024, and e.g. 1200) takes the FFT body (an n_fft-point
  mixed-radix Stockham FFT per pair of frames in shared memory over the
  passes of :func:`fft_passes`, the twiddles of :func:`fft_tables`, the
  sparse filterbank of :func:`sparse_filterbank`); any other admitted
  geometry (a prime factor above 5, e.g. 1100) the dense body (the
  windowed basis as a product). The reflect pad and the crop to
  (F + 3) * hop samples stay in PyTorch, as they are XLA ops outside the
  Pallas call in JAX. There is no backward kernel: the backward recomputes
  the plain composition under autograd and pulls the cotangent through it,
  saving only ``y``, as the JAX custom VJP does (``logmel.py:153-162``).
- ``LAUNCHES`` counts kernel launches, ``BODY_LAUNCHES`` the same per body.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.audio.mel import MelConfig, mel_filterbank
from hifigan_tpu_torch.audio.stft import hann_window, windowed_rdft_basis

LAUNCHES = 0
BODY_LAUNCHES = {"fft": 0, "dense": 0}
LOG_CLIP = 1e-5
FFT_FRAMES = 8  # frames per block of the FFT body (kFftFrames in the source)
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)


def supports_fused_log_mel(cfg: MelConfig) -> bool:
    return (cfg.n_fft == cfg.win_size and cfg.n_fft == 4 * cfg.hop_size and cfg.power == 2.0
            and cfg.method != "fft")


@functools.lru_cache(maxsize=None)
def _tables(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(windowed real-DFT basis (n_fft, 2 * n_bins), filterbank (n_bins, mels)), fp32."""
    fb = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax,
                        cfg.mel_scale, cfg.norm)
    return windowed_rdft_basis(cfg.n_fft, cfg.win_size), fb


def fft_passes(n_fft: int) -> list[int] | None:
    """The FFT body's radices in pass order (``fft_plan`` in the source):
    radix 5s, then 3s, then a radix 2 when the power of two is odd, then
    radix 4s; None unless n_fft = 2^a 3^b 5^c >= 2."""
    m, odd = n_fft, []
    for r in (5, 3):
        while m > 1 and m % r == 0:
            m //= r
            odd.append(r)
    a = 0
    while m > 1 and m % 2 == 0:
        m //= 2
        a += 1
    if n_fft < 2 or m != 1:
        return None
    return odd + [2] * (a % 2) + [4] * (a // 2)


def fft_smem_bytes(cfg: MelConfig) -> int:
    """Shared memory of the FFT body (``fft_smem_floats`` in the source):
    the tile's (FFT_FRAMES - 1) * hop + n_fft samples, then two ping-pong
    buffers of FFT_FRAMES / 2 complex n_fft-point sequences."""
    n = cfg.n_fft
    sig = -(-((FFT_FRAMES - 1) * cfg.hop_size + n) // 4) * 4
    return 4 * (sig + 2 * (FFT_FRAMES // 2) * n * 2)


def uses_fft(cfg: MelConfig) -> bool:
    """Whether the kernel takes its FFT body (else the dense one): n_fft =
    2^a 3^b 5^c and the body's buffers within SMEM_LIMIT."""
    return fft_passes(cfg.n_fft) is not None and fft_smem_bytes(cfg) <= SMEM_LIMIT


def sparse_filterbank(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each mel's contiguous range of nonzero bins: (index (3, mels) int32 of
    first bin, count and offset into the weights; the weights, fp32)."""
    idx, vals = [], []
    off = 0
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        k0, cnt = (int(nz[0]), int(nz[-1]) - int(nz[0]) + 1) if nz.size else (0, 0)
        idx.append((k0, cnt, off))
        vals.append(fb[k0:k0 + cnt, m])
        off += cnt
    return (np.ascontiguousarray(np.array(idx, dtype=np.int32).T),
            np.concatenate(vals).astype(np.float32))


@functools.lru_cache(maxsize=None)
def fft_tables(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The FFT body's tables: Hann window (n_fft,) fp32, twiddles
    exp(-2 pi i m / n_fft) as (n_fft, 2) fp32 computed in float64, and the
    sparse filterbank (:func:`sparse_filterbank`)."""
    n = cfg.n_fft
    phase = -2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    twiddle = np.stack([np.cos(phase), np.sin(phase)], axis=1).astype(np.float32)
    idx, vals = sparse_filterbank(_tables(cfg)[1])
    return hann_window(n), twiddle, idx, vals


_DEVICE_TABLES: dict = {}


def _device_tables(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    key = (cfg, device)
    if key not in _DEVICE_TABLES:
        tables = fft_tables(cfg) if uses_fft(cfg) else _tables(cfg)
        _DEVICE_TABLES[key] = tuple(torch.from_numpy(t).to(device) for t in tables)
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

_KERNELS = None  # the ctypes entries of csrc/logmel.cu, signatures set once


def _kernels():
    global _KERNELS
    if _KERNELS is None:
        from hifigan_tpu_torch.ops import _build

        lib = _build.load("logmel")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        dense, fft = lib.hifigan_logmel, lib.hifigan_logmel_fft
        dense.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        fft.argtypes = [vp] * 6 + [ci] * 7 + [vp]
        dense.restype = fft.restype = ci
        _KERNELS = {"dense": dense, "fft": fft}
    return _KERNELS


def _launch(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    global LAUNCHES
    yp, frames = _pad_crop(y, cfg)
    yp = yp.contiguous()
    tables = _device_tables(cfg, y.device)
    n_bins = cfg.n_fft // 2 + 1
    out = torch.empty((y.shape[0], cfg.num_mels, frames), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    body = "fft" if uses_fft(cfg) else "dense"
    if body == "fft":
        window, twiddle, idx, vals = tables
        rc = _kernels()["fft"](yp.data_ptr(), window.data_ptr(), twiddle.data_ptr(),
                               idx.data_ptr(), vals.data_ptr(), out.data_ptr(), y.shape[0],
                               frames, yp.shape[1], cfg.hop_size, cfg.n_fft, cfg.num_mels,
                               fft_smem_bytes(cfg), stream)
    else:
        basis, fb = tables
        rc = _kernels()["dense"](yp.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
                                 y.shape[0], frames, yp.shape[1], cfg.hop_size, cfg.n_fft,
                                 n_bins, cfg.num_mels, stream)
    if rc != 0:
        raise RuntimeError(f"fused_log_mel kernel launch failed ({body} body): cudaError {rc}")
    LAUNCHES += 1
    BODY_LAUNCHES[body] += 1
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
