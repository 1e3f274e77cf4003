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
  CUDA tensor the forward launches ``csrc/logmel.cu`` (or raises), one
  launch an extraction, on the route :func:`plan` picks from the geometry:

  - ``"fft"``: n_fft = 2^a 3^b 5^c 7^d 11^e 13^f (every shipped config's
    1024; 1200, 1100, 1764 at 44.1 kHz): an n_fft-point mixed-radix
    Stockham FFT per pair of frames in shared memory over the passes of
    :func:`fft_passes`, the twiddles of :func:`fft_tables`, the sparse
    filterbank of :func:`sparse_filterbank`;
  - ``"bluestein"``: any other n_fft (a prime factor above 13, e.g. 1028):
    the same passes at :func:`bluestein_length` inside a chirp-z transform;
  - ``"dense"``: a geometry whose buffers overflow shared memory even at 2
    frames a block: the windowed basis as a product.

  The FFT body takes 8, 4 or 2 frames a block (:func:`fft_frames`: the
  most whose buffers, :func:`fft_smem_bytes`, let two blocks share an SM,
  else the most that fit SMEM_LIMIT). For n_fft = 4 hop the buffers fit at
  2 frames up to n_fft 11,068 with a pass plan and up to 6,248 through
  Bluestein (its length is a step function of n_fft; 6,252 is the first
  admitted n_fft beyond); larger geometries take the dense route.
  ``csrc/logmel_plan.cuh`` holds the same pass plan, Bluestein length and
  shared-memory formula for the kernel's entry, which refuses any other.
  The reflect pad and the crop to (F + 3) * hop samples stay in PyTorch,
  as they are XLA ops outside the Pallas call in JAX. There is no backward
  kernel: the backward recomputes the plain composition under autograd and
  pulls the cotangent through it, saving only ``y``, as the JAX custom VJP
  does (``logmel.py:153-162``).
- ``LAUNCHES`` counts kernel launches, ``BODY_LAUNCHES`` the same per route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.audio.mel import MelConfig, mel_filterbank
from hifigan_tpu_torch.audio.stft import hann_window, windowed_rdft_basis
from hifigan_tpu_torch.ops import _build

LAUNCHES = 0
BODY_LAUNCHES = {"fft": 0, "bluestein": 0, "dense": 0}
LOG_CLIP = 1e-5
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)
# shared memory for each of two blocks resident on an SM: the SM's 228 KB,
# less the 1 KB the runtime reserves per block, halved
SMEM_TWO_BLOCKS = (233472 - 2 * 1024) // 2
FRAME_CHOICES = (8, 4, 2)  # frames per block of the FFT body
ODD_RADICES = (13, 11, 7, 5, 3)  # in pass order


def supports_fused_log_mel(cfg: MelConfig) -> bool:
    return (cfg.n_fft == cfg.win_size and cfg.n_fft == 4 * cfg.hop_size and cfg.power == 2.0
            and cfg.method != "fft")


@functools.lru_cache(maxsize=None)
def _tables(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(windowed real-DFT basis (n_fft, 2 * n_bins), filterbank (n_bins, mels)), fp32."""
    fb = mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax,
                        cfg.mel_scale, cfg.norm)
    return windowed_rdft_basis(cfg.n_fft, cfg.win_size), fb


def fft_passes(n: int, primes: bool = True) -> list[int] | None:
    """The radices of an n-point transform in pass order (``fft_plan`` in
    ``csrc/logmel_plan.cuh``): radix 13s, 11s, 7s, 5s, then 3s, then a radix
    2 when the power of two is odd, then radix 4s; None unless n = 2^a 3^b
    5^c 7^d 11^e 13^f >= 2 (2^a 3^b 5^c when ``primes`` is false)."""
    m, odd = n, []
    for r in ODD_RADICES if primes else ODD_RADICES[3:]:
        while m > 1 and m % r == 0:
            m //= r
            odd.append(r)
    a = 0
    while m > 1 and m % 2 == 0:
        m //= 2
        a += 1
    if n < 2 or m != 1:
        return None
    return odd + [2] * (a % 2) + [4] * (a // 2)


def bluestein_length(n: int) -> int:
    """Bluestein's transform length for n points: the smallest 2^a 3^b 5^c
    >= 2 n - 1."""
    m = 2 * n - 1
    while fft_passes(m, primes=False) is None:
        m += 1
    return m


def fft_smem_bytes(cfg: MelConfig, frames: int, length: int) -> int:
    """Shared memory of the FFT body (``smem_floats`` in the source): the
    tile's (frames - 1) * hop + n_fft samples rounded up to 4 floats, then
    two ping-pong buffers of frames / 2 complex sequences of ``length``
    points (n_fft, or Bluestein's length)."""
    sig = -(-((frames - 1) * cfg.hop_size + cfg.n_fft) // 4) * 4
    return 4 * (sig + 2 * (frames // 2) * length * 2)


def fft_frames(cfg: MelConfig, length: int) -> int | None:
    """Frames per block: the largest of 8, 4 and 2 whose buffers let two
    blocks (16 warps) share an SM, else the largest whose buffers fit
    SMEM_LIMIT, None if none does. One block an SM measured 1.19-1.33x slower
    than two of half the frames (``tools/logmel_frames_sweep.py``)."""
    for limit in (SMEM_TWO_BLOCKS, SMEM_LIMIT):
        fits = [f for f in FRAME_CHOICES if fft_smem_bytes(cfg, f, length) <= limit]
        if fits:
            return fits[0]
    return None


class LogMelPlan(NamedTuple):
    route: str  # "fft", "bluestein" or "dense"
    length: int  # the FFT's length: n_fft, Bluestein's, or n_fft on the dense route
    frames: int  # frames per block of the FFT body (0 on the dense route)


@functools.lru_cache(maxsize=None)
def plan(cfg: MelConfig) -> LogMelPlan:
    """The kernel's route for an admitted geometry: "fft" for n_fft with a
    pass plan, "bluestein" for any other n_fft, each where its buffers fit
    shared memory at 2 frames a block or more, else "dense"."""
    n = cfg.n_fft
    route, length = ("fft", n) if fft_passes(n) is not None else ("bluestein", bluestein_length(n))
    frames = fft_frames(cfg, length)
    return LogMelPlan(route, length, frames) if frames else LogMelPlan("dense", n, 0)


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


def _complex_table(z: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.stack([z.real, z.imag], axis=1).astype(np.float32))


class FftTables(NamedTuple):
    window: np.ndarray  # (n_fft,) Hann
    twiddle: np.ndarray  # (length, 2): exp(-2 pi i m / length)
    chirp: np.ndarray | None  # Bluestein: (n_fft, 2): exp(-i pi (n^2 mod 2 n_fft) / n_fft)
    filter: np.ndarray | None  # Bluestein: (length, 2): FFT(conj chirp, circular) / length
    mel_idx: np.ndarray  # (3, mels) int32 (sparse_filterbank)
    mel_vals: np.ndarray  # fp32


@functools.lru_cache(maxsize=None)
def fft_tables(cfg: MelConfig) -> FftTables:
    """The FFT body's tables, computed in float64 and stored fp32: the Hann
    window, the twiddles of the plan's length, for Bluestein the chirp c[n] =
    exp(-i pi n^2 / n_fft) (phases from n^2 mod 2 n_fft) and the filter,
    the FFT of conj c laid out circularly (b[m] = b[length - m] = conj c[m],
    m < n_fft), divided by the length; the sparse filterbank."""
    n, length = cfg.n_fft, plan(cfg).length
    twiddle = np.exp(-2j * np.pi * np.arange(length, dtype=np.float64) / length)
    chirp = filt = None
    if plan(cfg).route == "bluestein":
        k = np.arange(n, dtype=np.int64)
        c = np.exp(-1j * np.pi * ((k * k) % (2 * n)) / n)
        b = np.zeros(length, dtype=np.complex128)
        b[:n] = np.conj(c)
        b[length - k[1:]] = np.conj(c[1:])
        chirp, filt = _complex_table(c), _complex_table(np.fft.fft(b) / length)
    idx, vals = sparse_filterbank(_tables(cfg)[1])
    return FftTables(hann_window(n), _complex_table(twiddle), chirp, filt, idx, vals)


_DEVICE_TABLES: dict = {}


def _device_tables(cfg: MelConfig, device: torch.device) -> tuple:
    """The route's tables on ``device`` (None stays None), cached."""
    key = (cfg, device)
    if key not in _DEVICE_TABLES:
        tables = _tables(cfg) if plan(cfg).route == "dense" else fft_tables(cfg)
        _DEVICE_TABLES[key] = tuple(None if t is None else torch.from_numpy(t).to(device)
                                    for t in tables)
    return _DEVICE_TABLES[key]


def num_frames(t: int, cfg: MelConfig) -> int:
    pad = (cfg.n_fft - cfg.hop_size) // 2
    return 1 + (t + 2 * pad - cfg.n_fft) // cfg.hop_size


def _pad_crop(y: torch.Tensor, cfg: MelConfig) -> tuple[torch.Tensor, int]:
    """The reflect-padded signal cropped to the samples the frames read:
    ((F - 1) * hop + n_fft) = (F + 3) * hop for the supported geometry. The
    right pad stops where the frames do (between hop / 2 and 3 hop / 2
    samples for n_fft = 4 hop), so the result is one contiguous tensor."""
    pad = (cfg.n_fft - cfg.hop_size) // 2
    frames = num_frames(y.shape[-1], cfg)
    right = (frames - 1) * cfg.hop_size + cfg.n_fft - y.shape[-1] - pad
    return F.pad(y.float()[:, None], (pad, right), mode="reflect")[:, 0], frames


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
        lib = _build.load("logmel")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        dense, fft = lib.hifigan_logmel, lib.hifigan_logmel_fft
        dense.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        fft.argtypes = [vp] * 8 + [ci] * 9 + [vp]
        dense.restype = fft.restype = ci
        _KERNELS = {"dense": dense, "fft": fft}
    return _KERNELS


def _launch(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    global LAUNCHES
    _build.probe("logmel", "fwd", fused_log_mel_reference, y, cfg)
    yp, frames = _pad_crop(y, cfg)
    yp = yp.contiguous()
    tables = _device_tables(cfg, y.device)
    n_bins = cfg.n_fft // 2 + 1
    out = torch.empty((y.shape[0], cfg.num_mels, frames), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    route, length, block_frames = plan(cfg)
    if route == "dense":
        basis, fb = tables
        rc = _kernels()["dense"](yp.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(),
                                 y.shape[0], frames, yp.shape[1], cfg.hop_size, cfg.n_fft,
                                 n_bins, cfg.num_mels, stream)
    else:
        ptrs = [None if t is None else t.data_ptr() for t in tables]
        rc = _kernels()["fft"](yp.data_ptr(), *ptrs, out.data_ptr(), y.shape[0], frames,
                               yp.shape[1], cfg.hop_size, cfg.n_fft, length, block_frames,
                               cfg.num_mels, fft_smem_bytes(cfg, block_frames, length), stream)
    if rc != 0:
        raise RuntimeError(f"fused_log_mel kernel launch failed ({route} route): cudaError {rc}")
    LAUNCHES += 1
    BODY_LAUNCHES[route] += 1
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
