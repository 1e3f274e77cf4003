"""ctypes bindings for the native host-DSP library (native/host_dsp.cpp; a
copy of ``hifigan_tpu/data/native.py`` loading the same ``libhost_dsp.so``).

The reference's augmentation DSP was native C (sox via torchaudio); this is
the framework's native layer for the host input pipeline. Falls back to the
numpy implementations in hifigan_tpu_torch.data.augmentation when the shared
library hasn't been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native", "libhost_dsp.so")
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.one_pole_lowpass.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float]
    lib.one_pole_highpass.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_float]
    lib.mu_law_roundtrip.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float]
    lib.fir_apply.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int64, f32p]
    lib.peak_normalize_rows.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float]
    try:
        lib.gsm0610_roundtrip.argtypes = [f32p, f32p, ctypes.c_int64]
    except AttributeError:  # stale .so without the codec
        pass
    _LIB = lib
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _run_1d(fn, x: np.ndarray, *args) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    fn(_ptr(x), _ptr(y), x.size, *args)
    return y


def one_pole_lowpass(x: np.ndarray, freq: float, sr: int) -> np.ndarray:
    lib = _find_lib()
    if lib is None:
        from hifigan_tpu_torch.data.augmentation import sox_one_pole_lowpass

        return sox_one_pole_lowpass(x, freq, sr)
    return _run_1d(lib.one_pole_lowpass, x, ctypes.c_float(freq), ctypes.c_float(sr))


def one_pole_highpass(x: np.ndarray, freq: float, sr: int) -> np.ndarray:
    lib = _find_lib()
    if lib is None:
        from hifigan_tpu_torch.data.augmentation import sox_one_pole_highpass

        return sox_one_pole_highpass(x, freq, sr)
    return _run_1d(lib.one_pole_highpass, x, ctypes.c_float(freq), ctypes.c_float(sr))


def mu_law_roundtrip(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    lib = _find_lib()
    if lib is None:
        from hifigan_tpu_torch.data.augmentation import mu_law_roundtrip as np_mu

        return np_mu(x, mu)
    return _run_1d(lib.mu_law_roundtrip, x, ctypes.c_float(mu))


def fir_apply(x: np.ndarray, h: np.ndarray, offset: int) -> np.ndarray:
    """y[i] = sum_j x[i + j - offset] * h[j], zero-padded bounds."""
    lib = _find_lib()
    if lib is None:
        from scipy import signal

        # correlate: full[m] = sum_j x[m - (k-1) + j] h[j] -> m = i + k-1 - offset
        full = signal.correlate(x, h, mode="full")
        k = len(h)
        return full[k - 1 - offset : k - 1 - offset + len(x)].astype(np.float32)
    x = np.ascontiguousarray(x, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    y = np.empty_like(x)
    lib.fir_apply(_ptr(x), x.size, _ptr(h), h.size, ctypes.c_int64(offset), _ptr(y))
    return y


def gsm0610_available() -> bool:
    lib = _find_lib()
    return lib is not None and hasattr(lib, "gsm0610_roundtrip")


def gsm0610_roundtrip_8k(x: np.ndarray) -> np.ndarray:
    """GSM 06.10 (RPE-LTP) encode+decode of 8 kHz float PCM
    (native/gsm0610.cpp). Raises if the native lib isn't built — callers
    gate on :func:`gsm0610_available` and fall back to a documented
    simulation otherwise."""
    lib = _find_lib()
    if lib is None or not hasattr(lib, "gsm0610_roundtrip"):
        raise RuntimeError("native GSM 06.10 codec unavailable (make -C native)")
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    lib.gsm0610_roundtrip(_ptr(x), _ptr(y), x.size)
    return y


def peak_normalize_rows(x: np.ndarray, peak: float = 1.0) -> np.ndarray:
    lib = _find_lib()
    if lib is None:
        m = np.abs(x).max(axis=-1, keepdims=True)
        return np.where(m > 1e-10, x * (peak / np.maximum(m, 1e-10)), x)
    x = np.ascontiguousarray(x, np.float32).copy()
    rows = x.reshape(-1, x.shape[-1])
    lib.peak_normalize_rows(_ptr(rows), rows.shape[0], rows.shape[1], ctypes.c_float(peak))
    return x
