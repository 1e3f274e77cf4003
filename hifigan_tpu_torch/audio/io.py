"""Host-side waveform I/O.

A copy of ``hifigan_tpu/audio/io.py``: the reference's `load_wav`/`save_wav`
semantics on scipy's wav reader, on the host.

`load_wav(normalize=True)` returns float32 in [-1, 1] like
torchaudio.load(normalize=True); integer PCM is scaled by the type's range.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


_PCM_SCALE = {np.dtype("int16"): 32768.0, np.dtype("int32"): 2147483648.0, np.dtype("uint8"): 128.0}


def load_wav(path: str, normalize: bool = True) -> tuple[np.ndarray, int]:
    """Read a wav file -> (data (channels, T) float32, sampling_rate)."""
    sr, data = wavfile.read(path)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # scipy gives (T, C)
    if normalize:
        if data.dtype == np.uint8:
            data = (data.astype(np.float32) - 128.0) / 128.0
        elif data.dtype in (np.dtype("int16"), np.dtype("int32")):
            data = data.astype(np.float32) / _PCM_SCALE[data.dtype]
        else:
            data = data.astype(np.float32)
    return data, int(sr)


def save_wav(path: str, data: np.ndarray, sampling_rate: int) -> None:
    """Write (channels, T) or (T,) float in [-1,1] or int16 to a wav file."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data.T  # scipy wants (T, C)
    if data.dtype != np.int16:
        data = np.clip(data, -1.0, 1.0)
        data = (data * 32767.0).astype(np.int16)
    wavfile.write(path, sampling_rate, data)


def peak_normalize(wav: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """librosa.util.normalize equivalent: scale so max |x| == 1."""
    peak = np.max(np.abs(wav))
    if peak < eps:
        return wav
    return wav / peak
