"""Host-side training dataset for the vocoder (port of
``hifigan_tpu/data/meldataset.py``).

The dataset yields fixed-shape raw audio segments and the train step
computes the mels on the device. The fine-tuning path reads teacher-forced
mels from ``.npy`` files and yields (mel, aligned audio) pairs, and
:func:`mel_spectrogram_np` is the host numpy log-mel for ``host_mel=True``.
Crops draw from ``numpy.random.default_rng(seed)`` in the JAX package's
order, so the same seed gives the same segments and batches.
"""

from __future__ import annotations

import math
import os
from typing import Iterator

import numpy as np

from hifigan_tpu_torch.audio.io import load_wav, peak_normalize
from hifigan_tpu_torch.audio.mel import mel_filterbank
from hifigan_tpu_torch.audio.stft import hann_window


def get_dataset_filelist(input_training_file: str, input_validation_file: str,
                         input_wavs_dir: str) -> tuple[list[str], list[str]]:
    """Parse ``path|text`` filelists into wav paths."""

    def parse(path: str) -> list[str]:
        with open(path, "r", encoding="utf-8") as fi:
            return [os.path.join(input_wavs_dir, x.split("|")[0] + ".wav")
                    for x in fi.read().split("\n") if len(x) > 0]

    return parse(input_training_file), parse(input_validation_file)


def mel_spectrogram_np(y: np.ndarray, n_fft: int = 1024, num_mels: int = 80,
                       sampling_rate: int = 22050, hop_size: int = 256, win_size: int = 1024,
                       fmin: float = 0.0, fmax: float | None = 8000.0, power: float = 2.0,
                       mel_scale: str = "htk", norm: str | None = None) -> np.ndarray:
    """Numpy log-mel, the numerics of the torch pipeline. (B, T) -> (B, num_mels, frames)."""
    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    pad = int((n_fft - hop_size) / 2)
    y = np.pad(y, [(0, 0), (pad, pad)], mode="reflect")
    num_frames = 1 + (y.shape[-1] - n_fft) // hop_size
    idx = np.arange(num_frames)[:, None] * hop_size + np.arange(n_fft)[None, :]
    frames = y[:, idx]
    window = hann_window(win_size).astype(np.float64)
    if win_size < n_fft:
        off = (n_fft - win_size) // 2
        w = np.zeros(n_fft)
        w[off:off + win_size] = window
        window = w
    spec = np.abs(np.fft.rfft(frames * window, n=n_fft, axis=-1)) ** power
    fb = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax, mel_scale, norm)
    mel = np.log(np.clip(spec.astype(np.float32) @ fb, 1e-5, None))
    mel = np.swapaxes(mel, -1, -2)
    return mel[0] if squeeze else mel


class MelDataset:
    """Random-crop segment dataset.

    ``__getitem__`` returns ``(mel, audio, filename, mel_loss)`` with the
    reference's layouts; with ``host_mel=False`` (the training default) the
    mel entries are ``None`` and the train step computes them on the device.
    """

    def __init__(self, training_files: list[str], segment_size: int, n_fft: int,
                 num_mels: int, hop_size: int, win_size: int, sampling_rate: int,
                 fmin: float, fmax: float | None, split: bool = True, shuffle: bool = True,
                 n_cache_reuse: int = 1, fmax_loss: float | None = None,
                 fine_tuning: bool = False, base_mels_path: str | None = None,
                 host_mel: bool = False, seed: int = 1234) -> None:
        self.audio_files = list(training_files)
        self._rng = np.random.default_rng(seed)
        if shuffle:
            self._rng.shuffle(self.audio_files)
        self.segment_size = segment_size
        self.sampling_rate = sampling_rate
        self.split = split
        self.n_fft = n_fft
        self.num_mels = num_mels
        self.hop_size = hop_size
        self.win_size = win_size
        self.fmin = fmin
        self.fmax = fmax
        self.fmax_loss = fmax_loss
        self.cached_wav: np.ndarray | None = None
        self.n_cache_reuse = n_cache_reuse
        self._cache_ref_count = 0
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        self.host_mel = host_mel

    def __len__(self) -> int:
        return len(self.audio_files)

    def _load(self, filename: str) -> np.ndarray:
        if self._cache_ref_count == 0:
            audio, sr = load_wav(filename)
            if sr != self.sampling_rate:
                raise ValueError(f"{sr} SR doesn't match target {self.sampling_rate} SR")
            if not self.fine_tuning:
                audio = peak_normalize(audio) * 0.95
            self.cached_wav = audio
            self._cache_ref_count = self.n_cache_reuse
        else:
            audio = self.cached_wav
            self._cache_ref_count -= 1
        return audio[0]  # mono (T,)

    def _host_mel(self, audio: np.ndarray, fmax: float | None) -> np.ndarray:
        return mel_spectrogram_np(audio, self.n_fft, self.num_mels, self.sampling_rate,
                                  self.hop_size, self.win_size, self.fmin, fmax)

    def __getitem__(self, index: int):
        filename = self.audio_files[index]
        audio = self._load(filename)
        mel = None
        if not self.fine_tuning:
            if self.split:
                if audio.shape[0] >= self.segment_size:
                    max_start = audio.shape[0] - self.segment_size
                    start = int(self._rng.integers(0, max_start + 1))
                    audio = audio[start:start + self.segment_size]
                else:
                    audio = np.pad(audio, (0, self.segment_size - audio.shape[0]))
            if self.host_mel:
                mel = self._host_mel(audio, self.fmax)
        else:
            mel = np.load(os.path.join(self.base_mels_path,
                                       os.path.splitext(os.path.split(filename)[-1])[0] + ".npy"))
            if mel.ndim == 3:
                mel = mel[0]
            if self.split:
                frames_per_seg = math.ceil(self.segment_size / self.hop_size)
                if audio.shape[0] >= self.segment_size:
                    mel_start = int(self._rng.integers(0, mel.shape[1] - frames_per_seg))
                    mel = mel[:, mel_start:mel_start + frames_per_seg]
                    audio = audio[mel_start * self.hop_size:
                                  (mel_start + frames_per_seg) * self.hop_size]
                else:
                    mel = np.pad(mel, ((0, 0), (0, frames_per_seg - mel.shape[1])))
                    audio = np.pad(audio, (0, self.segment_size - audio.shape[0]))
        mel_loss = self._host_mel(audio, self.fmax_loss) if self.host_mel else None
        return mel, audio.astype(np.float32), filename, mel_loss

    def batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                process_index: int = 0, process_count: int = 1) -> Iterator[dict]:
        """Dicts of stacked numpy arrays with static shapes; with
        ``process_count > 1`` each process reads a disjoint strided subset."""
        order = np.arange(len(self.audio_files))
        if shuffle:
            self._rng.shuffle(order)
        order = order[process_index::process_count]
        n = len(order)
        end = n - n % batch_size if drop_last else n
        for i in range(0, end, batch_size):
            items = [self[int(j)] for j in order[i:i + batch_size]]
            batch = {"audio": np.stack([it[1] for it in items]),
                     "filenames": [it[2] for it in items]}
            if items[0][0] is not None:
                batch["mel"] = np.stack([it[0] for it in items])
            if items[0][3] is not None:
                batch["mel_loss"] = np.stack([it[3] for it in items])
            yield batch
