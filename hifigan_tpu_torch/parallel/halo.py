"""Receptive-field halo of the generator and the halo streamer.

Port of ``generator_halo_frames`` and ``streaming_vocode`` from
``hifigan_tpu/parallel/halo.py``. Every conv of the generator family is
'same'-padded, so synthesizing a window of ``chunk + 2 * halo`` mel frames and
keeping its middle ``chunk * hop`` samples equals whole-utterance synthesis up
to float order, as long as the halo covers the receptive field.
"""

from __future__ import annotations

import numpy as np
import torch


def generator_halo_frames(h, margin: int = 4) -> int:
    """A safe static bound on the generator's receptive field in mel frames.

    conv_pre k7 contributes 3 frames; each stage its transposed conv's
    overlap and its widest resblock chain, in input-frame units (divided by
    the upsampling so far, rounded up, plus one); conv_post 3 output
    samples; then ``margin``. Cropping removes any excess.
    """
    halo = 3  # conv_pre k7
    up = 1
    for i, u in enumerate(h["upsample_rates"]):
        k_up = h["upsample_kernel_sizes"][i]
        up *= u
        stage = (k_up - u) // 2  # transposed-conv overlap, in pre-stage samples
        res = 0
        for k, ds in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            depth = sum(ds) + len(ds)  # dilated + unit convs
            res = max(res, (k - 1) // 2 * depth)
        halo += -(-(stage + res) // up) + 1
    halo += -(-3 // up)  # conv_post
    return halo + margin


def _to_numpy(wav) -> np.ndarray:
    if isinstance(wav, torch.Tensor):
        return wav.detach().float().cpu().numpy()
    return np.asarray(wav)


def streaming_vocode(apply_fn, params, mel: torch.Tensor, chunk_frames: int,
                     halo_frames: int, hop: int) -> np.ndarray:
    """Vocode a mel (B, M, T) in fixed windows of ``chunk_frames + 2 *
    halo_frames`` frames and concatenate the exactly cropped middles, as a
    numpy array (B, 1, T * hop).

    ``apply_fn(params, mel_window) -> (B, 1, window * hop)``. Every window
    has one shape: at the sequence edges the window slides inward so its
    edge is the sequence's, where the layers' zero padding then matches
    whole-utterance synthesis.
    """
    total = mel.shape[-1]
    window = chunk_frames + 2 * halo_frames
    if total <= window:
        return _to_numpy(apply_fn(params, mel))
    outs = []
    for start in range(0, total, chunk_frames):
        take = min(chunk_frames, total - start)
        lo = min(max(0, start - halo_frames), total - window)
        offset = start - lo
        wav = _to_numpy(apply_fn(params, mel[:, :, lo:lo + window]))
        outs.append(wav[:, :, offset * hop:(offset + take) * hop])
    return np.concatenate(outs, axis=-1)
