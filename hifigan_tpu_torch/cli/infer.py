"""Vocoder inference CLI: wav -> mel -> wav (port of ``hifigan_tpu/cli/infer.py``).

Flags: ``--input_wavs_dir``, ``--output_dir``, ``--checkpoint_file`` (a
torch ``g_*`` file; ``config.json`` sits beside it), ``--fast`` (every MRF
stage in the fused CUDA kernel), ``--streaming_chunk N`` (vocode in windows
of N mel frames with receptive-field overlap), ``--streaming_state`` (with
``--streaming_chunk``: the stateful streamer) and ``--device`` (default
``cuda``)::

    python -m hifigan_tpu_torch.cli.infer --checkpoint_file ckpt/g_00000000 --fast
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hifigan_tpu_torch.audio import MAX_WAV_VALUE, load_wav, save_wav
from hifigan_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from hifigan_tpu_torch.config import load_config, upsample_hop
from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.models import Generator, fold_weight_norm
from hifigan_tpu_torch.train.checkpoint import load_checkpoint


def load_generator_state(checkpoint_file: str) -> dict:
    """A ``g_*`` checkpoint -> the folded generator state_dict."""
    ckpt = load_checkpoint(checkpoint_file)
    state = ckpt["generator"] if "generator" in ckpt else ckpt
    return fold_weight_norm(state)


def make_apply(a, h, state: dict, device: torch.device):
    """fn(mel (B, M, T)) -> wav (B, 1, T*hop) float32, honoring --fast."""
    if getattr(a, "fast", False):
        from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder

        return make_fast_vocoder(h, state, device=device)
    gen = Generator(h, folded=True)
    gen.load_state_dict(state)
    gen = gen.to(device).eval()

    @torch.no_grad()
    def apply(mel: torch.Tensor) -> torch.Tensor:
        return gen(mel.to(device))

    return apply


def synthesize(a, h, apply, params: dict, x: torch.Tensor) -> np.ndarray:
    """mel (B, M, T) -> wav (B, 1, T * hop) as numpy, honoring
    ``--streaming_chunk`` (the halo streamer over ``apply``: exact, the halo
    covering the receptive field) and ``--streaming_state`` (the stateful
    streamer on the folded weights ``params``, bf16, the fused stage kernel
    on CUDA: exact from sample ``delay`` on; a whole file is flushed with
    silence and cropped to its length)."""
    chunk = int(getattr(a, "streaming_chunk", 0) or 0)
    hop = upsample_hop(h)
    if chunk > 0 and getattr(a, "streaming_state", False):
        from hifigan_tpu_torch.models.streaming import make_streaming_vocoder

        total = x.shape[-1]
        init_state, step, delay = make_streaming_vocoder(h, params, device=x.device)
        state = init_state(batch=x.shape[0])
        pad_frames = -(-delay // hop) + chunk
        xp = torch.nn.functional.pad(x, (0, pad_frames + (-total % chunk)))
        outs = []
        for s in range(0, xp.shape[-1], chunk):
            state, wav = step(state, xp[:, :, s:s + chunk])
            outs.append(wav.cpu().numpy())
        return np.concatenate(outs, axis=-1)[:, :, delay:delay + total * hop]
    if chunk > 0:
        from hifigan_tpu_torch.parallel.halo import generator_halo_frames, streaming_vocode

        return streaming_vocode(lambda p, m: apply(m), params, x, chunk,
                                generator_halo_frames(h), hop)
    return apply(x).float().cpu().numpy()


def to_pcm16(wav: np.ndarray) -> np.ndarray:
    """float waveform in [-1, 1] -> int16 (a sample of exactly 1.0 saturates)."""
    return np.clip(wav * MAX_WAV_VALUE, -32768, 32767).astype(np.int16)


def inference(a, h) -> list[str]:
    device = resolve_device(a.device)
    state = load_generator_state(a.checkpoint_file)
    apply = make_apply(a, h, state, device)
    mel_cfg = MelConfig.from_hparams(h)
    os.makedirs(a.output_dir, exist_ok=True)
    written = []
    for filename in sorted(os.listdir(a.input_wavs_dir)):
        if not filename.lower().endswith(".wav"):
            continue
        wav, _ = load_wav(os.path.join(a.input_wavs_dir, filename))
        x = log_mel_spectrogram(torch.from_numpy(wav).to(device), mel_cfg)
        y = synthesize(a, h, apply, state, x if x.dim() == 3 else x[None])
        out = os.path.join(a.output_dir, os.path.splitext(filename)[0] + "_generated.wav")
        save_wav(out, to_pcm16(y[0, 0]), h["sampling_rate"])
        print(out)
        written.append(out)
    return written


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_wavs_dir", default="test_files")
    parser.add_argument("--output_dir", default="generated_files")
    parser.add_argument("--checkpoint_file", required=True)
    parser.add_argument("--fast", action="store_true",
                        help="every MRF stage in the fused CUDA kernel (bf16)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--streaming_chunk", type=int, default=0,
                        help="vocode in fixed windows of N mel frames with "
                             "receptive-field overlap (0 = whole utterance)")
    parser.add_argument("--streaming_state", action="store_true",
                        help="with --streaming_chunk: the stateful streamer (per-stage "
                             "state, no halo recompute, lowest latency)")
    return parser


def main(argv: list[str] | None = None) -> None:
    print("Initializing Inference Process..")
    a = build_parser().parse_args(argv)
    h = load_config(os.path.join(os.path.split(a.checkpoint_file)[0], "config.json"))
    inference(a, h)


if __name__ == "__main__":
    main()
