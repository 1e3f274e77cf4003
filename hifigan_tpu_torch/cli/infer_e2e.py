"""End-to-end inference CLI: precomputed mel (.npy) -> wav
(port of ``hifigan_tpu/cli/infer_e2e.py``). Outputs ``*_generated_e2e.wav``.
Each mel goes through :func:`hifigan_tpu_torch.cli.infer.synthesize`, so
``--streaming_chunk N`` vocodes it in halo windows of N frames.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hifigan_tpu_torch.audio import save_wav
from hifigan_tpu_torch.cli.infer import load_generator_state, make_apply, synthesize, to_pcm16
from hifigan_tpu_torch.config import load_config
from hifigan_tpu_torch.device import resolve_device


def inference_e2e(a, h) -> list[str]:
    device = resolve_device(a.device)
    state = load_generator_state(a.checkpoint_file)
    apply = make_apply(a, h, state, device)
    os.makedirs(a.output_dir, exist_ok=True)
    written = []
    for filename in sorted(os.listdir(a.input_mels_dir)):
        if not filename.endswith(".npy"):
            continue
        x = torch.from_numpy(np.load(os.path.join(a.input_mels_dir, filename))).to(device)
        y = synthesize(a, h, apply, state, x if x.dim() == 3 else x[None])
        out = os.path.join(a.output_dir, os.path.splitext(filename)[0] + "_generated_e2e.wav")
        save_wav(out, to_pcm16(y[0, 0]), h["sampling_rate"])
        print(out)
        written.append(out)
    return written


def main(argv: list[str] | None = None) -> None:
    print("Initializing Inference Process..")
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_mels_dir", default="test_mel_files")
    parser.add_argument("--output_dir", default="generated_files_from_mel")
    parser.add_argument("--checkpoint_file", required=True)
    parser.add_argument("--fast", action="store_true",
                        help="every MRF stage in the fused CUDA kernel (bf16)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--streaming_chunk", type=int, default=0,
                        help="vocode in fixed windows of N mel frames with "
                             "receptive-field overlap (0 = whole utterance)")
    a = parser.parse_args(argv)
    h = load_config(os.path.join(os.path.split(a.checkpoint_file)[0], "config.json"))
    inference_e2e(a, h)


if __name__ == "__main__":
    main()
