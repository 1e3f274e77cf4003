"""Inference CLIs of the port on --device cpu."""

import json

import numpy as np
import pytest
import torch

from hifigan_tpu_torch.audio import load_wav, save_wav
from hifigan_tpu_torch.cli import infer, infer_e2e
from hifigan_tpu_torch.models import Generator
from tests.torch_port_helpers import small_config


def _checkpoint_dir(tmp_path):
    h = small_config("1")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(h))
    gen = Generator(h, generator=torch.Generator().manual_seed(0))
    torch.save({"generator": gen.state_dict()}, ckpt / "g_00000001")
    return h, ckpt / "g_00000001"


@pytest.mark.parametrize("fast", [False, True])
def test_infer_writes_wav_on_cpu(tmp_path, fast):
    h, ckpt = _checkpoint_dir(tmp_path)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    sr = h["sampling_rate"]
    tone = (0.5 * np.sin(2 * np.pi * 220 * np.arange(sr // 4) / sr)).astype(np.float32)
    save_wav(str(wavs / "tone.wav"), tone, sr)
    argv = ["--input_wavs_dir", str(wavs), "--output_dir", str(tmp_path / "out"),
            "--checkpoint_file", str(ckpt), "--device", "cpu"] + (["--fast"] if fast else [])
    infer.main(argv)
    data, out_sr = load_wav(str(tmp_path / "out" / "tone_generated.wav"))
    frames = (sr // 4) // h["hop_size"]  # reflect pad (n_fft - hop) / 2 a side
    assert out_sr == sr and data.shape == (1, frames * 16)
    assert np.isfinite(data).all() and np.abs(data).max() > 0


def test_infer_e2e_writes_wav_on_cpu(tmp_path):
    h, ckpt = _checkpoint_dir(tmp_path)
    mels = tmp_path / "mels"
    mels.mkdir()
    np.save(mels / "utt.npy", np.random.default_rng(0).standard_normal((80, 10)).astype(np.float32))
    infer_e2e.main(["--input_mels_dir", str(mels), "--output_dir", str(tmp_path / "out"),
                    "--checkpoint_file", str(ckpt), "--device", "cpu", "--fast"])
    data, _ = load_wav(str(tmp_path / "out" / "utt_generated_e2e.wav"))
    assert data.shape == (1, 10 * 16)


def test_pcm16_saturates_instead_of_wrapping():
    pcm = infer.to_pcm16(np.array([1.0, -1.0, 0.5], np.float32))
    assert pcm.tolist() == [32767, -32768, 16384]


def test_streaming_flags_raise(tmp_path):
    h, ckpt = _checkpoint_dir(tmp_path)
    with pytest.raises(NotImplementedError):
        infer.main(["--input_wavs_dir", str(tmp_path), "--checkpoint_file", str(ckpt),
                    "--device", "cpu", "--streaming_chunk", "32"])
