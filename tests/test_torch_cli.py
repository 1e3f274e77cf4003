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


def _write_tone(tmp_path, fast, extra=()):
    h, ckpt = _checkpoint_dir(tmp_path)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    sr = h["sampling_rate"]
    tone = (0.5 * np.sin(2 * np.pi * 220 * np.arange(sr // 4) / sr)).astype(np.float32)
    save_wav(str(wavs / "tone.wav"), tone, sr)
    argv = ["--input_wavs_dir", str(wavs), "--output_dir", str(tmp_path / "out"),
            "--checkpoint_file", str(ckpt), "--device", "cpu"] + (["--fast"] if fast else [])
    infer.main(argv + list(extra))
    data, out_sr = load_wav(str(tmp_path / "out" / "tone_generated.wav"))
    frames = (sr // 4) // h["hop_size"]  # reflect pad (n_fft - hop) / 2 a side
    assert out_sr == sr and data.shape == (1, frames * 16)
    assert np.isfinite(data).all() and np.abs(data).max() > 0


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("stateful", [False, True])
def test_infer_streaming_writes_wav_on_cpu(tmp_path, fast, stateful):
    """--streaming_chunk 4 (and --streaming_state) write the whole file."""
    _write_tone(tmp_path, fast, ["--streaming_chunk", "4"] + (["--streaming_state"]
                                                              if stateful else []))


@pytest.mark.parametrize("fast", [False, True])
def test_infer_writes_wav_on_cpu(tmp_path, fast):
    _write_tone(tmp_path, fast)


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


@pytest.mark.parametrize("stateful,fast", [(False, False), (False, True), (True, False),
                                           (True, True)])
def test_streaming_flags_match_the_jax_synthesize(stateful, fast):
    """``synthesize`` with --streaming_chunk (the halo streamer over the
    --fast or Generator apply) and --streaming_chunk --streaming_state (the
    stateful streamer, bf16 as in JAX) against the JAX CLI's on the same
    weights and mel: fp32 within 2e-4; where either side runs bf16 (--fast,
    or the stateful streamer), within 2^-4 of the JAX waveform's peak, the
    port's bf16 serving bound."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from hifigan_tpu.cli import infer as jinfer
    from tests.torch_port_helpers import folded_pair, random_mel

    h = small_config("1")
    fp, sd = folded_pair(h)
    mel = random_mel(1, 40, seed=11)
    a = SimpleNamespace(fast=fast, streaming_chunk=8, streaming_state=stateful)
    ref = np.asarray(jinfer.synthesize(a, h, jinfer.make_apply(a, h, fp, True), fp,
                                       jnp.asarray(mel)))
    got = infer.synthesize(a, h, infer.make_apply(a, h, sd, torch.device("cpu")), sd,
                           torch.from_numpy(mel))
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (1, 1, 40 * 16)
    bf16 = fast or stateful
    tol = 2.0 ** -4 * np.abs(ref).max() if bf16 else 2e-4
    assert np.abs(got - ref).max() <= tol
