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


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A distillation experiment directory written by the JAX side (the tiny
    production-schema config as ``yaml.dump``, ``checkpoints/latest`` as
    ``save_distill_state`` writes a seeded JAX trainer state), two wavs, and
    the JAX CLI's autoencoded outputs."""
    import jax
    import yaml

    from __graft_entry__ import _tiny_distill_config
    from hifigan_tpu.cli import infer_autoencoding as jcli
    from hifigan_tpu.distill.main import save_distill_state
    from hifigan_tpu.distill.model import DistillModels as JaxDistillModels
    from hifigan_tpu.distill.train import DistillTrainer as JaxDistillTrainer
    from tests.torch_port_helpers import run_cheap

    root = tmp_path_factory.mktemp("autoencoding")
    cfg, labels, weights = _tiny_distill_config(3)
    jm = JaxDistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                          member_impl="interpret")
    jt = JaxDistillTrainer(jm, cfg)
    state = run_cheap(lambda key: jt.create_state(key, 24), jax.random.PRNGKey(7))
    exp = root / "exp"
    (exp / "checkpoints").mkdir(parents=True)
    (exp / "config.yaml").write_text(yaml.dump(cfg))
    save_distill_state(str(exp / "checkpoints" / "latest"), state)
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(5)
    for i, n in enumerate((1000, 733)):
        save_wav(str(wavs / f"w{i}.wav"), (0.3 * rng.standard_normal(n)).astype(np.float32),
                 cfg["sampling_rate"])
    mp = pytest.MonkeyPatch()
    mp.setattr("sys.argv", ["infer_autoencoding", "--experiment_dir", str(exp),
                            "--input_wavs_dir", str(wavs), "--output_dir", str(root / "jax")])
    try:
        jcli.main()
    finally:
        mp.undo()
    return {"root": root, "exp": exp, "wavs": wavs, "cfg": cfg}


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_infer_autoencoding_matches_the_jax_cli(experiment, tmp_path, impl):
    """The port's CLI on the JAX side's experiment directory (its YAML and
    flax msgpack read by the port's own readers), with the config's
    ``models.stream_impl`` as written and set to 'fused': the same files
    within 2e-4 of the JAX CLI's."""
    import yaml

    from hifigan_tpu_torch.cli import infer_autoencoding

    exp = experiment["exp"]
    if impl == "fused":
        exp = tmp_path / "exp"
        (exp / "checkpoints").mkdir(parents=True)
        cfg = dict(experiment["cfg"], models=dict(experiment["cfg"]["models"], stream_impl="fused"))
        (exp / "config.yaml").write_text(yaml.dump(cfg))
        (exp / "checkpoints" / "latest").write_bytes(
            (experiment["exp"] / "checkpoints" / "latest").read_bytes())
    written = infer_autoencoding.main(["--experiment_dir", str(exp), "--input_wavs_dir",
                                       str(experiment["wavs"]), "--output_dir",
                                       str(tmp_path / "out"), "--device", "cpu"])
    assert [p.rsplit("/", 1)[1] for p in written] == ["w0_autoencoded.wav", "w1_autoencoded.wav"]
    for path, n in zip(written, (996, 732)):
        got, sr = load_wav(path)
        want, _ = load_wav(str(experiment["root"] / "jax" / path.rsplit("/", 1)[1]))
        assert sr == experiment["cfg"]["sampling_rate"] and got.shape == want.shape == (1, n)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_infer_autoencoding_without_device_raises_when_there_is_no_gpu(experiment, monkeypatch,
                                                                       tmp_path):
    from hifigan_tpu_torch.cli import infer_autoencoding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer_autoencoding.main(["--experiment_dir", str(experiment["exp"]), "--input_wavs_dir",
                                 str(experiment["wavs"]), "--output_dir", str(tmp_path)])


def test_infer_e2e_streaming_chunk_matches_the_jax_cli(tmp_path, monkeypatch):
    """``--streaming_chunk 4`` sends each mel through ``synthesize``'s halo
    streamer, as the JAX CLI does: on ``small_config("1")`` and a 10-frame
    mel, the port's files for chunk 0 and 4 are the JAX CLI's within 2e-4
    (the int16 files read back as floats), and the two differ where the JAX
    files differ."""
    import sys

    from hifigan_tpu.cli import infer_e2e as jinfer_e2e
    from hifigan_tpu_torch.parallel import halo

    h, ckpt = _checkpoint_dir(tmp_path)
    mels = tmp_path / "mels"
    mels.mkdir()
    np.save(mels / "utt.npy", np.random.default_rng(0).standard_normal((80, 10)).astype(np.float32))
    windows = []
    vocode = halo.streaming_vocode
    monkeypatch.setattr(halo, "streaming_vocode",
                        lambda *args: windows.append(args[3]) or vocode(*args))
    files = {}
    for chunk in (0, 4):
        for side in ("jax", "port"):
            out = tmp_path / f"{side}{chunk}"
            argv = ["--input_mels_dir", str(mels), "--output_dir", str(out),
                    "--checkpoint_file", str(ckpt), "--streaming_chunk", str(chunk)]
            if side == "jax":
                monkeypatch.setattr(sys, "argv", ["infer_e2e"] + argv)
                jinfer_e2e.main()
            else:
                infer_e2e.main(argv + ["--device", "cpu"])
            files[side, chunk] = load_wav(str(out / "utt_generated_e2e.wav"))[0]
    assert windows == [4]
    for chunk in (0, 4):
        assert files["port", chunk].shape == files["jax", chunk].shape == (1, 10 * 16)
        np.testing.assert_allclose(files["port", chunk], files["jax", chunk], rtol=0, atol=2e-4)
    np.testing.assert_array_equal(files["port", 0] != files["port", 4],
                                  files["jax", 0] != files["jax", 4])
