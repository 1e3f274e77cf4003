"""The plain reference against the port's CPU path at a tiny width, and the
control precisions. (This test imports both; the reference imports nothing of
the port.)"""

import torch

from port_bench import harness, inputs
from port_bench.reference import discriminators as rd
from port_bench.reference import generator as rg
from port_bench.reference.mel import log_mel
from port_bench.reference.numerics import FP8, TF32, round_fp8, round_tf32
from port_bench.reference.train_step import new_state, train_step

TINY = dict(harness.config("hifigan_v1"), upsample_initial_channel=32,
            mpd_channels=[4, 8, 16, 32], msd_width=16)
CPU = torch.device("cpu")


def _weights(shapes, fold=False, seed=0):
    return inputs.conv_weights(shapes, torch.Generator().manual_seed(seed), CPU, fold=fold)


def _audio(n, t, seed=1):
    return inputs.synthetic_audio(n, t, TINY["sampling_rate"], torch.Generator().manual_seed(seed),
                                  CPU)


def test_generator_equals_the_port_generator():
    from hifigan_tpu_torch.models import Generator

    params, _ = _weights(rg.conv_shapes(TINY))
    port = Generator(TINY)
    port.load_state_dict(params)
    mel = log_mel(TINY, _audio(2, 32 * 256))
    with torch.no_grad():
        torch.testing.assert_close(rg.generator(TINY, params, mel), port(mel), rtol=1e-5,
                                   atol=1e-6)


def test_discriminators_equal_the_port_discriminators():
    from hifigan_tpu_torch.train.vocoder import build_discriminators

    params, buffers = _weights(rd.conv_shapes(TINY))
    mpd, msd = build_discriminators(TINY)
    sd = {**params, **buffers}
    mpd.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("mpd.")})
    msd.load_state_dict({k[4:]: v for k, v in sd.items() if k.startswith("msd.")})
    y, y_hat = _audio(2, 4096), _audio(2, 4096, seed=2)
    with torch.no_grad():
        ref = rd.mpd(TINY, params, y, y_hat)
        got = mpd(y, y_hat)
        for a, b in zip(ref[0] + ref[1], got[0] + got[1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        ref_buffers = {k: v.clone() for k, v in buffers.items()}
        ref = rd.msd(TINY, params, ref_buffers, y, y_hat)
        got = msd(y, y_hat, update_spectral=True)
        for a, b in zip(ref[0] + ref[1], got[0] + got[1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        for k, v in ref_buffers.items():
            torch.testing.assert_close(v, dict(msd.named_buffers())[k[4:]])


def test_log_mel_equals_the_port_mel():
    from hifigan_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram

    y = _audio(2, 8192)
    for key in ("fmax", "fmax_for_loss"):
        torch.testing.assert_close(log_mel(TINY, y, key),
                                   log_mel_spectrogram(y, MelConfig.from_hparams(TINY, key)),
                                   rtol=1e-5, atol=1e-4)


def test_train_step_equals_the_port_train_step():
    from hifigan_tpu_torch.models import Generator
    from hifigan_tpu_torch.train import vocoder

    g_params, _ = _weights(rg.conv_shapes(TINY))
    d_params, buffers = _weights(rd.conv_shapes(TINY), seed=1)
    params = {**{f"generator.{k}": v for k, v in g_params.items()}, **d_params}
    audio = _audio(2, 8192)
    mel = log_mel(TINY, audio)
    gen = Generator(TINY)
    mpd, msd = vocoder.build_discriminators(TINY)
    sd = {**params, **buffers}
    for top, module in (("generator.", gen), ("mpd.", mpd), ("msd.", msd)):
        module.load_state_dict({k[len(top):]: v for k, v in sd.items() if k.startswith(top)})
    opt_g, opt_d = vocoder.make_optimizers(TINY, gen, mpd, msd)
    state = vocoder.VocoderTrainState(gen, mpd, msd, opt_g, opt_d, 0, CPU)
    _, metrics = vocoder.make_train_step(TINY)(state, {"audio": audio, "mel": mel})
    ref = new_state(TINY, params, buffers)
    losses, _ = train_step(TINY, ref, audio, mel)
    for k in ("loss_gen_all", "loss_disc_all"):
        torch.testing.assert_close(metrics[k], losses[k], rtol=1e-5, atol=1e-6)
    port = {f"{t}.{n}": p for t, m in (("generator", gen), ("mpd", mpd), ("msd", msd))
            for n, p in m.named_parameters()}
    for k, p in ref.params.items():
        torch.testing.assert_close(port[k], p.detach(), rtol=1e-4, atol=1e-6)


def test_control_precisions_round_as_stated():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0, 1e-3])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -3.0, round_tf32(x)[3].item()]
    assert (round_tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    y = torch.linspace(-2, 2, 101)
    q = round_fp8(y)
    assert (q - y).abs().max() <= 2 / 448 * 32 and q.abs().max() == 2.0
    w = torch.randn(4, 3, 5, requires_grad=True)
    x = torch.randn(2, 3, 16, requires_grad=True)
    TF32.conv1d(x, w).sum().backward()
    assert w.grad is not None and x.grad is not None
    assert FP8.conv1d(x.detach(), w.detach()).shape == (2, 4, 12)
