"""Port log-mel pipeline vs the JAX one (mel-L1 < 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.audio import mel as jmel
from hifigan_tpu_torch.audio import mel as tmel
from hifigan_tpu_torch.audio import stft as tstft


@pytest.mark.parametrize("power,mel_scale,norm,jax_method", [
    (2.0, "htk", None, "auto"),
    (1.0, "slaney", "slaney", "matmul"),
    (2.0, "htk", None, "matmul"),
])
def test_log_mel_matches_jax(power, mel_scale, norm, jax_method):
    """The port's rfft path against the JAX package's rfft ('auto' on the
    CPU) and DFT-matmul paths."""
    sr = 22050
    t = np.arange(sr // 2) / sr
    rng = np.random.default_rng(5)
    y = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size))
    y = y.astype(np.float32)[None]
    jcfg = jmel.MelConfig(power=power, mel_scale=mel_scale, norm=norm, method=jax_method)
    tcfg = tmel.MelConfig(power=power, mel_scale=mel_scale, norm=norm)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(y), jcfg))
    got = tmel.log_mel_spectrogram(torch.from_numpy(y), tcfg).numpy()
    assert got.shape == ref.shape
    assert np.mean(np.abs(got - ref)) < 1e-4


def test_filterbank_and_window_equal_jax():
    from hifigan_tpu.audio.stft import hann_window

    for scale, norm in (("htk", None), ("slaney", "slaney")):
        np.testing.assert_array_equal(tmel.mel_filterbank(22050, 1024, 80, 0, 8000, scale, norm),
                                      jmel.mel_filterbank(22050, 1024, 80, 0, 8000, scale, norm))
    np.testing.assert_allclose(tstft.hann_window(1024), hann_window(1024), atol=0)
    np.testing.assert_allclose(tstft.hann_window(1024),
                               torch.hann_window(1024, periodic=True).numpy(), atol=1e-6)


def test_mel_spectrogram_shapes_and_guards():
    y = torch.zeros(4096)
    assert tmel.mel_spectrogram(y).shape == (80, 16)
    torch.testing.assert_close(tmel.log_mel_spectrogram(y, tmel.MelConfig(method="pallas")),
                               tmel.mel_spectrogram(y), rtol=0, atol=2e-4)
    with pytest.raises(NotImplementedError):
        tmel.mel_spectrogram(y, center=True)
