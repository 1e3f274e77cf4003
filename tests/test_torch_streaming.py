"""The port's streamers on CPU: the stateful ``make_streaming_vocoder`` and
the halo ``streaming_vocode`` against the JAX package's, and against the
port's whole-utterance Generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.config import get_config as jax_get_config
from hifigan_tpu.models import Generator as JaxGenerator
from hifigan_tpu.models.streaming import make_streaming_vocoder as jax_streaming_vocoder
from hifigan_tpu.parallel import halo as jhalo
from hifigan_tpu_torch.config import get_config
from hifigan_tpu_torch.models import Generator
from hifigan_tpu_torch.models.streaming import make_streaming_vocoder
from hifigan_tpu_torch.parallel.halo import generator_halo_frames, streaming_vocode
from tests.torch_port_helpers import folded_pair, random_mel, small_config


def _stream(step, state, mel, chunk: int) -> np.ndarray:
    outs = []
    for s in range(0, mel.shape[-1], chunk):
        state, wav = step(state, mel[:, :, s:s + chunk])
        outs.append(np.asarray(wav))
    return np.concatenate(outs, axis=-1)


def _full(h, sd, mel: np.ndarray) -> np.ndarray:
    gen = Generator(h, folded=True)
    gen.load_state_dict(sd)
    with torch.no_grad():
        return gen(torch.from_numpy(mel)).numpy()


@pytest.mark.parametrize("use_fast", [False, True])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_streaming_vocoder_matches_jax(resblock, use_fast):
    """Same delay and every emitted sample within 2e-4 of the JAX streamer
    (its MRF in the Pallas kernel in interpret mode with ``use_fast``), fp32,
    4-frame chunks; the port's fused path takes the kernel's plain version
    on the CPU."""
    h = small_config(resblock)
    fp, sd = folded_pair(h)
    mel = random_mel(2, 20, seed=8)
    j_init, j_step, j_delay = jax_streaming_vocoder(h, fp, dtype=jnp.float32, use_fast=use_fast,
                                                    interpret=True)
    t_init, t_step, t_delay = make_streaming_vocoder(h, sd, dtype=torch.float32,
                                                     use_fast=use_fast, device="cpu")
    assert t_delay == j_delay > 0
    ref = _stream(jax.jit(j_step), j_init(2), jnp.asarray(mel), 4)
    state = t_init(2)
    assert [tuple(s.shape) for s in state] == [tuple(s.shape) for s in j_init(2)]
    got = _stream(t_step, state, torch.from_numpy(mel), 4)
    assert got.shape == ref.shape == (2, 1, 20 * 16)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("use_fast", [False, True])
def test_streaming_matches_the_generator_after_the_delay(use_fast):
    """Emitted positions are [-delay, T*hop - delay): after the priming and
    the head that zero history makes differ, the stream equals the whole-
    utterance Generator (the bound of tests/test_streaming_state.py)."""
    h = small_config("1")
    _, sd = folded_pair(h)
    mel = random_mel(2, 48, seed=9)
    init_state, step, delay = make_streaming_vocoder(h, sd, dtype=torch.float32,
                                                     use_fast=use_fast, device="cpu")
    stream = _stream(step, init_state(2), torch.from_numpy(mel), 8)
    full = _full(h, sd, mel)
    total = full.shape[-1]
    assert stream.shape == full.shape and 0 < 2 * delay < total
    np.testing.assert_allclose(stream[:, :, 2 * delay:], full[:, :, delay:total - delay],
                               rtol=2e-4, atol=2e-5)
    assert np.abs(stream[:, :, delay:2 * delay] - full[:, :, :delay]).max() < 0.5


def test_streaming_state_windows_smaller_than_the_halo():
    """The mel-rate buffer is 2 x 3 frames (conv_pre) whatever the halo, and
    the output delay is below the halo streamer's lookahead of halo * hop."""
    h = small_config("1")
    _, sd = folded_pair(h)
    init_state, _, delay = make_streaming_vocoder(h, sd, dtype=torch.float32, device="cpu")
    assert init_state()[0].shape[1] == 6
    assert delay <= generator_halo_frames(h) * 16


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_generator_halo_frames_matches_jax(name):
    assert generator_halo_frames(get_config(name)) == jhalo.generator_halo_frames(
        jax_get_config(name))


def test_streaming_vocode_matches_jax_and_the_generator():
    """The halo streamer over the port's Generator against the JAX one over
    its Generator on the same weights, and against whole-utterance
    synthesis (both 2e-4)."""
    h = small_config("2")
    fp, sd = folded_pair(h)
    mel = random_mel(2, 40, seed=10)
    halo = generator_halo_frames(h)
    gen = Generator(h, folded=True)
    gen.load_state_dict(sd)
    jgen = JaxGenerator(h, folded=True)
    ref = jhalo.streaming_vocode(jax.jit(lambda p, m: jgen.apply({"params": p}, m)), fp,
                                 jnp.asarray(mel), 8, halo, 16)
    with torch.no_grad():
        got = streaming_vocode(lambda p, m: gen(m), None, torch.from_numpy(mel), 8, halo, 16)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (2, 1, 40 * 16)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got, _full(h, sd, mel), atol=2e-4, rtol=0)
