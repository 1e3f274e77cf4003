"""The slice end to end: the port's make_fast_vocoder on CPU vs the JAX
make_fast_vocoder (Pallas in interpret mode) and vs the port's Generator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models.fast_infer import make_fast_vocoder as jax_fast_vocoder
from hifigan_tpu_torch.models import Generator
from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
from tests.torch_port_helpers import folded_pair, random_mel, small_config


@pytest.mark.parametrize("resblock,fold_post", [("1", True), ("2", False)])
def test_fast_vocoder_matches_jax(resblock, fold_post):
    h = small_config(resblock)
    fp, sd = folded_pair(h)
    mel = random_mel(2, 16, seed=3)
    ref = np.asarray(jax_fast_vocoder(h, fp, dtype=jnp.float32, tile_blocks=64, interpret=True,
                                      fold_post=fold_post)(jnp.asarray(mel)))
    got = make_fast_vocoder(h, sd, dtype=torch.float32, device="cpu",
                            fold_post=fold_post)(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 1, 16 * 16)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)

    gen = Generator(h, folded=True)
    gen.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(got, gen(torch.from_numpy(mel)).numpy(), atol=2e-4, rtol=0)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_fast_vocoder_fold_post_agrees(resblock):
    """conv_post folded into the last stage equals the tail run after it."""
    h = small_config(resblock)
    _, sd = folded_pair(h)
    mel = torch.from_numpy(random_mel(1, 8, seed=4))
    folded = make_fast_vocoder(h, sd, dtype=torch.float32, device="cpu")(mel)
    unfolded = make_fast_vocoder(h, sd, dtype=torch.float32, device="cpu", fold_post=False)(mel)
    assert folded.shape == unfolded.shape == (1, 1, 8 * 16)
    torch.testing.assert_close(folded, unfolded, atol=1e-5, rtol=0)


def test_fold_up_is_not_ported():
    h = small_config("1")
    _, sd = folded_pair(h)
    with pytest.raises(NotImplementedError):
        make_fast_vocoder(h, sd, device="cpu", fold_up=True)
