"""The slice end to end: the port's make_fast_vocoder on CPU vs the JAX
make_fast_vocoder (Pallas in interpret mode) and vs the port's Generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.config import get_config
from hifigan_tpu.models import Generator as JaxGenerator
from hifigan_tpu.models.fast_infer import make_fast_vocoder as jax_fast_vocoder
from hifigan_tpu_torch.models import Generator
from hifigan_tpu_torch.models.fast_infer import folds_upsampler, make_fast_vocoder
from tests.torch_port_helpers import fold_up_config, folded_pair, random_mel, small_config


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


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_fold_up_matches_jax(resblock):
    """The upsampler of the stride-2 stage folded into its kernel, against
    the JAX make_fast_vocoder(fold_up=True) (Pallas in interpret mode)."""
    h = fold_up_config(resblock)
    fp, sd = folded_pair(h)
    mel = random_mel(2, 16, seed=6)
    ref = np.asarray(jax_fast_vocoder(h, fp, dtype=jnp.float32, tile_blocks=64, interpret=True,
                                      fold_up=True)(jnp.asarray(mel)))
    got = make_fast_vocoder(h, sd, dtype=torch.float32, device="cpu",
                            fold_up=True)(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 1, 16 * 8)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("resblock,fold_post", [("1", True), ("2", False)])
def test_fold_up_agrees_with_the_unfolded_path(resblock, fold_post):
    h = fold_up_config(resblock)
    _, sd = folded_pair(h)
    mel = torch.from_numpy(random_mel(2, 12, seed=7))
    folded = make_fast_vocoder(h, sd, dtype=torch.float32, device="cpu", fold_post=fold_post,
                               fold_up=True)(mel)
    unfolded = make_fast_vocoder(h, sd, dtype=torch.float32, device="cpu",
                                 fold_post=fold_post)(mel)
    assert folded.shape == unfolded.shape == (2, 1, 12 * 8)
    torch.testing.assert_close(folded, unfolded, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_fold_predicate_matches_the_jax_choice(name):
    """The stages the JAX make_fast_vocoder(fold_up=True) folds (read from
    its closure, built on full-size weights of ones) are those
    folds_upsampler names: V1 and V2 stages 2 and 3, none of V3."""
    h = get_config(name)
    shapes = jax.eval_shape(lambda k, m: JaxGenerator(h, folded=True).init(k, m),
                            jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))["params"]
    fp = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32), shapes)
    fn = jax_fast_vocoder(h, fp, interpret=True, fold_up=True)
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    ours = [i for i in range(len(h["upsample_rates"])) if folds_upsampler(h, i)]
    assert sorted(cells["pre_packs"]) == ours == ([] if name == "v3" else [2, 3])
