"""Port Generator vs the JAX Generator (fp32 on CPU, <= 2e-4 abs)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models import Generator as JaxGenerator
from hifigan_tpu.models import fold_weight_norm as jax_fold
from hifigan_tpu_torch.config import get_config
from hifigan_tpu_torch.models import Generator, fold_weight_norm
from hifigan_tpu_torch.train.checkpoint import generator_state_dict_from_jax
from tests.torch_port_helpers import jax_params, random_mel, small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("resblock,folded", [("1", False), ("1", True), ("2", False), ("2", True)])
def test_generator_matches_jax(resblock, folded):
    h = small_config(resblock)
    params = jax_params(h)
    if folded:
        params = jax_fold(params)
    mel = random_mel(2, 12)
    ref = np.asarray(JaxGenerator(h, folded=folded).apply({"params": params}, jnp.asarray(mel)))

    gen = Generator(h, folded=folded)
    gen.load_state_dict(generator_state_dict_from_jax(params))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 1, 12 * 16)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


def test_fold_weight_norm_matches_jax():
    h = small_config("1")
    params = jax_params(h)
    ours = fold_weight_norm(generator_state_dict_from_jax(params))
    theirs = generator_state_dict_from_jax(jax_fold(params))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("folded", [False, True])
def test_generator_names_and_init(folded):
    """state_dict keys and shapes are the reference's; init is torch's
    (g = ||v||, |v| and |bias| within 1/sqrt(fan_in)) and seeded."""
    h = small_config("1")
    ref_keys = generator_state_dict_from_jax(jax_fold(jax_params(h)) if folded else jax_params(h))
    gen = Generator(h, folded=folded, generator=torch.Generator().manual_seed(0))
    sd = gen.state_dict()
    assert sd.keys() == ref_keys.keys()
    for k in sd:
        assert sd[k].shape == ref_keys[k].shape, k
    if not folded:
        v, g = sd["conv_pre.weight_v"], sd["conv_pre.weight_g"]
        torch.testing.assert_close(g, v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt())
        assert v.abs().max() <= 1 / np.sqrt(80 * 7)
    again = Generator(h, folded=folded, generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("name", ["v1", "v2", "v3"])
def test_builtin_configs_equal_shared_json(name):
    with open(os.path.join(REPO, "configs", f"config_{name}.json")) as f:
        assert dict(get_config(name)) == json.load(f)
