"""Shared set-up of the PyTorch port's parity tests: small generator configs
and JAX reference weights carried into the port's state_dict."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hifigan_tpu.config import get_config
from hifigan_tpu.models import Generator, fold_weight_norm
from hifigan_tpu_torch.config import AttrDict
from hifigan_tpu_torch.train.checkpoint import generator_state_dict_from_jax


def small_config(resblock: str = "1") -> AttrDict:
    """A narrow V1-shaped (resblock '1') or V3-shaped ('2') config: 2 stages, 2 resblocks."""
    h = dict(get_config("v1"))
    h.update(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32)
    if resblock == "1":
        h.update(resblock="1", resblock_kernel_sizes=[3, 5],
                 resblock_dilation_sizes=[[1, 3], [1, 3]])
    else:
        h.update(resblock="2", resblock_kernel_sizes=[3, 5],
                 resblock_dilation_sizes=[[1, 2], [2, 3]])
    return AttrDict(h)


def random_mel(batch: int, frames: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, 80, frames)) * 2.0 - 5.0).astype(np.float32)


def jax_params(h, frames: int = 8, seed: int = 0) -> dict:
    """Weight-normed JAX Generator params (numpy leaves)."""
    params = Generator(h).init(jax.random.PRNGKey(seed), jnp.zeros((1, 80, frames)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def folded_pair(h, seed: int = 0) -> tuple[dict, dict]:
    """(folded JAX params, the same weights as the port's folded state_dict)."""
    fp = jax.tree_util.tree_map(np.asarray, fold_weight_norm(jax_params(h, seed=seed)))
    return fp, generator_state_dict_from_jax(fp)


def tiny_train_config() -> AttrDict:
    """``tests/test_train.py``'s tiny vocoder config (2 stages, MPD periods
    (2, 3), MSD width 16 over 2 scales, 256-sample segments)."""
    from tests.test_train import tiny_config

    return AttrDict(tiny_config())


def numpy_state(module) -> dict:
    """A module's state_dict as numpy copies (the JAX converters' input; a
    copy, so later in-place updates of the module do not reach JAX)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}
