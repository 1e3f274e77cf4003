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


def fold_up_config(resblock: str = "1") -> AttrDict:
    """:func:`small_config` with a stride-2 last stage (8 channels from 16),
    the stage the JAX ``make_fast_vocoder(fold_up=True)`` folds."""
    h = small_config(resblock)
    h.update(upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4])
    return h


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


CHEAP_CODEGEN = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def run_cheap(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with the backend's cheap codegen: the
    same HLO, about half the one-core compile time."""
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP_CODEGEN)(*args)


def dsl_pair(cfg, example: np.ndarray, seed: int = 0, jax_kw=None, torch_kw=None):
    """A JAX ``ConfigurableModule`` initialised on ``example`` (an array or a
    dict of arrays) and the port's
    module of the same config carrying its variables: (jax module, numpy
    variables, port module)."""
    import torch

    from hifigan_tpu.dsl.module import ConfigurableModule as JaxModule
    from hifigan_tpu_torch.dsl.module import ConfigurableModule
    from hifigan_tpu_torch.train.checkpoint import dsl_state_dict_from_jax

    jm = JaxModule(config=cfg, **(jax_kw or {}))
    variables = run_cheap(lambda key, x: jm.init({"params": key, "noise": key}, x, mutable=[
        "params", "spectral", "valves"]), jax.random.PRNGKey(seed),
                          jax.tree_util.tree_map(jnp.asarray, example))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = ConfigurableModule(cfg, **(torch_kw or {}))
    tm.build(jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a[:1])), example),
             generator=torch.Generator().manual_seed(0))
    tm.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                        for k, v in dsl_state_dict_from_jax(variables).items()})
    return jm, variables, tm


def leaves(tree) -> list:
    """Leaves in JAX's pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]
