"""The port's distillation train step against the JAX step, on the CPU.

The configuration is ``_tiny_distill_config(3)`` of ``__graft_entry__.py``
with the changes its production-composition run makes (mix size 3,
144-sample segments, a discriminator of the production layer family with a
``roll:`` and an ``all:`` block, so the member runs the fused path), and
``accumulated_grad_batches`` 1 as shipped there. JAX draws the state; the
port carries it over (``distill_variables_from_jax``), both run one step on
the same batch, and the loss tree and every updated variable are compared.
The JAX step is compiled once for the file.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_distill_config
from hifigan_tpu.distill import cycles as jcycles
from hifigan_tpu.distill import losses as jlosses
from hifigan_tpu.distill import tensor_ops as jops
from hifigan_tpu.distill.model import DistillModels as JaxDistillModels
from hifigan_tpu.distill.train import DistillTrainer as JaxDistillTrainer
from hifigan_tpu_torch.distill import cycles, losses, tensor_ops
from hifigan_tpu_torch.distill.model import DistillModels, flat_optimizer_groups
from hifigan_tpu_torch.distill.train import DistillTrainer
from hifigan_tpu_torch.train.checkpoint import (
    distill_state_dicts,
    distill_variables_from_jax,
    distill_variables_to_jax,
    load_distill_variables,
)
from tests.torch_port_helpers import CHEAP_CODEGEN, run_cheap

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5


def _config():
    cfg, labels, weights = _tiny_distill_config(3)
    cfg["loops"]["train"]["mix_size"] = 3
    cfg["loops"]["train"]["segment_length"] = 144
    cfg["models"]["discriminator"]["layers"] = [
        "roll:1,9,1", "roll:1,5,2", "roll:2,5,2", "all:3,5,2", "roll:4,3,1"]
    return cfg, labels, weights


def _batch(cfg, labels, emb, seed):
    rng = np.random.default_rng(seed)
    seg = cfg["loops"]["train"]["segment_length"]
    return {"audio": (rng.standard_normal((3, seg)) * 0.1).astype(np.float32),
            "time_labels": {g: {k: rng.integers(0, len(v), (3, seg // emb))
                                for k, v in group.items()} for g, group in labels.items()}}


def _port(cfg, labels, weights, variables, member_impl="auto"):
    models = DistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                           member_impl=member_impl, device="cpu")
    models.build(cfg["loops"]["train"]["segment_length"])
    load_distill_variables(models, distill_variables_from_jax(variables))
    return models


@pytest.fixture(scope="module")
def runs():
    cfg, labels, weights = _config()
    jm = JaxDistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                          member_impl="interpret")
    jt = JaxDistillTrainer(jm, cfg)
    seg = cfg["loops"]["train"]["segment_length"]
    jstate = run_cheap(lambda key: jt.create_state(key, seg), jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, jstate.variables)
    batch = _batch(cfg, labels, jm.embedding_size, 4)
    step = jt.make_train_step(donate=False)
    compiled = step.lower(jstate, batch, jax.random.PRNGKey(5)).compile(
        compiler_options=CHEAP_CODEGEN)
    j1, jlosses_ = compiled(jstate, batch, jax.random.PRNGKey(5))
    out = {"cfg": (cfg, labels, weights), "variables": variables, "batch": batch,
           "jax_losses": jax.tree_util.tree_map(np.asarray, jlosses_),
           "jax_after": jax.tree_util.tree_map(np.asarray, j1.variables)}
    models = _port(cfg, labels, weights, variables)
    trainer = DistillTrainer(models, cfg)
    state = trainer.create_state(build=False)
    state, tlosses = trainer.make_train_step()(state, batch)
    out["port_losses"] = tlosses
    out["port_after"] = distill_variables_to_jax(distill_state_dicts(models))
    out["port_state"] = state
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: float(tree)}


def test_step_loss_tree_matches_jax(runs):
    want, got = _flat(runs["jax_losses"]), _flat(runs["port_losses"])
    assert set(want) == set(got) and len(want) > 40
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_RTOL * abs(v) + 1e-7, (k, got[k], v)


@pytest.mark.parametrize("model", ["encoder", "decoder", "discriminator", "keepers", "hunters",
                                   "sniffers"])
def test_step_updates_every_group_as_jax(runs, model):
    want, got = runs["jax_after"][model], runs["port_after"][model]
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    before = runs["variables"][model]
    moved = 0
    for (path, a), b, b0 in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(before)):
        np.testing.assert_allclose(b, a, rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{model}{jax.tree_util.keystr(path)}")
        moved += not np.array_equal(a, b0)
    assert moved > 0


def test_frozen_copies_follow_the_live_models(runs):
    state = runs["port_state"]
    live = state.models.discriminator.state_dict()
    for k, v in state.disc_copy.state_dict().items():
        assert torch.equal(v, live[k]), k
    assert not any(p.requires_grad for p in state.disc_copy.parameters())
    for key, h in state.hunter_copies.items():
        for k, v in h.state_dict().items():
            assert torch.equal(v, state.models.hunters[key].state_dict()[k])


def test_interpreted_member_gives_the_same_step(runs):
    cfg, labels, weights = runs["cfg"]
    models = _port(cfg, labels, weights, runs["variables"], member_impl="interpret")
    trainer = DistillTrainer(models, cfg)
    _, tl = trainer.make_train_step()(trainer.create_state(build=False), runs["batch"])
    fused = _flat(runs["port_losses"])
    for k, v in _flat(tl).items():
        assert abs(fused[k] - v) <= LOSS_RTOL * abs(v) + 1e-7, k


def test_gradients_accumulate_before_an_update(runs):
    cfg, labels, weights = copy.deepcopy(runs["cfg"])
    cfg["learning"]["accumulated_grad_batches"] = 2
    models = _port(cfg, labels, weights, runs["variables"])
    trainer = DistillTrainer(models, cfg)
    state = trainer.create_state(build=False)
    step = trainer.make_train_step()
    before = {g: [p.detach().clone() for p in o.params] for g, o in state.optimizers.items()}
    state, _ = step(state, runs["batch"])
    for g, ps in before.items():
        assert all(torch.equal(a, b) for a, b in zip(ps, state.optimizers[g].params)), g
        assert any(a.any() for a in state.grad_accum[g]), g
    state, _ = step(state, runs["batch"])
    for g, ps in before.items():
        assert not all(torch.equal(a, b) for a, b in zip(ps, state.optimizers[g].params)), g
        assert not any(a.any() for a in state.grad_accum[g]), g


def test_carrier_round_trip(runs):
    """JAX variables -> the port's state_dicts -> JAX variables is exact,
    stacked ensemble members and spectral u included."""
    variables = runs["variables"]
    back = distill_variables_to_jax(distill_variables_from_jax(variables))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(variables), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    disc = distill_variables_from_jax(variables)["discriminator"]
    assert sum(k.endswith("weight_u") for k in disc) == 2  # one spectral conv per member
    assert variables["discriminator"]["spectral"]["m_fm_ens"]["m_pfm_aiod_b_0_conv"]["u"].shape[0] == 2


@pytest.mark.parametrize("a,b", [(3, 3), (3, 6), (4, 9), (6, 20)])
def test_cycles_match_jax(a, b):
    try:
        want = jcycles.calculate_cycles(a, b)
    except AssertionError:
        with pytest.raises(AssertionError):
            cycles.calculate_cycles(a, b)
    else:
        assert cycles.calculate_cycles(a, b) == want


@pytest.mark.parametrize("fn", ["expand", "mix", "unmix", "cut_and_roll"])
def test_tensor_ops_match_jax(fn):
    x = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    args = {"expand": (9, 0), "mix": ((3, 3), 0), "unmix": ((3, 3), 0),
            "cut_and_roll": (1, 1, 0)}[fn]
    want = getattr(jops, fn)(jnp.asarray(x), *args)
    got = getattr(tensor_ops, fn)(torch.from_numpy(x), *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["-", "+", "l1", "l2", "cos", "seg_bce", "seg_bias_bce"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(4), (2, 5)).astype(np.float32)
    other = rng.dirichlet(np.ones(4), (2, 5)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 5))
    ratios = {"true": (0.25, 0.0, 0.5, 0.25), "false": (0.75, 1.0, 0.5, 0.75)}
    args = {"-": (probs,), "+": (probs, other), "l1": (probs, other), "l2": (probs, other),
            "cos": (probs, other), "seg_bce": (probs, labels, ratios),
            "seg_bias_bce": (probs, other, labels, ratios)}[name]
    want = jlosses.get_loss_by_type(name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                            for a in args])
    got = losses.get_loss_by_type(name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                          for a in args])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def test_flat_groups_are_six_in_the_shipped_config():
    import json

    cfg = json.load(open("configs/distill.json"))
    assert list(flat_optimizer_groups(cfg["learning"]["optimizers"])) == [
        "generator,keepers", "discriminator", "hunters/content", "hunters/style",
        "sniffers/content", "sniffers/style"]
