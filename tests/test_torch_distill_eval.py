"""The port's distillation eval step and label-bias sniffer trainer against
the JAX package's, on the CPU.

The eval step runs at the small production-schema config of
``tests/test_torch_distill.py`` from a state JAX draws and the port carries
over; the losses and the data tree (waveforms, mels, the label truth /
keep / sniff / hunt predictions) are compared. The sniffer trainer takes
two train steps and one eval step on both sides from the same weights.
Tolerances: 2e-4 abs on waveforms, 1e-5 relative elsewhere (of each
tensor's peak for the data trees).
"""

import jax
import numpy as np
import pytest
import torch

from hifigan_tpu.distill.model import DistillModels as JaxDistillModels
from hifigan_tpu.distill.sniffer import LabelBiasSnifferTrainer as JaxSnifferTrainer
from hifigan_tpu.distill.sniffer import cross_entropy_as_logits as jax_ce
from hifigan_tpu.distill.sniffer import generate_sniffers_by_example as jax_sniffers
from hifigan_tpu.distill.train import DistillTrainer as JaxDistillTrainer
from hifigan_tpu.dsl.parsing import parse_layers as jparse
from hifigan_tpu_torch.distill.model import DistillModels
from hifigan_tpu_torch.distill.sniffer import (
    LabelBiasSnifferTrainer,
    cross_entropy_as_logits,
    generate_sniffers_by_example,
)
from hifigan_tpu_torch.distill.train import DistillTrainer
from hifigan_tpu_torch.dsl.parsing import parse_layers
from hifigan_tpu_torch.train.checkpoint import (
    distill_variables_from_jax,
    dsl_state_dict_from_jax,
    dsl_variables_to_jax,
    load_distill_variables,
)
from tests.test_torch_distill import _batch, _config, _flat
from tests.torch_port_helpers import CHEAP_CODEGEN, leaves, run_cheap

RTOL = 1e-5
WAV_ATOL = 2e-4


@pytest.fixture(scope="module")
def evals():
    cfg, labels, weights = _config()
    jm = JaxDistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                          member_impl="interpret")
    jt = JaxDistillTrainer(jm, cfg)
    seg = cfg["loops"]["train"]["segment_length"]
    jstate = run_cheap(lambda key: jt.create_state(key, seg), jax.random.PRNGKey(3))
    batch = _batch(cfg, labels, jm.embedding_size, 8)
    key = jax.random.PRNGKey(9)
    compiled = jt.make_eval_step().lower(jstate, batch, key).compile(
        compiler_options=CHEAP_CODEGEN)
    jl, jdata = compiled(jstate, batch, key)
    models = DistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"], device="cpu")
    models.build(seg)
    load_distill_variables(models, distill_variables_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.variables)))
    trainer = DistillTrainer(models, cfg)
    state = trainer.create_state(build=False)
    bufs = {k: v.clone() for k, v in models.discriminator.named_buffers()}
    tl, tdata = trainer.make_eval_step()(state, batch)
    return {"jax": (jax.tree_util.tree_map(np.asarray, jl),
                    jax.tree_util.tree_map(np.asarray, jdata)),
            "port": (tl, tdata), "models": models, "bufs": bufs}


def test_eval_losses_match_jax(evals):
    want, got = _flat(evals["jax"][0]), _flat(evals["port"][0])
    assert set(want) == set(got) and len(want) > 40
    for k, v in want.items():
        assert abs(got[k] - v) <= RTOL * abs(v) + 1e-7, (k, got[k], v)


@pytest.mark.parametrize("part", ["wav", "mel", "label"])
def test_eval_data_tree_matches_jax(evals, part):
    want, got = evals["jax"][1][part], evals["port"][1][part]
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, got, is_leaf=torch.is_tensor))
    w, g = jax.tree_util.tree_leaves(want), leaves(got)
    assert len(w) == len(g) > 1
    for a, b in zip(w, g):
        b = b.detach().numpy()
        assert a.shape == b.shape
        atol = WAV_ATOL if part == "wav" else RTOL * max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_eval_step_changes_no_state(evals):
    live = dict(evals["models"].discriminator.named_buffers())
    assert all(torch.equal(v, live[k]) for k, v in evals["bufs"].items())
    assert not evals["port"][1]["wav"]["generated"].requires_grad


def test_cross_entropy_as_logits_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.dirichlet(np.ones(5), (2, 7)).astype(np.float32)
    t = rng.integers(0, 5, (2, 7))
    np.testing.assert_allclose(float(cross_entropy_as_logits(torch.from_numpy(x),
                                                             torch.from_numpy(t))),
                               float(jax_ce(jax.numpy.asarray(x), jax.numpy.asarray(t))),
                               rtol=RTOL)


def test_sniffer_trainer_matches_jax():
    """Two train steps (loss, updated parameters) and one eval step of the
    content sniffer from the same weights."""
    cfg, labels, _ = _config()
    layers = cfg["models"]["sniffers"]["layers"]
    rng = np.random.default_rng(4)
    batch = {"time_labels": {g: {k: rng.integers(0, len(v), (3, 12)) for k, v in group.items()}
                             for g, group in labels.items()}}
    conf = {"learning_rate": 0.01, "lr_decay": 0.9, "adam_b1": 0.8, "adam_b2": 0.99}
    jt = JaxSnifferTrainer(jax_sniffers(labels, layers=jparse(layers))["content"], "content", conf)
    jstate = jt.create_state(jax.random.PRNGKey(1), batch["time_labels"]["content"])
    start = jax.tree_util.tree_map(np.asarray, jstate.variables)
    tt = LabelBiasSnifferTrainer(generate_sniffers_by_example(
        labels, layers=parse_layers(layers))["content"], "content", conf)
    state = tt.create_state(batch["time_labels"]["content"])
    tt.sniffer.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                                for k, v in dsl_state_dict_from_jax(start).items()})
    jstep, step = jax.jit(jt.make_train_step()), tt.make_train_step()
    for i in range(2):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL,
                                   err_msg=f"step {i + 1}")
    assert state.step == int(jstate.step) == 2
    want = jax.tree_util.tree_map(np.asarray, jstate.variables["params"])
    got = dsl_variables_to_jax(tt.sniffer.state_dict())["params"]
    moved = 0
    for (path, a), b, a0 in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got),
                                jax.tree_util.tree_leaves(start["params"])):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=jax.tree_util.keystr(path))
        moved += not np.array_equal(a, a0)
    assert moved == len(jax.tree_util.tree_leaves(want))
    jl, jp = jax.jit(jt.make_eval_step())(jstate, batch)
    tl, tp = tt.make_eval_step()(state, batch)
    np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=RTOL)
    for a, b in zip(jax.tree_util.tree_leaves(jp), leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=RTOL * np.abs(np.asarray(a)).max())
