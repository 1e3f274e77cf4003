"""The port's distillation entry point (``distill/main.py``) against the JAX
one, on the CPU, on the corpus of ``tests/test_data_engine.py`` and the
``small_distill_config()`` of ``tests/test_distill_main.py``:

- both trainers start from one state: the JAX ``initialize`` draws it and
  its ``save_distill_state`` writes it as ``checkpoints/latest`` into both
  experiment directories, so each ``train()`` resumes from it at step 0;
- ``train()`` runs 2 steps on each side with a recording writer: the same
  scalar, text, histogram, figure and audio tags, and every logged loss
  within the step tolerance of ``tests/test_torch_distill.py``;
- the experiment directory's files are the JAX trainer's (the YAML as
  text);
- the port's state after the run, written by the port, loads into the JAX
  ``load_distill_state`` leaf for leaf (optimizer moments included); the
  JAX state after its run loads into the port, and one more step on each
  side gives the same losses;
- the ``train_sniffers`` and ``warm_cache`` CLIs on the corpus.

The JAX steps are compiled with the backend's cheap codegen
(``torch_port_helpers.CHEAP_CODEGEN``)."""

import copy
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from hifigan_tpu.distill import main as jmain
from hifigan_tpu.distill.train import DistillTrainer as JaxDistillTrainer
from hifigan_tpu_torch.distill import main as tmain
from hifigan_tpu_torch.train.checkpoint import distill_train_state_to_jax
from tests.test_data_engine import AUG_CONFIG, SR, corpus, make_dataset  # noqa: F401
from tests.test_distill_main import small_distill_config
from tests.test_torch_data_engine import port_dataset
from tests.torch_port_helpers import CHEAP_CODEGEN

LOSS_RTOL = 1e-4  # tests/test_torch_distill.py's step tolerance


class RecordingWriter:
    def __init__(self):
        self.scalars, self.texts = {}, {}
        self.figures, self.audio, self.hists = [], [], []

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((float(value), step))

    def add_text(self, tag, text, step):
        self.texts[tag] = text

    def add_figure(self, tag, fig, step):
        self.figures.append((tag, fig))

    def add_audio(self, tag, wav, step, sr):
        self.audio.append(tag)

    def add_histogram(self, tag, values, step):
        self.hists.append(tag)


_COMPILED: dict = {}


def _cheap_jit(make):
    """A trainer step factory whose jitted step compiles with cheap codegen,
    once for the file: every trainer here has the same config, so one
    executable serves them all."""

    def factory(self, *args, **kw):
        jitted = make(self, *args, **kw)

        def call(*a):
            key = (make.__name__, jax.tree_util.tree_structure(a))
            if key not in _COMPILED:
                _COMPILED[key] = jitted.lower(*a).compile(compiler_options=CHEAP_CODEGEN)
            return _COMPILED[key](*a)

        return call

    return factory


def _recording_moments(make, log: list):
    """``make_train_step`` whose steps append the JAX optimizer states'
    first moments (flattened, on the host) to ``log``."""

    def factory(self, *args, **kw):
        step = make(self, *args, **kw)

        def call(*a):
            from flax import serialization

            out = step(*a)
            flat = _flat(serialization.to_state_dict(out[0].opt_states))
            log.append({k: v.copy() for k, v in flat.items() if "/inner_state/0/mu/" in k})
            return out

        return call

    return factory


def _cheap_create_state(create):
    """``DistillTrainer.create_state`` jitted with cheap codegen, compiled
    once for the file."""

    def factory(self, key, segment_length):
        ck = ("create_state", segment_length)
        if ck not in _COMPILED:
            fn = jax.jit(lambda k: create(self, k, segment_length))
            _COMPILED[ck] = fn.lower(key).compile(compiler_options=CHEAP_CODEGEN)
        return _COMPILED[ck](key)

    return factory


def _config():
    config = small_distill_config()
    config["experiment"]["overwrite"] = False
    return config


def _datasets(corpus, cache, side):  # noqa: F811
    """Deterministic items (seeded by position), so both sides train on the
    same batches."""
    make = make_dataset if side == "jax" else port_dataset
    return {"train": make(corpus, cache_dir=cache, deterministic=True),
            "validation": make(corpus, cache_dir=cache, deterministic=True)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _assert_losses_close(want: dict, got: dict):
    want, got = _flat(want), _flat(got)
    assert set(want) == set(got)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= LOSS_RTOL * abs(float(v)) + 1e-7, (k, got[k], v)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("distill_main")
    mp = pytest.MonkeyPatch()
    jax_moments: list = []
    mp.setattr(JaxDistillTrainer, "make_train_step",
               _recording_moments(_cheap_jit(JaxDistillTrainer.make_train_step), jax_moments))
    mp.setattr(JaxDistillTrainer, "make_eval_step", _cheap_jit(JaxDistillTrainer.make_eval_step))
    mp.setattr(JaxDistillTrainer, "create_state", _cheap_create_state(JaxDistillTrainer.create_state))
    # the figures as (kind, data shape): drawing ~70 of them a side would
    # take ~10 s (the drawing is tests/test_torch_callbacks.py's)
    import hifigan_tpu.callbacks.visualization as jvis
    import hifigan_tpu.utils.plotting as jplot
    import hifigan_tpu_torch.callbacks.visualization as tvis
    import hifigan_tpu_torch.utils.plotting as tplot

    for mod in (jvis, tvis):
        for name in ("plot_spectrogram", "plot_categorical", "plot_matrix"):
            mp.setattr(mod, name, lambda a, name=name: (name, np.shape(a)))
    for mod in (jplot, tplot):
        mp.setattr(mod, "plot_image", lambda a: ("plot_image", np.shape(a)))
    try:
        config = _config()
        jds = _datasets(corpus, str(root / "jax_cache"), "jax")
        tds = _datasets(corpus, str(root / "port_cache"), "port")
        _, jtrainer, jloop = jmain.initialize(config, jds, logs_base=str(root / "init"),
                                              mesh=None)
        for side in ("jax", "port"):
            ck = root / side / "test_exp" / "version_1" / "checkpoints"
            ck.mkdir(parents=True)
            jmain.save_distill_state(str(ck / "latest"), jloop.state)
        writers = {"jax": RecordingWriter(), "port": RecordingWriter()}
        jstate = jmain.train(config, jds, logs_base=str(root / "jax"), max_steps=2,
                             writer=writers["jax"], mesh=None)
        jax_moments = jax_moments[:2]
        tstate = tmain.train(config, tds, logs_base=str(root / "port"), max_steps=2,
                             writer=writers["port"], device="cpu")

        # one more step on each side from the JAX state after step 2
        batch = next(jds["train"].batches(3, seed=11))
        batch = {k: batch[k] for k in ("audio", "time_labels")}
        j3, jlosses3 = jtrainer.make_train_step(donate=False)(jstate, batch,
                                                              jax.random.PRNGKey(0))
        jpath = str(root / "jax_step2")
        jmain.save_distill_state(jpath, jstate)
        tmodels, ttrainer, tloop = tmain.initialize(config, tds, logs_base=str(root / "port3"),
                                                    device="cpu")
        tmain.load_distill_state(jpath, tloop.state)
        t3, tlosses3 = ttrainer.make_train_step()(tloop.state, batch)

        # the port's state after step 2 (re-read, as the port wrote it) into JAX
        ppath = str(root / "port_step2")
        port_tree = distill_train_state_to_jax(tstate)
        tmain.save_distill_state(ppath, tstate)
        tmain.load_distill_state(ppath, tstate)
        jax_loaded = jmain.load_distill_state(ppath, jloop.state)
    finally:
        mp.undo()
    from flax import serialization

    return {"root": root, "writers": writers, "config": config, "jds": jds, "tds": tds,
            "jstate": jstate, "tstate": tstate, "jlosses3": jlosses3, "tlosses3": tlosses3,
            "jax_loaded": serialization.to_state_dict(jax_loaded), "port_tree": port_tree,
            "j3_step": int(j3.step), "t3_step": t3.step, "jax_moments": jax_moments}


def test_train_steps_both_sides_to_step_two(runs):
    assert int(runs["jstate"].step) == runs["tstate"].step == 2


def test_logged_tags_match_jax(runs):
    jw, tw = runs["writers"]["jax"], runs["writers"]["port"]
    assert set(tw.scalars) == set(jw.scalars)
    assert any(t.startswith("train_losses") for t in tw.scalars)
    assert any(t.startswith("validation_losses") for t in tw.scalars)
    assert set(tw.texts) == set(jw.texts) and tw.texts
    assert sorted(tw.hists) == sorted(jw.hists)
    assert sorted(tw.figures) == sorted(jw.figures)
    assert sorted(tw.audio) == sorted(jw.audio)


def test_logged_losses_match_jax(runs):
    """Every logged loss, step by step (train at steps 1 and 2, the sanity
    validation at step 0), within the step tolerance."""
    jw, tw = runs["writers"]["jax"], runs["writers"]["port"]
    for tag, series in jw.scalars.items():
        got = tw.scalars[tag]
        assert [s for _, s in got] == [s for _, s in series], tag
        for (a, _), (b, _) in zip(series, got):
            assert abs(b - a) <= LOSS_RTOL * abs(a) + 1e-7, (tag, b, a)


def test_model_summaries_match_jax(runs):
    jw, tw = runs["writers"]["jax"], runs["writers"]["port"]
    for tag, text in jw.texts.items():
        assert tw.texts[tag] == text, tag


def test_experiment_directory_matches_jax(runs):
    jdir = runs["root"] / "jax" / "test_exp" / "version_1"
    tdir = runs["root"] / "port" / "test_exp" / "version_1"
    for rel in ("config.yaml", "model_configs/encoder.yaml", "model_configs/decoder.yaml",
                "model_configs/discriminator.yaml"):
        assert (tdir / rel).read_text() == (jdir / rel).read_text(), rel
    names = {p.name for p in (tdir / "checkpoints").iterdir()}
    assert names == {p.name for p in (jdir / "checkpoints").iterdir()}
    assert {"latest", "best", "best_score.yaml"} <= names
    best = (tdir / "checkpoints" / "best_score.yaml").read_text()
    assert best == yaml.dump(yaml.safe_load(best))
    want = yaml.safe_load((jdir / "checkpoints" / "best_score.yaml").read_text())
    assert abs(yaml.safe_load(best) - want) <= LOSS_RTOL * abs(want)


def test_port_checkpoint_loads_into_jax(runs):
    """Every leaf of the JAX state read from the port's file equals the
    port's state: step, variables, frozen copies, optimizer states
    (count, learning rate, mu, nu, nu_max) and accumulators."""
    want = _flat(runs["port_tree"])
    got = _flat(runs["jax_loaded"])
    assert set(got) == set(want)
    assert any("/opt_states/generator,keepers/inner_state/0/nu_max/" in k for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        assert np.asarray(got[k]).dtype == v.dtype, k


def test_jax_checkpoint_resumes_in_the_port(runs):
    """The JAX state after 2 steps, loaded into the port: the next step's
    losses are JAX's next step's."""
    assert runs["j3_step"] == runs["t3_step"] == 3
    _assert_losses_close(jax.tree_util.tree_map(np.asarray, runs["jlosses3"]),
                         {k: v for k, v in _torch_tree(runs["tlosses3"]).items()})


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tree.detach().numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _near_zero_gradients(runs) -> dict:
    """For every trained leaf (a variables key), the elements whose JAX
    gradient at step 1 or at step 2 is within rounding of zero: at most 8
    fp32 ulps of the leaf's largest gradient at that step. The gradients
    come from the JAX first moments (``mu_1 = (1 - b1) g_1``, ``mu_2 =
    b1 mu_1 + (1 - b1) g_2``; the factor 1 - b1 drops out of the ratio)."""
    b1 = runs["config"]["learning"]["adam_b1"]
    mu1, mu2 = runs["jax_moments"]
    tol = 8 * np.finfo(np.float32).eps
    near = {}
    for k in mu1:
        g1, g2 = mu1[k], mu2[k] - b1 * mu1[k]
        leaf = k.split("/inner_state/0/mu", 1)[1]
        near[leaf] = ((np.abs(g1) <= tol * np.abs(g1).max())
                      | (np.abs(g2) <= tol * np.abs(g2).max()))
    return near


def test_port_state_after_training_is_close_to_jax(runs):
    """The variables after 2 steps: every element within twice the one-step
    bound of ``tests/test_torch_distill.py`` (1e-5), except where the JAX
    gradient at step 1 or 2 is within rounding of zero. There AMSGrad's
    update ``lr mu_hat / (sqrt(nu_hat) + eps)`` with ``|g| ~ eps`` turns
    the gradient's rounding into a change of the update of up to ~lr, so
    those elements are held to two steps of the largest learning rate."""
    want = _flat(jax.tree_util.tree_map(np.asarray, runs["jstate"].variables))
    got = _flat(runs["port_tree"]["variables"])
    assert set(got) == set(want)
    near = _near_zero_gradients(runs)
    lr = max(float(np.max(list(_flat(runs["config"]["learning"]["optimizers"]).values()))), 0)
    trained = 0
    for k, v in want.items():
        diff = np.abs(got[k] - v)
        waived = near.get(k.replace("/params/", "/", 1)) if "/params/" in k else None
        if waived is None:
            assert "/params/" not in k, k  # every parameter has its moments
            waived = np.zeros(v.shape, bool)
        else:
            trained += 1
        assert (diff[~waived] <= 2e-5).all(), (k, diff[~waived].max())
        assert diff.max() <= 2 * lr, (k, diff.max())
    assert trained == len(near)


def test_mesh_other_than_auto_raises(runs):
    with pytest.raises(NotImplementedError, match="A.4"):
        tmain.resolve_mesh(runs["config"], mesh=object())
    assert tmain.resolve_mesh(runs["config"], "auto") is None


def test_train_sniffers_cli_matches_jax_layout(runs, corpus, tmp_path):  # noqa: F811
    """The port's ``train_sniffers`` on the corpus (with a test split), a
    few steps per key: checkpoints under ``<logs>/sniffers/<key>``, which
    the JAX sniffer trainer's loader reads."""
    from hifigan_tpu.cli.train_sniffers import DEFAULT_SNIFFER_LAYERS as JLAYERS
    from hifigan_tpu_torch.cli import train_sniffers

    assert train_sniffers.DEFAULT_SNIFFER_LAYERS == JLAYERS
    data = Path(corpus["data"]) / "mini" / "data_configs"
    (data / "test").mkdir(exist_ok=True)
    (data / "test" / "mini.json").write_text((data / "train" / "mini.json").read_text())
    datasets_dir = tmp_path / "datasets"
    datasets_dir.mkdir()
    for name in ("data", "aug"):
        os.symlink(Path(corpus[name]), datasets_dir / name)
    for source in ("train", "test"):  # the label scans in this process, not a pool
        port_dataset(dict(corpus, cache=str(datasets_dir / "cache")), source=source,
                     disable_wavs=True)
    logs = tmp_path / "logs"
    train_sniffers.main(["--datasets_dir", str(datasets_dir), "--logs_base", str(logs),
                         "--max_steps", "3", "--batch_size", "2", "--device", "cpu",
                         "--config", str(_write_config(tmp_path, runs["config"]))])
    for key in ("content", "style"):
        ck = logs / "sniffers" / key / "default" / "version_1" / "checkpoints"
        assert (ck / "best").exists() and (ck / "best_score.yaml").exists()
        from hifigan_tpu.distill.sniffer import LabelBiasSnifferTrainer, \
            generate_sniffers_by_example
        from hifigan_tpu.dsl.parsing import parse_layers

        jds = runs["jds"]["train"]
        layers = runs["config"]["models"]["sniffers"]["layers"]  # the CLI's, from the config
        sniffer = generate_sniffers_by_example(jds.label_options_groups,
                                               layers=parse_layers(layers))[key]
        trainer = LabelBiasSnifferTrainer(sniffer, key)
        example = next(jds.batches(2))["time_labels"][key]
        template = jax.eval_shape(lambda k: trainer.create_state(k, example),
                                  jax.random.PRNGKey(0))
        loaded = jmain.load_distill_state(str(ck / "best"), template)
        assert int(loaded.step) in (2, 3)
        for t, v in zip(jax.tree_util.tree_leaves(template), jax.tree_util.tree_leaves(loaded)):
            assert np.shape(v) == t.shape and np.asarray(v).dtype == t.dtype


def _write_config(tmp_path, config):
    import json

    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(config, augmentation=AUG_CONFIG)))
    return path


def test_warm_cache_cli_on_the_corpus(corpus, tmp_path, runs):  # noqa: F811
    """``warm_cache`` writes one label pickle per item of every loop."""
    from hifigan_tpu_torch.cli import warm_cache

    datasets_dir = tmp_path / "datasets"
    datasets_dir.mkdir()
    for name in ("data", "aug"):
        os.symlink(Path(corpus[name]), datasets_dir / name)
    config = copy.deepcopy(runs["config"])
    config["data"] = {"train": {"dataset": {"source": "train"}},
                      "validation": {"dataset": {"source": "train", "deterministic": True,
                                                 "size": 2}}}
    warm_cache.main(["--datasets_dir", str(datasets_dir), "--workers", "1", "--iterate", "1",
                     "--config", str(_write_config(tmp_path, config))])
    assert len(list((datasets_dir / "cache" / "train" / "frame_labels").glob("*.pickle"))) == 4


def test_async_checkpoint_copies_arrays_that_view_parameters():
    """A CPU state's JAX-layout tree holds arrays that view the parameters;
    the asynchronous write takes copies, so a step taken meanwhile cannot
    reach the file."""
    from hifigan_tpu_torch.train.checkpoint import _host_copy

    param = torch.zeros(3)
    tree = {"v": {"kernel": param.numpy().T}}
    held = _host_copy(tree)
    param.add_(1.0)
    np.testing.assert_array_equal(held["v"]["kernel"], np.zeros(3))
