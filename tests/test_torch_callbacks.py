"""The port's callbacks against the JAX package's, on the CPU: interval loss
sums on a scripted loss sequence (same tags, same values), the continuous,
history and best checkpoints (write and resume, ``best_score.yaml`` as the
text PyYAML writes, read by either side), the validation confusion
matrices, and the YAML writer's folding of long strings."""

import numpy as np
import pytest
import torch
import yaml

from hifigan_tpu.callbacks import checkpoints as jck
from hifigan_tpu.callbacks import logging as jlog
from hifigan_tpu.callbacks import visualization as jvis
from hifigan_tpu.callbacks.base import TrainLoop as JaxTrainLoop
from hifigan_tpu_torch.callbacks import checkpoints as tck
from hifigan_tpu_torch.callbacks import logging as tlog
from hifigan_tpu_torch.callbacks import visualization as tvis
from hifigan_tpu_torch.callbacks.base import TrainLoop
from hifigan_tpu_torch.utils.caching import dump_yaml, load_yaml
from tests.test_torch_distill_main import RecordingWriter


class State:
    def __init__(self, step=0, value=0.0):
        self.step, self.value = step, value


def _losses(rng):
    return {"generator": {"wav": rng.random(), "mel": [rng.random(), rng.random()]},
            "discriminator": rng.random() - 0.5}


def _run_sums(side, steps, intervals):
    """Drive OutputSumCallback + OutputLoggingCallback through ``steps``
    train steps and a validation pass of 3 batches; returns the writer."""
    mod, loop_cls = (jlog, JaxTrainLoop) if side == "jax" else (tlog, TrainLoop)
    writer = RecordingWriter()
    cb = mod.OutputSumCallback(intervals, reset_callbacks=[mod.OutputLoggingCallback()])
    import tempfile

    loop = loop_cls(State(), None, tempfile.mkdtemp(), callbacks=[cb], writer=writer)
    rng = np.random.default_rng(0)

    def leaf(x):
        return np.float32(x) if side == "jax" else torch.tensor(np.float32(x))

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return leaf(t)

    for _ in range(steps):
        loop.state.step += 1
        loop.fire("on_step_end", tree(_losses(rng)))
    for _ in range(3):
        loop.fire("on_validation_batch_end", tree(_losses(rng)), None)
    loop.fire("on_validation_end")
    return writer


@pytest.mark.parametrize("intervals", [{"train": 1, "validation": 20},
                                       {"train": 3, "validation": 5}])
def test_interval_sums_log_the_jax_tags_and_values(intervals):
    want = _run_sums("jax", 10, intervals)
    got = _run_sums("port", 10, intervals)
    assert set(got.scalars) == set(want.scalars)
    assert "train_losses_4/generator/mel/1" in got.scalars
    assert "validation_losses_2/discriminator" in got.scalars
    for tag, series in want.scalars.items():
        assert got.scalars[tag] == series, tag


def test_sums_stay_on_the_device_until_a_reset(monkeypatch):
    """A step's losses are added where they are; the host reads the sums
    once an interval, through one stacked copy."""
    reads = []
    real = tlog._DeviceSum.read
    monkeypatch.setattr(tlog._DeviceSum, "read", lambda self: reads.append(1) or real(self))
    _run_sums("port", 9, {"train": 3, "validation": 100})
    assert len(reads) == 3 + 1  # three train intervals, one validation pass


def _checkpoint_loop(side, log_dir, interval, saved):
    mod, loop_cls = (jck, JaxTrainLoop) if side == "jax" else (tck, TrainLoop)
    best = mod.BestCheckpointCallback()
    sums = (jlog if side == "jax" else tlog).OutputSumCallback(
        {"train": interval, "validation": interval}, reset_callbacks=[best])

    def save(path, state):
        saved.append((path, state.step))
        with open(path, "w") as f:
            f.write(f"{state.step} {state.value}")

    def load(path, state):
        step, value = open(path).read().split()
        return State(int(step), float(value))

    loop = loop_cls(State(), None, str(log_dir),
                    callbacks=[mod.HistoryCheckpointCallback(4),
                               mod.ContinuousCheckpointCallback(interval), best, sums],
                    save_state=save, load_state=load)
    return loop


@pytest.mark.parametrize("writer_side,reader_side", [("port", "port"), ("port", "jax"),
                                                     ("jax", "port")])
def test_checkpoints_write_and_resume(tmp_path, writer_side, reader_side):
    saved = []
    loop = _checkpoint_loop(writer_side, tmp_path, 2, saved)
    for step, val_loss in ((1, None), (2, 0.75), (3, None), (4, 0.5), (5, None), (6, 0.625)):
        loop.state = State(step, step * 0.5)
        loop.fire("on_step_end", {"x": np.float32(1.0) if writer_side == "jax"
                                  else torch.tensor(1.0)})
        if val_loss is not None:
            loss = np.float32(val_loss) if writer_side == "jax" else torch.tensor(val_loss)
            loop.fire("on_validation_batch_end", {"a": loss, "b": loss}, None)
            loop.fire("on_validation_end")
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["best", "best_score.yaml", "latest", "step_4"]
    text = (tmp_path / "checkpoints" / "best_score.yaml").read_text()
    assert text == yaml.dump(1.0) and load_yaml(text) == 1.0
    assert [s for p, s in saved if p.endswith("best")] == [2, 4]
    resumed = _checkpoint_loop(reader_side, tmp_path, 2, [])
    assert resumed.state.step == 6 and resumed.callbacks[2].current_best == 1.0


def test_confusion_matrices_match_jax():
    options = {"content": {"speaker": ("none", "a", "b"), "sad": ("none", "x")}}
    writers = {}
    for side, mod in (("jax", jvis), ("port", tvis)):
        cb = mod.ValidationClassificationCallback(options)
        loop = type("L", (), {"writer": RecordingWriter(), "global_step": 7})()
        gen = np.random.default_rng(2)
        for _ in range(3):
            truth = {"content": {"speaker": gen.integers(0, 3, (2, 5)),
                                 "sad": gen.integers(0, 2, (2, 5))}}
            preds = {"content": {"speaker": gen.random((2, 5, 3)), "sad": gen.random((2, 5, 2))}}
            cb.on_validation_batch_end(loop, None, {"label": {"truth": truth, "keep": preds,
                                                              "hunt": preds}})
        cb.on_validation_end(loop)
        writers[side] = loop.writer
    assert writers["port"].scalars == writers["jax"].scalars and writers["port"].scalars
    assert [t for t, _ in writers["port"].figures] == [t for t, _ in writers["jax"].figures]


def test_parameter_logging_matches_jax():
    rng = np.random.default_rng(3)
    params = {"m_0_conv": {"kernel": rng.standard_normal((3, 4, 8)).astype(np.float32),
                           "bias": rng.standard_normal(8).astype(np.float32)},
              "m_1_conv": {"kernel": rng.standard_normal((3, 8, 2)).astype(np.float32),
                           "bias": rng.standard_normal(2).astype(np.float32)}}
    variables = {"encoder": {"params": params}, "keepers": {"content": {"params": params}}}
    out = {}
    for side, mod in (("jax", jvis), ("port", tvis)):
        w = RecordingWriter()
        mod.log_model_parameters(w, variables, 3)
        out[side] = w
    assert out["port"].hists == out["jax"].hists and out["port"].hists
    assert [t for t, _ in out["port"].figures] == [t for t, _ in out["jax"].figures]
    assert [f.axes[0].images[0].get_array().shape for _, f in out["port"].figures] == [
        f.axes[0].images[0].get_array().shape for _, f in out["jax"].figures]


LONG = ("('#seq', (('#node', 'conv', (480, 480, 3, 1, 1, 1, 1.0), ()), ('#node', 'lrelu', "
        "0.1, ()))) " * 4)


@pytest.mark.parametrize("value", [
    LONG, LONG.strip(), {"a": LONG.strip()}, [LONG.strip(), {"b": LONG}],
    repr({"layers": [("conv", 6, 3, 1)], "name": "x'y", "k": 1e-05}) * 4, 0.1 + 0.2,
    float("inf"), "a  b " * 30, "x" * 200])
def test_yaml_folds_long_strings_as_pyyaml(value):
    text = yaml.dump(value)
    assert dump_yaml(value) == text
    assert load_yaml(text) == value


def test_plotting_imports_matplotlib_only_to_draw():
    import ast
    import inspect

    from hifigan_tpu_torch.utils import plotting

    tree = ast.parse(inspect.getsource(plotting))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("matplotlib" in ast.dump(n) for n in top)
    pytest.importorskip("matplotlib")
    for fig in (plotting.plot_spectrogram(np.zeros((4, 6))), plotting.plot_matrix(np.eye(3)),
                plotting.plot_categorical(np.arange(6).reshape(2, 3)),
                plotting.plot_image(np.ones((2, 2)))):
        assert fig.axes


def test_figures_are_left_out_without_matplotlib(monkeypatch):
    """Where matplotlib does not import (the card's machine), the callbacks
    log everything but the figures, and draw nothing."""
    from hifigan_tpu_torch.utils import plotting

    monkeypatch.setattr(plotting, "available", lambda: False)
    for name in ("plot_spectrogram", "plot_categorical", "plot_matrix"):
        monkeypatch.setattr(tvis, name, lambda *a: pytest.fail("drew a figure"))
    monkeypatch.setattr(plotting, "plot_image", lambda *a: pytest.fail("drew a figure"))
    rng = np.random.default_rng(4)
    params = {"m_0_conv": {"kernel": rng.standard_normal((3, 4, 8)).astype(np.float32),
                           "bias": rng.standard_normal(8).astype(np.float32)}}
    w = RecordingWriter()
    tvis.log_model_parameters(w, {"encoder": {"params": params}}, 1)
    assert w.hists and not w.figures
    loop = type("L", (), {"writer": RecordingWriter(), "global_step": 1,
                          "state": object()})()
    cb = tvis.ValidationVisualizationCallback(16000)
    cb.on_validation_batch_end(loop, None, {
        "wav": {"truth": np.zeros((1, 32, 1), np.float32)},
        "mel": {"truth": np.zeros((1, 4, 8), np.float32)},
        "label": {"truth": {"content": {"sad": np.zeros((1, 5), np.int64)}}}})
    conf = tvis.ValidationClassificationCallback({"content": {"sad": ("none", "x")}})
    conf.on_validation_batch_end(loop, None, {"label": {
        "truth": {"content": {"sad": np.zeros((1, 5), np.int64)}},
        "keep": {"content": {"sad": np.zeros((1, 5, 2))}}}})
    conf.on_validation_end(loop)
    assert loop.writer.audio and loop.writer.scalars and not loop.writer.figures


def test_snake_images_take_an_ensemble_of_as_many_members_as_channels():
    """A homogeneous ensemble's leaves are stacked over its members: with 3
    members of 3 output channels the JAX function takes the (3, 3) stacked
    bias for a channel bias and raises; the port leaves a stacked bias out,
    as the JAX function does for any other member count."""
    rng = np.random.default_rng(5)
    params = {"m_ens": {"m_0_conv": {"kernel": rng.standard_normal((3, 5, 4, 3)).astype(np.float32),
                                     "bias": rng.standard_normal((3, 3)).astype(np.float32)}}}
    with pytest.raises(ValueError):
        jvis.parameter_snake_images(params)
    images = tvis.parameter_snake_images(params)
    assert list(images) == ["m_ens.m_0_conv"] and images["m_ens.m_0_conv"].shape == (3, 4)
    params["m_ens"]["m_0_conv"]["bias"] = params["m_ens"]["m_0_conv"]["bias"][:, :2]
    params["m_ens"]["m_0_conv"]["kernel"] = params["m_ens"]["m_0_conv"]["kernel"][..., :2]
    for a, b in zip(jvis.parameter_snake_images(params).items(),
                    tvis.parameter_snake_images(params).items()):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
