"""Distillation training orchestration (port of ``hifigan_tpu/distill/main.py``).

- Experiment/log-dir contract: `<logs_base>/<name>/version_<v>` with
  overwrite/copy-from semantics and the config cached to config.yaml
  (ref create_config, lightning_model.py:754-799).
- Model assembly from declarative configs with every generated module
  config cached to model_configs/*.yaml (ref create_models, :802-922) and
  a parameter summary per model.
- The callback stack: continuous/history/best checkpoints, interval loss
  sums -> TB scalars, validation classification/visualisation, model-graph
  text (ref create_trainer, :925-956).

The experiment directory is the JAX trainer's: the same files, the YAML
written as PyYAML writes it, and ``checkpoints/{latest,best,step_N}`` the
flax msgpack of the whole train state in the JAX trainer's layout
(``train/checkpoint.py::distill_train_state_to_jax``). So either trainer
resumes a directory the other wrote. A checkpoint is copied to the host
when it is taken and written on a background thread
(``train/checkpoint.py::save_checkpoint(async_=True)``); loading one, and
the end of :func:`train`, wait for every write.

Single device only: ``mesh=None`` and ``'auto'`` train on one device; an
explicit mesh raises (data parallelism is a later slice of the port).
Runs on CUDA unless ``device``/``--device`` names another device::

    python -m hifigan_tpu_torch.distill.main --datasets_dir DATASETS --max_steps 1000
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from hifigan_tpu_torch.callbacks import (
    BestCheckpointCallback,
    ContinuousCheckpointCallback,
    HistoryCheckpointCallback,
    ModelGraphVisualizationCallback,
    OutputLoggingCallback,
    OutputSumCallback,
    TrainLoop,
    ValidationClassificationCallback,
    ValidationVisualizationCallback,
)
from hifigan_tpu_torch.callbacks.visualization import leaves_with_path, state_variables
from hifigan_tpu_torch.distill.model import DistillModels
from hifigan_tpu_torch.distill.train import DistillTrainer
from hifigan_tpu_torch.train.checkpoint import (
    distill_train_state_to_jax,
    load_distill_train_state,
    load_sniffer_state,
    save_checkpoint,
    sniffer_state_to_jax,
    wait_for_checkpoints,
)
from hifigan_tpu_torch.train.msgpack import msgpack_restore
from hifigan_tpu_torch.utils.caching import do_and_cache
from hifigan_tpu_torch.utils.pytree import detach_recursively, restack_legacy_ensembles

DEFAULT_LOGS_BASE = "logs"
BATCH_KEYS = ("audio", "time_labels")


def experiment_log_dir(config: dict, logs_base: str = DEFAULT_LOGS_BASE) -> str:
    """TensorBoardLogger directory contract incl. overwrite/copy
    (ref lightning_model.py:766-799)."""
    experiment = config["experiment"]
    log_dir = Path(logs_base) / experiment["name"] / f"version_{experiment['version']}"

    source_dir = log_dir
    if experiment.get("copy", {}).get("enabled", False):
        if log_dir.exists() and not experiment.get("overwrite", False):
            raise RuntimeError("Cannot copy into existing version when overwrite is false.")
        copy_cfg = experiment["copy"]
        source_dir = (
            Path(logs_base)
            / copy_cfg.get("name", experiment["name"])
            / f"version_{copy_cfg.get('version', experiment['version'])}"
        )
    if experiment.get("overwrite", False) and log_dir.exists():
        shutil.rmtree(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    do_and_cache(
        lambda: config,
        os.path.join(log_dir, "config.yaml"),
        os.path.join(source_dir, "config.yaml"),
    )
    return str(log_dir)


# ---------------------------------------------------------------------------
# state (de)serialisation
# ---------------------------------------------------------------------------


def _state_tree(state) -> dict:
    if hasattr(state, "models"):
        return distill_train_state_to_jax(state)
    return sniffer_state_to_jax(state)


def save_distill_state(path: str, state) -> None:
    """The train state (a ``DistillTrainState`` or a ``SnifferTrainState``)
    as the flax msgpack the JAX trainer writes; copied to the host now,
    written atomically on the checkpoint thread."""
    save_checkpoint(path, _state_tree(state), async_=True, encoding="msgpack")


def load_distill_state(path: str, template):
    """Load a checkpoint (either trainer's) into ``template`` in place."""
    wait_for_checkpoints()
    with open(path, "rb") as f:
        restored = msgpack_restore(f.read())
    # migrate checkpoints saved by the pre-vmap (unrolled-ensemble) layout
    restored = restack_legacy_ensembles(restored, _state_tree(template))
    if hasattr(template, "models"):
        return load_distill_train_state(template, restored)
    return load_sniffer_state(template, restored)


# ---------------------------------------------------------------------------
# model summaries (torchsummary replacement, ref :841-920)
# ---------------------------------------------------------------------------


def summarize_params(name: str, variables: Any) -> str:
    """Parameter summary of JAX-layout variables (``{'params': ...}``)."""
    lines = [f"{name}:"]
    total = 0
    params = variables.get("params", variables)
    for path, leaf in leaves_with_path(params):
        keys = "/".join(str(p) for p in path)
        shape = tuple(np.shape(leaf))
        n = int(np.prod(shape)) if shape else 1
        total += n
        lines.append(f"  {keys}: {shape} = {n}")
    lines.append(f"  TOTAL: {total} params")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# end-to-end assembly
# ---------------------------------------------------------------------------


def resolve_mesh(config: dict, mesh="auto"):
    """Single-device: None and 'auto' give None; a mesh raises."""
    if mesh is None:
        return None
    if isinstance(mesh, str) and mesh == "auto":
        if torch.cuda.device_count() > 1:
            print(f"distill: {torch.cuda.device_count()} devices visible; the port trains "
                  "on one (data parallelism is not ported yet)")
        return None
    raise NotImplementedError("distill: a device mesh is not ported yet (ROADMAP A.4); "
                              "pass mesh=None or 'auto'")


def initialize(config: dict, datasets: dict, logs_base: str = DEFAULT_LOGS_BASE,
               cache_model_configs: bool = True, writer=None, mesh="auto", device=None):
    """config + {loop: dataset} -> (models, trainer, loop) ready to run.

    Datasets must expose `label_options_groups` / `label_weights_groups`
    and a `batches()` iterator (MultilabelWaveDataset does). ``device``:
    default CUDA (raises without a GPU)."""
    log_dir = experiment_log_dir(config, logs_base)
    resolve_mesh(config, mesh)

    train_ds = datasets["train"]
    example = train_ds.label_options_groups
    weights = train_ds.label_weights_groups

    models = DistillModels(config, example, weights, sampling_rate=config["sampling_rate"],
                           device=device)
    if cache_model_configs:
        # cache every generated module config for reproducibility (ref :888-914)
        cfg_dir = Path(log_dir) / "model_configs"
        cfg_dir.mkdir(parents=True, exist_ok=True)
        do_and_cache(lambda: repr(models.encoder.config), str(cfg_dir / "encoder.yaml"))
        do_and_cache(lambda: repr(models.decoder.config), str(cfg_dir / "decoder.yaml"))
        do_and_cache(lambda: repr(models.discriminator.config), str(cfg_dir / "discriminator.yaml"))

    trainer = DistillTrainer(models, config)
    state = trainer.create_state(seed=config.get("seed", 1234))

    intervals = {
        "train": config["learning"]["accumulated_grad_batches"],
        "validation": config["learning"]["accumulated_grad_batches"] * 20,
    }
    best_cb = BestCheckpointCallback()
    summaries = {
        name: summarize_params(name, vs)
        for name, vs in state_variables(state).items()
        if isinstance(vs, dict) and "params" in vs
    }
    callbacks = [
        HistoryCheckpointCallback(),
        ContinuousCheckpointCallback(intervals["validation"]),
        best_cb,
        OutputSumCallback(intervals, reset_callbacks=[OutputLoggingCallback(), best_cb]),
        ValidationVisualizationCallback(config["sampling_rate"], config.get("visualize", 1)),
        ModelGraphVisualizationCallback(summaries),
        ValidationClassificationCallback(example),
    ]
    loop = TrainLoop(
        state=state,
        step_fn=trainer.make_train_step(),
        log_dir=log_dir,
        callbacks=callbacks,
        writer=writer,
        save_state=save_distill_state,
        load_state=load_distill_state,
    )
    return models, trainer, loop


def train(config: dict, datasets: dict, logs_base: str = DEFAULT_LOGS_BASE,
          max_steps: int = 1_000_000, writer=None, rng_seed: int = 0, mesh="auto",
          device=None):
    """Run the full distillation training loop with validation. Noise
    nodes draw from one generator on the models' device, seeded with
    ``rng_seed``."""
    models, trainer, loop = initialize(config, datasets, logs_base, writer=writer, mesh=mesh,
                                       device=device)
    eval_step = trainer.make_eval_step()
    val_interval = config["learning"]["accumulated_grad_batches"] * 20
    batch_size = config["loops"]["train"]["batch_size"]
    gen = torch.Generator(device=models.device).manual_seed(rng_seed)

    def validate(batches):
        for vb in batches:
            vlosses, vextra = eval_step(loop.state, {k: vb[k] for k in BATCH_KEYS}, gen)
            loop.fire("on_validation_batch_end", vlosses, detach_recursively(vextra, cpu=True))
        loop.fire("on_validation_end")

    # sanity validation at train start (the reference's GlobalSyncCallback
    # re-runs the sanity check manually, global_sync_callback.py:64-71)
    if loop.global_step == 0 and "validation" in datasets and config.get("visualize", 1):
        # num_sanity_val_steps = visualize
        validate(b for _, b in zip(range(1), datasets["validation"].batches(batch_size,
                                                                         shuffle=False)))

    epoch = 0
    while loop.global_step < max_steps and not loop.stop_requested:
        for batch in datasets["train"].batches(batch_size, seed=rng_seed + epoch):
            loop.fire("on_step_start")
            loop.state, losses = loop.step_fn(loop.state, {k: batch[k] for k in BATCH_KEYS}, gen)
            loop.fire("on_step_end", losses)
            step_count = loop.global_step
            if step_count % val_interval == 0 and "validation" in datasets:
                validate(datasets["validation"].batches(batch_size, shuffle=False))
            if step_count >= max_steps:
                break
        epoch += 1
    wait_for_checkpoints()
    return loop.state


def build_datasets(config: dict, datasets_dir: str) -> dict:
    """One ``MultilabelWaveDataset`` per loop of ``config`` over
    ``<datasets_dir>/{data,aug,cache}``."""
    from hifigan_tpu_torch.data.multilabel import MultilabelWaveDataset
    from hifigan_tpu_torch.distill.model import embedding_size_from_layers
    from hifigan_tpu_torch.dsl.parsing import parse_layers

    embedding_size = embedding_size_from_layers(
        parse_layers(config["models"]["generator"]["layers"])
    )
    return {
        key: MultilabelWaveDataset(
            data_dir=f"{datasets_dir}/data",
            aug_dir=f"{datasets_dir}/aug",
            cache_dir=f"{datasets_dir}/cache",
            name=key,
            segment_length=config["loops"][key]["segment_length"],
            sampling_rate=config["sampling_rate"],
            embedding_size=embedding_size,
            augmentation_config=config["augmentation"],
            **config["data"][key]["dataset"],
        )
        for key in config["loops"]
    }


def summary_writer_class():
    """``torch.utils.tensorboard.SummaryWriter``, or None (with a note)
    where it does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as err:
        print(f"no TensorBoard writer ({err}): training without one")
        return None
    return SummaryWriter


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--config",
        default=str(Path(__file__).resolve().parents[2] / "configs" / "distill.json"),
        help="distillation config (default: the shipped production configs/distill.json)",
    )
    parser.add_argument("--datasets_dir", default="/datasets")
    parser.add_argument("--logs_base", default=DEFAULT_LOGS_BASE)
    parser.add_argument("--max_steps", default=1_000_000, type=int)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = parser.parse_args(argv)

    with open(a.config) as f:
        config = json.load(f)
    datasets = build_datasets(config, a.datasets_dir)
    writer_class = summary_writer_class()
    writer = writer_class(experiment_log_dir(config, a.logs_base)) if writer_class else None
    state = train(config, datasets, a.logs_base, max_steps=a.max_steps, writer=writer,
                  device=a.device)
    if writer is not None:
        writer.close()  # the events on disk before the process ends
    print(f"distill: trained to step {state.step}")


if __name__ == "__main__":
    main()
