"""Standalone label-bias sniffer training CLI (port of
``hifigan_tpu/cli/train_sniffers.py``)::

    python -m hifigan_tpu_torch.cli.train_sniffers --datasets_dir DATASETS --max_steps 1000

Parity with reference speech_distillation/label_bias_sniffer.py:91-222
(`main()` + `create_trainer()`): assemble THREE `disable_wavs=True`
MultilabelWaveDataset instances (train / deterministic size-100 validation /
deterministic test), generate one sniffer per label group from the train
set's label examples, print a parameter summary per sniffer (the reference's
torchsummary dump, :156-164), and fit one trainer per sniffer key with the
checkpoint/log callback stack under `<logs_base>/sniffers/<key>` (the
reference's `/mount/sniffers/logs/{key}`, :183).

Divergence (documented): the reference wraps each fit in a Lightning
Trainer with ManualOptimizationCallback(1000/batch_size) gradient
accumulation; this trainer steps the optimizer per batch with the same
AdamW/ExponentialLR hyperparameters — the sniffers are small classifiers
where accumulation was a Lightning-loop artifact, not a modelling choice.

Runs on CUDA unless ``device``/``--device`` names another device. The
checkpoints are the JAX trainer's files (flax msgpack of its
``SnifferTrainState`` layout), so either side resumes the other's.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Any

from hifigan_tpu_torch.callbacks import (
    BestCheckpointCallback,
    ContinuousCheckpointCallback,
    HistoryCheckpointCallback,
    OutputLoggingCallback,
    OutputSumCallback,
    TrainLoop,
)
from hifigan_tpu_torch.callbacks.visualization import state_variables
from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.distill.main import (
    load_distill_state,
    save_distill_state,
    summarize_params,
    summary_writer_class,
)
from hifigan_tpu_torch.distill.sniffer import LabelBiasSnifferTrainer, generate_sniffers_by_example
from hifigan_tpu_torch.train.checkpoint import wait_for_checkpoints

# The reference's main() calls generate_sniffers_by_example with layers=[]
# (label_bias_sniffer.py:84,155), which crashes in get_classifier_backbone
# (static_configs.py:339 indexes layers[0]) — the entry is latently broken,
# like inference_autoencoding (SURVEY §2.5). We default to the shipped
# sniffer backbone from config.models.sniffers.layers instead.
DEFAULT_SNIFFER_LAYERS = ("conv:6,3,1,1,1,1e-00", "conv:x,3,1,1,1,1e-00")


def build_sniffer_datasets(config: dict, datasets_dir: str, embedding_size: int) -> dict:
    """The reference's 3-dataset assembly (label_bias_sniffer.py:102-139):
    all with ``disable_wavs=True`` (zero waveforms; the sniffers consume only
    label tensors), validation deterministic with a 100-item golden-ratio
    subset, test deterministic from the test split."""
    from hifigan_tpu_torch.data.multilabel import MultilabelWaveDataset

    def make(name, source, **over):
        return MultilabelWaveDataset(
            data_dir=f"{datasets_dir}/data",
            aug_dir=f"{datasets_dir}/aug",
            cache_dir=f"{datasets_dir}/cache",
            name=name,
            source=source,
            segment_length=config["segment_length"],
            sampling_rate=config["sampling_rate"],
            embedding_size=embedding_size,
            augmentation_config=config["augmentation"],
            disable_wavs=True,
            **over,
        )

    return {
        "train": make("train", "train"),
        "validation": make("train", "train", deterministic=True, size=100),
        "test": make("test", "test", deterministic=True),
    }


def train_sniffers(
    config: dict,
    datasets: dict,
    logs_base: str,
    max_steps: int = 1_000_000,
    batch_size: int = 5,  # reference label_bias_sniffer.py:100
    writer_factory=None,
    keys: list[str] | None = None,
    layers: tuple = (),
    device=None,
) -> dict[str, Any]:
    """Fit one LabelBiasSnifferTrainer per sniffer key; returns final states."""
    from hifigan_tpu_torch.dsl.parsing import parse_layers

    device = resolve_device(device)
    train_ds = datasets["train"]
    example = train_ds.label_options_groups
    if not layers:
        layer_strs = (
            config.get("models", {}).get("sniffers", {}).get("layers")
            or DEFAULT_SNIFFER_LAYERS
        )
        layers = parse_layers(list(layer_strs))
    sniffers = generate_sniffers_by_example(example, layers=layers)

    interval = max(1, int(1000 / batch_size))  # ref accumulated_grad/intervals
    final_states: dict[str, Any] = {}
    # one dataset materialisation serves every sniffer's shape example
    example_batch = next(datasets["train"].batches(batch_size))
    for key, sniffer in sniffers.items():
        if keys is not None and key not in keys:
            continue
        trainer = LabelBiasSnifferTrainer(sniffer, key)
        state = trainer.create_state(example_batch["time_labels"][key], seed=1234,
                                     device=device)
        print(summarize_params(f"{key} sniffer", state_variables(state)))

        log_dir = os.path.join(logs_base, "sniffers", key, "default", "version_1")
        os.makedirs(log_dir, exist_ok=True)
        writer = writer_factory(log_dir) if writer_factory else None
        best_cb = BestCheckpointCallback()
        loop = TrainLoop(
            state=state,
            step_fn=trainer.make_train_step(),
            log_dir=log_dir,
            callbacks=[
                HistoryCheckpointCallback(),
                ContinuousCheckpointCallback(interval),
                best_cb,
                OutputSumCallback(
                    {"train": interval, "validation": interval},
                    reset_callbacks=[OutputLoggingCallback(), best_cb],
                ),
            ],
            writer=writer,
            save_state=save_distill_state,
            load_state=load_distill_state,
        )
        eval_step = trainer.make_eval_step()

        def labels_only(batches):
            for b in batches:
                yield {"time_labels": b["time_labels"]}

        epoch = 0
        while loop.global_step < max_steps and not loop.stop_requested:
            loop.run(
                labels_only(datasets["train"].batches(batch_size, seed=1234 + epoch)),
                max_steps=max_steps,
            )
            if "validation" in datasets:
                for vb in labels_only(datasets["validation"].batches(batch_size, shuffle=False)):
                    vlosses, _ = eval_step(loop.state, vb)
                    loop.fire("on_validation_batch_end", vlosses, None)
                loop.fire("on_validation_end")
            epoch += 1
        final_states[key] = loop.state
        if writer is not None:
            writer.close()
    wait_for_checkpoints()
    return final_states


def main(argv: list[str] | None = None) -> None:
    print("Initializing Training Process...")
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--config",
        default=str(Path(__file__).resolve().parents[2] / "configs" / "distill.json"),
        help="distillation config (default: the shipped production configs/distill.json)",
    )
    parser.add_argument("--datasets_dir", default="/datasets")
    parser.add_argument("--logs_base", default="logs")
    parser.add_argument("--max_steps", default=1_000_000, type=int)
    parser.add_argument("--batch_size", default=5, type=int)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = parser.parse_args(argv)

    with open(a.config) as f:
        config = json.load(f)

    from hifigan_tpu_torch.distill.model import embedding_size_from_layers
    from hifigan_tpu_torch.dsl.parsing import parse_layers

    embedding_size = embedding_size_from_layers(
        parse_layers(config["models"]["generator"]["layers"])
    )
    flat = {
        "segment_length": config["loops"]["train"]["segment_length"],
        "sampling_rate": config["sampling_rate"],
        "augmentation": config["augmentation"],
    }
    datasets = build_sniffer_datasets(flat, a.datasets_dir, embedding_size)

    writer_factory = summary_writer_class()
    train_sniffers(
        config,
        datasets,
        a.logs_base,
        max_steps=a.max_steps,
        batch_size=a.batch_size,
        writer_factory=writer_factory,
        device=a.device,
    )


if __name__ == "__main__":
    main()
