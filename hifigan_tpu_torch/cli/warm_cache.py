"""Dataset smoke / cache-warm script (port of ``hifigan_tpu/cli/warm_cache.py``;
reference speech_distillation/test.py + test.Dockerfile): instantiate the
datasets, iterate items, and pre-compute every per-item label pickle cache::

    python -m hifigan_tpu_torch.cli.warm_cache --datasets_dir DATASETS
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from hifigan_tpu_torch.data.multilabel import MultilabelWaveDataset, worker_pool
from hifigan_tpu_torch.distill.model import embedding_size_from_layers
from hifigan_tpu_torch.dsl.parsing import parse_layers


def warm_label_caches(ds, workers: int | None = None) -> None:
    """Pre-compute every per-item label pickle in parallel — the reference
    warms with Pool(16) (test.py:57-61, multilabel_wave_dataset.py:176)."""
    import multiprocessing

    workers = workers or min(16, multiprocessing.cpu_count())
    if workers > 1 and len(ds) > 1:
        with worker_pool(workers) as pool:
            pool.map(ds.create_pickle_label, range(len(ds)))
    else:
        for i in range(len(ds)):
            ds.create_pickle_label(i)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--config",
        default=str(Path(__file__).resolve().parents[2] / "configs" / "distill.json"),
        help="distillation config (default: the shipped production configs/distill.json)",
    )
    parser.add_argument("--datasets_dir", default="/datasets")
    parser.add_argument("--workers", default=None, type=int)
    parser.add_argument("--iterate", default=5, type=int, help="items to smoke-test per loop")
    a = parser.parse_args(argv)

    with open(a.config) as f:
        config = json.load(f)

    embedding_size = embedding_size_from_layers(
        parse_layers(config["models"]["generator"]["layers"])
    )
    for key in config["loops"]:
        ds = MultilabelWaveDataset(
            data_dir=f"{a.datasets_dir}/data",
            aug_dir=f"{a.datasets_dir}/aug",
            cache_dir=f"{a.datasets_dir}/cache",
            name=key,
            segment_length=config["loops"][key]["segment_length"],
            sampling_rate=config["sampling_rate"],
            embedding_size=embedding_size,
            augmentation_config=config["augmentation"],
            num_workers=a.workers,
            **config["data"][key]["dataset"],
        )
        print(f"[{key}] {len(ds)} items; warming label caches...")
        warm_label_caches(ds, a.workers)
        for i in range(min(a.iterate, len(ds))):
            wav, path, time_labels, grouped = ds[i]
            print(f"  item {i}: wav {wav.shape}, labels "
                  f"{ {g: list(v.keys()) for g, v in time_labels.items()} }")
        print(f"[{key}] ready.")


if __name__ == "__main__":
    main()
