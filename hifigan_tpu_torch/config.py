"""Config carrier + loading (PyTorch port of ``hifigan_tpu/config.py``).

``AttrDict`` and ``build_env`` mirror the reference's ``env.py``; the V1/V2/V3 hyperparameter
sets equal the shared ``configs/config_v*.json`` files (checked by the tests),
and a ``config.json`` beside a checkpoint is read with :func:`load_config`.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any


class AttrDict(dict):
    """dict with attribute access."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.__dict__ = self

    def __getattr__(self, name: str) -> Any:  # missing keys -> AttributeError
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def upsample_hop(h) -> int:
    """Samples per mel frame of a generator config: prod(upsample_rates)."""
    return int(math.prod(h["upsample_rates"]))


def load_config(path: str) -> AttrDict:
    with open(path, "r", encoding="utf-8") as f:
        return AttrDict(json.load(f))


def build_env(config: str, config_name: str, path: str) -> None:
    """Copy the config file beside the checkpoints (the reference's ``env.py``)."""
    t_path = os.path.join(path, config_name)
    if config != t_path:
        os.makedirs(path, exist_ok=True)
        shutil.copyfile(config, t_path)


_COMMON = dict(
    num_gpus=0,
    batch_size=16,
    learning_rate=0.0002,
    adam_b1=0.8,
    adam_b2=0.99,
    lr_decay=0.999,
    seed=1234,
    segment_size=8192,
    num_mels=80,
    num_freq=1025,
    n_fft=1024,
    hop_size=256,
    win_size=1024,
    sampling_rate=22050,
    fmin=0,
    fmax=8000,
    fmax_for_loss=None,
    num_workers=4,
)

CONFIG_V1 = AttrDict(
    dict(
        _COMMON,
        resblock="1",
        upsample_rates=[8, 8, 2, 2],
        upsample_kernel_sizes=[16, 16, 4, 4],
        upsample_initial_channel=512,
        resblock_kernel_sizes=[3, 7, 11],
        resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    )
)

CONFIG_V2 = AttrDict(
    dict(
        _COMMON,
        resblock="1",
        upsample_rates=[8, 8, 2, 2],
        upsample_kernel_sizes=[16, 16, 4, 4],
        upsample_initial_channel=128,
        resblock_kernel_sizes=[3, 7, 11],
        resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    )
)

CONFIG_V3 = AttrDict(
    dict(
        _COMMON,
        resblock="2",
        upsample_rates=[8, 8, 4],
        upsample_kernel_sizes=[16, 16, 8],
        upsample_initial_channel=256,
        resblock_kernel_sizes=[3, 5, 7],
        resblock_dilation_sizes=[[1, 2], [2, 6], [3, 12]],
    )
)

CONFIGS = {"v1": CONFIG_V1, "v2": CONFIG_V2, "v3": CONFIG_V3}


def get_config(name: str) -> AttrDict:
    """Return a fresh copy of a built-in config ('v1' | 'v2' | 'v3')."""
    return AttrDict(json.loads(json.dumps(CONFIGS[name.lower()])))
