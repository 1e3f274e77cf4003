"""Keeper/hunter classifier config generators.

Capability parity with reference speech_distillation/embedding_classifiers/
embedding_classifiers_static_configs.py:6-65 — ensembles of conv
classifiers over embeddings:

- keepers classify labels of their *own* group (content->content,
  style->style), pressuring the embedding to keep that information;
- hunters classify labels of the *other* group, adversarially hunting
  leaked information.

Returns configs for hifigan_tpu_torch.dsl.module.ConfigurableModule (a copy
of ``hifigan_tpu/dsl/classifiers.py``).
"""

from __future__ import annotations

from hifigan_tpu_torch.dsl.module import ConfigurableModule
from hifigan_tpu_torch.dsl.static_configs import get_classifier_backbone


def generate_classifier_by_example(input_channels, example, layers):
    label_groups = {
        ex_key: {key: len(value) for key, value in label_group.items()}
        for ex_key, label_group in example.items()
    }
    groups_channels = {
        ex_key: sum(v for v in label_group.values()) for ex_key, label_group in label_groups.items()
    }
    output_channels = sum(groups_channels.values())
    return [
        get_classifier_backbone(input_channels, output_channels, layers=layers),
        ("split", groups_channels),
        ("recursive", {group: ("split", sizes) for group, sizes in label_groups.items()}),
        ("recursive", {group: {key: ("softmax",) for key in sizes} for group, sizes in label_groups.items()}),
    ]


def generate_keepers_config_by_example(input_channels, grouped_examples, layers=(), ensemble_size=3):
    return {
        key: (
            "ensemble",
            [
                generate_classifier_by_example(
                    input_channels,
                    {k2: v2 for k2, v2 in grouped_examples.items() if key == k2},
                    layers=list(layers),
                )
                for _ in range(ensemble_size)
            ],
        )
        for key in grouped_examples
    }


def generate_hunters_config_by_example(input_channels, grouped_examples, layers, ensemble_size=3):
    return {
        key: (
            "ensemble",
            [
                generate_classifier_by_example(
                    input_channels,
                    {k2: v2 for k2, v2 in grouped_examples.items() if key != k2},
                    layers=list(layers),
                )
                for _ in range(ensemble_size)
            ],
        )
        for key in grouped_examples
    }


def generate_keepers_by_example(input_channels, example_item, cache_hook=lambda k, x: x(), layers=()):
    cfgs = generate_keepers_config_by_example(input_channels, example_item, layers=layers)
    return {
        key: ConfigurableModule(config=cache_hook(key, lambda c=cfg: c)) for key, cfg in cfgs.items()
    }


def generate_hunters_by_example(input_channels, example_item, cache_hook=lambda k, x: x(), layers=()):
    cfgs = generate_hunters_config_by_example(input_channels, example_item, layers=layers)
    return {
        key: ConfigurableModule(config=cache_hook(key, lambda c=cfg: c)) for key, cfg in cfgs.items()
    }
