"""Layer-string DSL parser (a copy of ``hifigan_tpu/dsl/parsing.py``).

Capability parity with reference speech_distillation/config_utils.py:1-30 —
strings like ``"res.1|conv.1,sub_res:1,3,3,1,1,1e-00"`` split into
``(types, params)`` where each comma-separated token becomes int/float/str.
"""

from __future__ import annotations


def _isfloat(s: str) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def parse_layer_param(param: str):
    if str.isdigit(param):
        return int(param)
    if _isfloat(param):
        return float(param)
    return param


def parse_layer_params(layer_params_config: str) -> list:
    return [parse_layer_param(p) for p in layer_params_config.split(",")]


def parse_layer(layer_config: str) -> tuple[list, list]:
    layer_types_config, layer_params_config = layer_config.split(":")
    return parse_layer_params(layer_types_config), parse_layer_params(layer_params_config)


def parse_layers(layers_config: list[str]) -> list[tuple[list, list]]:
    return [parse_layer(c) for c in layers_config]
