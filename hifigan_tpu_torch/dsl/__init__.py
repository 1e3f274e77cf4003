"""The model-builder DSL (PyTorch port of ``hifigan_tpu/dsl``): layer-string
parsing, config normalisation and generators, and the interpreter module."""

from hifigan_tpu_torch.dsl.module import ConfigurableModule  # noqa: F401
from hifigan_tpu_torch.dsl.normalize import normalize_config  # noqa: F401
from hifigan_tpu_torch.dsl.parsing import (  # noqa: F401
    parse_layer,
    parse_layer_param,
    parse_layer_params,
    parse_layers,
)
