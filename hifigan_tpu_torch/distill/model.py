"""GAN-autoencoder model assembly for speech distillation (PyTorch port of
``hifigan_tpu/distill/model.py``).

Builds every model from the declarative configs: the generator (encoder +
decoder), the all-in-one ensemble discriminator and its frozen evaluation
twin, and the keeper / hunter / sniffer classifier ensembles, all
:class:`ConfigurableModule` interpreters; and the flat optimizer grouping
from config keys like ``"generator,keepers"``.

``DistillModels(...)`` creates no parameter; :meth:`DistillModels.build`
draws them (seeded ``torch.Generator``, on the CPU, by evaluating each model
once on a batch-1 dummy input as the JAX ``init_variables`` does) and
:meth:`DistillModels.to` moves them. The weight carrier
(``train/checkpoint.py``) loads the JAX package's variables instead.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.dsl.classifiers import (
    generate_hunters_config_by_example,
    generate_keepers_config_by_example,
)
from hifigan_tpu_torch.dsl.module import ConfigurableModule
from hifigan_tpu_torch.dsl.parsing import parse_layers
from hifigan_tpu_torch.dsl.static_configs import (
    generate_sniffers_configs_by_example,
    get_discriminator_config,
    get_generator_configs,
)

def embedding_size_from_layers(generator_layers) -> int:
    """prod of layer strides."""
    return int(np.prod([lp[2] for _lt, lp in generator_layers]))


class DistillModels:
    """Every model of the distillation, as interpreter modules."""

    def __init__(self, config: dict, example_labels: dict, label_weights: dict,
                 sampling_rate: int | None = None, compute_dtype=None,
                 conv_impl: str | None = None, member_impl: str | None = None,
                 stream_impl: str | None = None, device=None):
        models_cfg = config["models"]
        self.device = resolve_device(device)
        compute_dtype = compute_dtype or models_cfg.get("compute_dtype")
        self.compute_dtype = compute_dtype
        conv_impl = conv_impl or models_cfg.get("conv_impl", "auto")
        member_impl = member_impl or models_cfg.get("member_impl", "auto")
        stream_impl = stream_impl or models_cfg.get("stream_impl", "auto")
        opts = dict(compute_dtype=compute_dtype, conv_impl=conv_impl)
        gen_layers = parse_layers(models_cfg["generator"]["layers"])
        self.generator_layers = gen_layers
        self.embedding_size = embedding_size_from_layers(gen_layers)
        expansion = models_cfg["generator"].get("expansion", 4)
        self.embedding_channels = expansion * self.embedding_size
        gen_cfgs = get_generator_configs(gen_layers, expansion_size=expansion,
                                         embedding_size=self.embedding_size)
        self.encoder = ConfigurableModule(gen_cfgs["encoder"], stream_impl=stream_impl, **opts)
        self.decoder = ConfigurableModule(gen_cfgs["decoder"], stream_impl=stream_impl, **opts)

        disc_layers = parse_layers(models_cfg["discriminator"]["layers"])
        disc_config = get_discriminator_config(
            disc_layers, expansion_size=models_cfg["discriminator"].get("expansion", 1),
            ensemble_size=models_cfg["discriminator"].get("ensemble", 3))
        self.discriminator = ConfigurableModule(disc_config, update_spectral=True,
                                                mel_sampling_rate_override=sampling_rate,
                                                member_impl=member_impl, **opts)

        half = self.embedding_channels // 2
        keeper_cfgs = generate_keepers_config_by_example(
            half, example_labels, layers=parse_layers(models_cfg["keepers"]["layers"]),
            ensemble_size=models_cfg["keepers"].get("ensemble", 3))
        hunter_cfgs = generate_hunters_config_by_example(
            half, example_labels, layers=parse_layers(models_cfg["hunters"]["layers"]),
            ensemble_size=models_cfg["hunters"].get("ensemble", 3))
        sniffer_cfgs = generate_sniffers_configs_by_example(
            example_labels, layers=parse_layers(models_cfg["sniffers"]["layers"]),
            ensemble_size=models_cfg["sniffers"].get("ensemble", 3))
        self.keepers = {k: ConfigurableModule(c, **opts) for k, c in keeper_cfgs.items()}
        self.hunters = {k: ConfigurableModule(c, **opts) for k, c in hunter_cfgs.items()}
        self.sniffers = {k: ConfigurableModule(c, **opts) for k, c in sniffer_cfgs.items()}
        self.example_labels = example_labels
        self.label_weights = label_weights
        self.config = config

    def frozen_discriminator(self) -> ConfigurableModule:
        """A copy of the live discriminator to judge the generator with: no
        spectral update, ``weight_grads=False``, parameters without grad."""
        twin = copy.deepcopy(self.discriminator)
        for mod in twin.modules():
            if isinstance(mod, ConfigurableModule):
                mod.update_spectral = False
                mod.weight_grads = False
        twin.requires_grad_(False)
        return twin

    def frozen_copy(self, module: ConfigurableModule) -> ConfigurableModule:
        twin = copy.deepcopy(module)
        twin.requires_grad_(False)
        return twin

    def build(self, segment_length: int, seed: int = 0) -> "DistillModels":
        """Draw every parameter (CPU, seeded) with dummy inputs of batch 1,
        as ``init_variables`` does, then move the models to the device."""
        gen = torch.Generator().manual_seed(seed)
        wav = torch.zeros((1, segment_length, 1))
        emb_t = segment_length // self.embedding_size
        half = self.embedding_channels // 2
        self.encoder.build(wav, generator=gen)
        with torch.no_grad():
            emb = self.encoder(wav)
        self.decoder.build(emb, generator=gen)
        self.discriminator.build(wav, generator=gen)
        emb_half = torch.zeros((1, emb_t, half))
        for m in self.keepers.values():
            m.build(emb_half, generator=gen)
        for m in self.hunters.values():
            m.build(emb_half, generator=gen)
        for k, m in self.sniffers.items():
            with torch.no_grad():
                keeper_out = self.keepers[k](emb_half)
            m.build(keeper_out["mean"][k], generator=gen)
        return self.to(self.device)

    def modules(self) -> dict:
        return {"encoder": self.encoder, "decoder": self.decoder,
                "discriminator": self.discriminator, "keepers": self.keepers,
                "hunters": self.hunters, "sniffers": self.sniffers}

    def to(self, device) -> "DistillModels":
        self.device = torch.device(device)
        for m in self.encoder, self.decoder, self.discriminator, *self.keepers.values(), \
                *self.hunters.values(), *self.sniffers.values():
            m.to(self.device)
        return self


def flat_optimizer_groups(optimizers_config: dict) -> dict[str, float]:
    """{'generator,keepers': 2e-3, 'hunters': {'style': 1e-3}} ->
    {'generator,keepers': 2e-3, 'hunters/style': 1e-3}."""
    flat = {}
    for key, value in optimizers_config.items():
        if isinstance(value, dict):
            for sub, lr in value.items():
                flat[f"{key}/{sub}"] = lr
        else:
            flat[key] = value
    return flat


def group_param_selector(group_key: str) -> list[tuple]:
    """A flat group key -> the model paths it trains ('generator' spans
    encoder and decoder; 'hunters/style' is hunters['style'])."""
    paths = []
    for model_key in group_key.split(","):
        if "/" in model_key:
            root, sub = model_key.split("/", 1)
            paths.append((root, sub))
        elif model_key == "generator":
            paths += [("encoder",), ("decoder",)]
        else:
            paths.append((model_key,))
    return paths


def expand_group_paths(group_key: str, models: dict) -> list[tuple]:
    """Like group_param_selector, with dict-of-model nodes expanded to their models."""
    out = []
    for path in group_param_selector(group_key):
        node = models
        for p in path:
            node = node[p]
        if isinstance(node, dict):
            out.extend(path + (k,) for k in node)
        else:
            out.append(path)
    return out
