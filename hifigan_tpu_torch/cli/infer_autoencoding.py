"""Autoencoding inference CLI: wav -> encoder -> decoder -> wav (port of
``hifigan_tpu/cli/infer_autoencoding.py``).

Loads a distillation experiment directory (``config.yaml`` and
``checkpoints/latest``, as the JAX trainer writes them: YAML read by
:func:`hifigan_tpu_torch.utils.caching.load_yaml`, flax msgpack by
:func:`hifigan_tpu_torch.train.msgpack.msgpack_restore`) and autoencodes
every wav of a directory, each trimmed to a multiple of the embedding size,
into ``<name>_autoencoded.wav``. Only the encoder and decoder are built and
restored (the classifiers' trees depend on the label taxonomy).
``models.stream_impl: "fused"`` in the config runs their narrow levels
through the stream-graph kernel. Flags: the JAX CLI's and ``--device``
(default ``cuda``)::

    python -m hifigan_tpu_torch.cli.infer_autoencoding --experiment_dir EXPERIMENT_DIR
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hifigan_tpu_torch.audio import load_wav, save_wav
from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.distill.model import DistillModels
from hifigan_tpu_torch.train.checkpoint import dsl_state_dict_from_jax, dsl_variables_to_jax
from hifigan_tpu_torch.train.msgpack import msgpack_restore
from hifigan_tpu_torch.utils.caching import load_yaml
from hifigan_tpu_torch.utils.pytree import restack_legacy_ensembles

# labels and weights only shape the classifiers, which autoencoding does not build
PLACEHOLDER_LABELS = {"content": {"sad": ("none", "silence", "speech")},
                      "style": {"mic-brand": ("none",)}}
PLACEHOLDER_WEIGHTS = {g: {k: {"true": tuple([1.0] * len(v)), "false": tuple([1.0] * len(v))}
                           for k, v in gg.items()} for g, gg in PLACEHOLDER_LABELS.items()}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_wavs_dir", default="test_files")
    parser.add_argument("--output_dir", default="autoencoded_files")
    parser.add_argument("--experiment_dir", required=True,
                        help="logs/<name>/version_<v> directory with config.yaml + checkpoints/")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def load_autoencoder(experiment_dir: str, device) -> tuple[DistillModels, dict]:
    """The experiment's encoder and decoder (seeded, then the checkpoint's
    weights where ``checkpoints/latest`` exists), on ``device``."""
    with open(os.path.join(experiment_dir, "config.yaml")) as f:
        config = load_yaml(f.read())
    models = DistillModels(config, PLACEHOLDER_LABELS, PLACEHOLDER_WEIGHTS,
                           sampling_rate=config["sampling_rate"], device=device)
    gen = torch.Generator().manual_seed(0)
    wav = torch.zeros((1, models.embedding_size, 1))
    models.encoder.build(wav, generator=gen)
    with torch.no_grad():
        emb = models.encoder(wav)
    models.decoder.build(emb, generator=gen)
    ckpt = os.path.join(experiment_dir, "checkpoints", "latest")
    if os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            restored = msgpack_restore(f.read())
        for key, module in (("encoder", models.encoder), ("decoder", models.decoder)):
            tree = restack_legacy_ensembles(restored["variables"][key],
                                            dsl_variables_to_jax(module.state_dict()))
            module.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                                    for k, v in dsl_state_dict_from_jax(tree).items()})
        print(f"Loaded {ckpt} (encoder/decoder restored, step {restored.get('step')})")
    models.encoder.to(models.device)
    models.decoder.to(models.device)
    return models, config


@torch.no_grad()
def autoencode(models: DistillModels, mono: np.ndarray) -> np.ndarray:
    """A mono waveform trimmed to a multiple of the embedding size, encoded
    and decoded: (T',) float32."""
    seg = models.embedding_size
    trim = (len(mono) // seg) * seg
    x = torch.from_numpy(np.ascontiguousarray(mono[:trim], np.float32)).to(models.device)
    y = models.decoder(models.encoder(x[None, :, None]))
    return y[0, :, 0].float().cpu().numpy()


def inference(a) -> list[str]:
    device = resolve_device(a.device)
    models, config = load_autoencoder(a.experiment_dir, device)
    os.makedirs(a.output_dir, exist_ok=True)
    written = []
    for filename in sorted(os.listdir(a.input_wavs_dir)):
        if not filename.lower().endswith(".wav"):
            continue
        wav, _sr = load_wav(os.path.join(a.input_wavs_dir, filename))
        out = os.path.join(a.output_dir, os.path.splitext(filename)[0] + "_autoencoded.wav")
        save_wav(out, autoencode(models, wav[0]), config["sampling_rate"])
        print(out)
        written.append(out)
    return written


def main(argv: list[str] | None = None) -> list[str]:
    print("Initializing Autoencoding Inference Process..")
    return inference(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
