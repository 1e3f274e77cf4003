"""Vocoder training CLI (port of ``hifigan_tpu/cli/train.py``)::

    python -m hifigan_tpu_torch.cli.train --config configs/config_v1.json \\
        [--checkpoint_path cp_hifigan] [--fine_tuning True] [--device cuda]

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path). As the JAX CLI, it builds a ``('data',
'model')`` mesh over every rank and prints it; under ``torchrun``
(``WORLD_SIZE > 1``) the process group comes first
(``parallel.mesh.initialize_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo
for ``--device cpu``) and the step is data parallel, each rank reading its
share of every batch::

    torchrun --nproc_per_node 4 -m hifigan_tpu_torch.cli.train --config configs/config_v1.json

The config's discriminator keys reach the step as the JAX CLI's do:
``msd_conv_impl`` (``'auto'``, ``'xla'``, ``'fused_stack'``,
``'fused_zoned'``, ``'pallas'``) and ``disc_fused``
(``train/vocoder.py`` says what each form computes).

``g_*`` and ``do_*`` checkpoints and ``config.json`` go to
``--checkpoint_path`` (rank 0 writes), and a run there resumes from the
latest pair.
"""

from __future__ import annotations

import argparse
import os

from hifigan_tpu_torch.config import build_env, load_config
from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.parallel.mesh import create_mesh, initialize_distributed, world
from hifigan_tpu_torch.train.vocoder import train


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--group_name", default=None)
    parser.add_argument("--input_wavs_dir", default="LJSpeech-1.1/wavs")
    parser.add_argument("--input_mels_dir", default="ft_dataset")
    parser.add_argument("--input_training_file", default="LJSpeech-1.1/training.txt")
    parser.add_argument("--input_validation_file", default="LJSpeech-1.1/validation.txt")
    parser.add_argument("--checkpoint_path", default="cp_hifigan")
    parser.add_argument("--config", default="")
    parser.add_argument("--training_epochs", default=3100, type=int)
    parser.add_argument("--stdout_interval", default=5, type=int)
    parser.add_argument("--checkpoint_interval", default=5000, type=int)
    parser.add_argument("--summary_interval", default=100, type=int)
    parser.add_argument("--validation_interval", default=1000, type=int)
    parser.add_argument("--fine_tuning", default=False, type=bool)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv: list[str] | None = None):
    print("Initializing Training Process..")
    a = build_parser().parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        device = initialize_distributed(a.device)
    else:
        device = resolve_device(a.device)
    h = load_config(a.config)
    lead = world()[0] == 0
    if lead:
        build_env(a.config, "config.json", a.checkpoint_path)
    mesh = create_mesh(device=device)
    print(f"mesh: {mesh}")
    writer = None
    if lead:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(a.checkpoint_path, "logs"))
        except ImportError:
            pass
    return train(a, h, device=device, writer=writer, mesh=mesh)


if __name__ == "__main__":
    main()
