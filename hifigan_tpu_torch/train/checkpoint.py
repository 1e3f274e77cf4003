"""Generator checkpoint I/O (subset of ``hifigan_tpu/train/checkpoint.py``).

- ``g_XXXXXXXX`` files are torch zip checkpoints ``{'generator':
  state_dict}`` with the reference's keys; :func:`scan_checkpoint` finds
  the latest in a directory.
- :func:`generator_state_dict_from_jax` carries weights across from the JAX
  package: it turns a JAX ``Generator`` params pytree (numpy arrays,
  weight-normed ``{'v', 'g'}`` or folded ``{'kernel'}`` leaves) into the
  port's state_dict, with the key mapping of the JAX package's
  ``export_torch_generator``.

Layout transposes (JAX -> torch): Conv1d (K, I, O) -> (O, I, K);
ConvTranspose1d (K, I, O) -> (I, O, K).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch


def load_checkpoint(filepath: str, map_location: str | torch.device = "cpu") -> dict:
    """Load a torch zip checkpoint (``g_*`` files hold ``{'generator': state_dict}``)."""
    if not os.path.isfile(filepath):
        raise FileNotFoundError(filepath)
    with open(filepath, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(f"{filepath} is not a torch zip checkpoint (msgpack files are not "
                         "read by the port yet)")
    return torch.load(filepath, map_location=map_location, weights_only=True)


def scan_checkpoint(cp_dir: str, prefix: str) -> str | None:
    """Latest ``prefix + 8-digit-step`` file in ``cp_dir``."""
    cp_list = glob.glob(os.path.join(cp_dir, prefix + "????????"))
    return sorted(cp_list)[-1] if cp_list else None


def generator_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX Generator params (``{'params': ...}`` or the inner dict) -> torch state_dict."""
    params = params.get("params", params)
    out: dict[str, torch.Tensor] = {}

    def emit(torch_key: str, leaf: dict, transposed: bool) -> None:
        tr = (1, 2, 0) if transposed else (2, 1, 0)
        if "v" in leaf and "g" in leaf:
            out[f"{torch_key}.weight_v"] = np.transpose(np.asarray(leaf["v"]), tr)
            out[f"{torch_key}.weight_g"] = np.asarray(leaf["g"]).reshape(-1, 1, 1)
        else:
            out[f"{torch_key}.weight"] = np.transpose(np.asarray(leaf["kernel"]), tr)
        if "bias" in leaf:
            out[f"{torch_key}.bias"] = np.asarray(leaf["bias"])

    for name, leaf in params.items():
        if name in ("conv_pre", "conv_post"):
            emit(name, leaf, transposed=False)
        elif name.startswith("ups_"):
            emit(f"ups.{name.split('_')[1]}", leaf, transposed=True)
        elif name.startswith("resblocks_"):
            rb_i = name.split("_")[1]
            for conv_name, conv_leaf in leaf.items():
                kind, j = conv_name.rsplit("_", 1)
                emit(f"resblocks.{rb_i}.{kind}.{j}", conv_leaf, transposed=False)
        else:
            raise KeyError(f"unrecognised generator param subtree: {name}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
