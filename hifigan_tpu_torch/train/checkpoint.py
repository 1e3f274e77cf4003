"""Vocoder checkpoint I/O (port of ``hifigan_tpu/train/checkpoint.py``).

- ``g_XXXXXXXX`` files are torch zip checkpoints ``{'generator':
  state_dict}`` with the reference's keys; :func:`scan_checkpoint` finds
  the latest in a directory.
- ``do_XXXXXXXX`` files are torch zip checkpoints ``{'mpd', 'msd',
  'optim_g', 'optim_d', 'steps', 'epoch'}``: the discriminators'
  state_dicts with the reference's keys and both optimizers' state (their
  Adam moments, as the JAX trainer keeps them, so a resume does not restart
  Adam).
- :func:`generator_state_dict_from_jax` and
  :func:`discriminator_state_dict_from_jax` carry weights across from the
  JAX package: they turn its params pytrees (numpy arrays) into the port's
  state_dicts, with the key mapping of the JAX package's
  ``export_torch_generator`` / ``export_torch_discriminators``.

Layout transposes (JAX -> torch): Conv1d (K, I, O) -> (O, I, K); Conv2d
(KH, KW, I, O) -> (O, I, KH, KW); ConvTranspose1d (K, I, O) -> (I, O, K).
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


def save_checkpoint(filepath: str, obj: dict) -> None:
    """torch.save through a temporary file, so a reader never sees half a file."""
    tmp = filepath + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, filepath)


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


def _l2n(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return x / (np.linalg.norm(x) + eps)


def discriminator_state_dict_from_jax(mpd_vars: dict, msd_vars: dict) -> dict[str, dict]:
    """JAX MPD/MSD variables (``{'params': ..., 'spectral': ...}``) ->
    ``{'mpd': state_dict, 'msd': state_dict}`` for the port's modules.

    Weight-normed convs give ``weight_v``/``weight_g``; spectral-normed ones
    (MSD scale 0) ``weight_orig``, ``weight_u`` and the power-iteration
    vector ``weight_v = l2n(W_matᵀ u)`` over the torch-layout matrix.
    """

    def stack(variables: dict) -> dict[str, torch.Tensor]:
        spectral = variables.get("spectral", {})
        out: dict[str, np.ndarray] = {}
        for disc_name, mods in variables["params"].items():
            i = disc_name.split("_")[-1]
            for mod_name, leaf in mods.items():
                tk = (f"discriminators.{i}.convs.{mod_name.split('_')[-1]}"
                      if mod_name.startswith("convs_") else f"discriminators.{i}.conv_post")
                kern = np.asarray(leaf.get("v", leaf.get("kernel")))
                tr = (2, 1, 0) if kern.ndim == 3 else (3, 2, 0, 1)
                u = spectral.get(disc_name, {}).get(mod_name, {}).get("u")
                if "v" in leaf and "g" in leaf:
                    out[f"{tk}.weight_v"] = np.transpose(kern, tr)
                    out[f"{tk}.weight_g"] = np.asarray(leaf["g"]).reshape(
                        (-1,) + (1,) * (kern.ndim - 1))
                elif u is not None:
                    w_t = np.transpose(kern, tr)
                    u = np.asarray(u).reshape(-1)
                    out[f"{tk}.weight_orig"] = w_t
                    out[f"{tk}.weight_u"] = u
                    out[f"{tk}.weight_v"] = _l2n(w_t.reshape(w_t.shape[0], -1).T @ u)
                else:
                    out[f"{tk}.weight"] = np.transpose(kern, tr)
                if "bias" in leaf:
                    out[f"{tk}.bias"] = np.asarray(leaf["bias"])
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}

    return {"mpd": stack(mpd_vars), "msd": stack(msd_vars)}
