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
- :func:`distill_variables_from_jax` carries the distillation models'
  variables (``DistillTrainer.create_state(...).variables`` of the JAX
  package: params, spectral ``u``, valves) into the port's DSL modules'
  state_dicts, :func:`distill_variables_to_jax` back, and
  :func:`load_distill_variables` loads them into a built ``DistillModels``.
  The DSL modules keep the flax names, so this is a rename plus the layout
  transposes; a homogeneous ensemble's stacked (axis 0) leaves become its
  members'.

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


# ---------------------------------------------------------------------------
# distillation models (DSL modules)
# ---------------------------------------------------------------------------

DISTILL_MODELS = ("encoder", "decoder", "discriminator", "keepers", "hunters", "sniffers")
_GROUPED = ("keepers", "hunters", "sniffers")


def dsl_state_dict_from_jax(variables: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """One JAX ``ConfigurableModule``'s variables -> the port module's state_dict (numpy)."""
    params = variables.get("params", {})
    spectral = variables.get("spectral", {})
    valves = variables.get("valves", {})
    out: dict[str, np.ndarray] = {}
    for name, leaf in params.items():
        if name.endswith("_ens"):
            n = len(np.asarray(next(iter(next(iter(leaf.values())).values()))))
            for i in range(n):
                sub = {"params": {k: {a: np.asarray(v)[i] for a, v in conv.items()}
                                  for k, conv in leaf.items()},
                       "spectral": {k: {a: np.asarray(v)[i] for a, v in conv.items()}
                                    for k, conv in spectral.get(name, {}).items()},
                       "valves": valves.get(name, {})}
                out.update(dsl_state_dict_from_jax(sub, f"{prefix}ensembles.{name}.{i}."))
            continue
        key = f"{prefix}convs.{name}"
        u = spectral.get(name, {}).get("u")
        if "v" in leaf:
            out[f"{key}.weight_v"] = np.transpose(np.asarray(leaf["v"]), (2, 1, 0))
            out[f"{key}.weight_g"] = np.asarray(leaf["g"]).reshape(-1, 1, 1)
        elif u is not None:
            w_t = np.transpose(np.asarray(leaf["kernel"]), (2, 1, 0))
            u = np.asarray(u).reshape(-1)
            out[f"{key}.weight_orig"] = w_t
            out[f"{key}.weight_u"] = u
            out[f"{key}.weight_v"] = _l2n(w_t.reshape(w_t.shape[0], -1).T @ u)
        else:
            out[f"{key}.weight"] = np.transpose(np.asarray(leaf["kernel"]), (2, 1, 0))
        out[f"{key}.bias"] = np.asarray(leaf["bias"])
    for name, val in valves.items():
        if not isinstance(val, dict):
            out[f"{prefix}valves.{name}"] = np.asarray(val)
    return out


def dsl_variables_to_jax(sd: dict) -> dict:
    """A port ``ConfigurableModule``'s state_dict -> the JAX module's variables (numpy)."""
    params: dict = {}
    spectral: dict = {}
    valves: dict = {}
    members: dict = {}
    for key, val in sd.items():
        val = np.asarray(val.detach().cpu() if torch.is_tensor(val) else val)
        if key.startswith("ensembles."):
            _, name, i, rest = key.split(".", 3)
            members.setdefault(name, {}).setdefault(int(i), {})[rest] = val
        elif key.startswith("valves."):
            valves[key[len("valves."):]] = val
        elif key.startswith("convs."):
            _, name, attr = key.split(".")
            leaf = params.setdefault(name, {})
            if attr == "weight_v" and f"convs.{name}.weight_g" in sd:
                leaf["v"] = np.transpose(val, (2, 1, 0))
            elif attr == "weight_g":
                leaf["g"] = val.reshape(-1)
            elif attr in ("weight_orig", "weight"):
                leaf["kernel"] = np.transpose(val, (2, 1, 0))
            elif attr == "weight_u":
                spectral.setdefault(name, {})["u"] = val
            elif attr == "bias":
                leaf["bias"] = val
    for name, subs in members.items():
        trees = [dsl_variables_to_jax(subs[i]) for i in sorted(subs)]
        params[name] = {k: {a: np.stack([t["params"][k][a] for t in trees])
                            for a in conv} for k, conv in trees[0]["params"].items()}
        if trees[0].get("spectral"):
            spectral[name] = {k: {a: np.stack([t["spectral"][k][a] for t in trees])
                                  for a in conv} for k, conv in trees[0]["spectral"].items()}
        if trees[0].get("valves"):
            valves[name] = trees[0]["valves"]
    out = {"params": params}
    if spectral:
        out["spectral"] = spectral
    if valves:
        out["valves"] = valves
    return out


def distill_variables_from_jax(variables: dict) -> dict:
    """JAX ``DistillTrainState.variables`` (numpy leaves) -> ``{model:
    state_dict}`` (``{model: {key: state_dict}}`` for keepers, hunters,
    sniffers) of the port's DSL modules."""

    def conv(v):
        return {k: torch.from_numpy(np.array(a, dtype=np.float32))
                for k, a in dsl_state_dict_from_jax(v).items()}

    return {m: ({k: conv(v) for k, v in variables[m].items()} if m in _GROUPED
                else conv(variables[m])) for m in DISTILL_MODELS}


def distill_variables_to_jax(state_dicts: dict) -> dict:
    """Inverse of :func:`distill_variables_from_jax` (numpy leaves)."""
    return {m: ({k: dsl_variables_to_jax(v) for k, v in state_dicts[m].items()} if m in _GROUPED
                else dsl_variables_to_jax(state_dicts[m])) for m in DISTILL_MODELS}


def load_distill_variables(models, state_dicts: dict) -> None:
    """Load ``{model: state_dict}`` into a built ``DistillModels`` (strict)."""
    mods = models.modules()
    for m in DISTILL_MODELS:
        if m in _GROUPED:
            for k, sd in state_dicts[m].items():
                mods[m][k].load_state_dict(sd)
        else:
            mods[m].load_state_dict(state_dicts[m])


def distill_state_dicts(models) -> dict:
    """The port's ``{model: state_dict}`` of a ``DistillModels``."""
    mods = models.modules()
    return {m: ({k: v.state_dict() for k, v in mods[m].items()} if m in _GROUPED
                else mods[m].state_dict()) for m in DISTILL_MODELS}
