"""Checkpoint I/O (port of ``hifigan_tpu/train/checkpoint.py``).

- ``g_XXXXXXXX`` files are torch zip checkpoints ``{'generator':
  state_dict}`` with the reference's keys; :func:`scan_checkpoint` finds
  the latest in a directory.
- ``do_XXXXXXXX`` files are torch zip checkpoints ``{'mpd', 'msd',
  'optim_g', 'optim_d', 'steps', 'epoch'}``: the discriminators'
  state_dicts with the reference's keys and both optimizers' state (their
  Adam moments, as the JAX trainer keeps them, so a resume does not restart
  Adam).
- :func:`load_checkpoint` reads those and the JAX package's native format
  (flax msgpack, through :mod:`hifigan_tpu_torch.train.msgpack`), told apart
  as the JAX function does: a zip (``PK``) or a ``.pt/.pth/.ckpt`` name is
  torch, anything else msgpack. :func:`save_checkpoint` writes the torch
  format (or the msgpack one) atomically, on a background thread with
  ``async_=True`` (:func:`wait_for_checkpoints` blocks until every write
  is durable).
- The JAX package's torch interchange, on numpy trees in its layouts:
  :func:`load_torch_checkpoint`, :func:`convert_torch_generator` /
  :func:`export_torch_generator` / :func:`save_torch_generator` and
  :func:`convert_torch_discriminators` / :func:`export_torch_discriminators`
  / :func:`save_torch_discriminators`.
- :func:`generator_state_dict_from_jax` and
  :func:`discriminator_state_dict_from_jax` carry weights across from the
  JAX package: they turn its params pytrees (numpy arrays) into the port's
  state_dicts (the exports above, as float32 tensors).
- :func:`distill_variables_from_jax` carries the distillation models'
  variables (``DistillTrainer.create_state(...).variables`` of the JAX
  package: params, spectral ``u``, valves) into the port's DSL modules'
  state_dicts, :func:`distill_variables_to_jax` back, and
  :func:`load_distill_variables` loads them into a built ``DistillModels``.
  The DSL modules keep the flax names, so this is a rename plus the layout
  transposes; a homogeneous ensemble's stacked (axis 0) leaves become its
  members'.

- :func:`distill_train_state_to_jax` writes the whole ``DistillTrainState``
  (step, variables, frozen copies, the six groups' AdamW-amsgrad states,
  the gradient accumulators) as the tree ``flax.serialization.to_state_dict``
  gives of the JAX trainer's state, and :func:`load_distill_train_state`
  loads such a tree (either side's) into the port's state in place;
  :func:`sniffer_state_to_jax`/:func:`load_sniffer_state` do the same for
  the standalone sniffer trainer. An optimizer state is the JAX layout of
  ``optax.inject_hyperparams(chain(scale_by_amsgrad, add_decayed_weights,
  scale_by_learning_rate))``: ``count``, the injected ``learning_rate``,
  and ``inner_state['0']``'s ``count``/``mu``/``nu``/``nu_max`` over the
  group's ``{'model/key': params}`` tree.

Layout transposes (JAX -> torch): Conv1d (K, I, O) -> (O, I, K); Conv2d
(KH, KW, I, O) -> (O, I, KH, KW); ConvTranspose1d (K, I, O) -> (I, O, K).
"""

from __future__ import annotations

import glob
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from hifigan_tpu_torch.train.msgpack import msgpack_restore, msgpack_serialize

_ASYNC_POOL: ThreadPoolExecutor | None = None
_PENDING: list = []


def _write(filepath: str, obj: Any, encoding: str = "torch") -> None:
    tmp = filepath + ".tmp"
    if encoding == "msgpack":
        with open(tmp, "wb") as f:
            f.write(msgpack_serialize(obj))
    else:
        torch.save(obj, tmp)
    os.replace(tmp, filepath)


def _host_copy(obj: Any) -> Any:
    """A copy the training step cannot change under the writer thread (a
    CPU tensor, or an array viewing one, shares the parameter's memory)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def save_checkpoint(filepath: str, obj: Any, async_: bool = False,
                    encoding: str = "torch") -> None:
    """torch.save (``encoding='msgpack'``: the JAX package's flax msgpack)
    through a temporary file, so a reader never sees half a file.
    ``async_=True`` copies the tensors to the host now and writes on a
    background thread; call :func:`wait_for_checkpoints` before relying on
    the file."""
    if not async_:
        _write(filepath, obj, encoding)
        return
    global _ASYNC_POOL
    if _ASYNC_POOL is None:
        _ASYNC_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    _PENDING.append(_ASYNC_POOL.submit(_write, filepath, _host_copy(obj), encoding))


def wait_for_checkpoints() -> None:
    """Block until all async checkpoint writes are durable."""
    while _PENDING:
        _PENDING.pop().result()


def load_checkpoint(filepath: str, map_location: str | torch.device = "cpu") -> Any:
    """A torch checkpoint (``g_*`` files hold ``{'generator': state_dict}``)
    as torch.load gives it, or a native msgpack one as a tree of numpy
    arrays (bfloat16 leaves as torch tensors)."""
    if not os.path.isfile(filepath):
        raise FileNotFoundError(filepath)
    with open(filepath, "rb") as f:
        data = f.read()
    if data[:2] == b"PK" or filepath.endswith((".pt", ".pth", ".ckpt")):
        return torch.load(filepath, map_location=map_location, weights_only=True)
    return msgpack_restore(data)


def scan_checkpoint(cp_dir: str, prefix: str) -> str | None:
    """Latest ``prefix + 8-digit-step`` file in ``cp_dir``."""
    cp_list = glob.glob(os.path.join(cp_dir, prefix + "????????"))
    return sorted(cp_list)[-1] if cp_list else None


# ---------------------------------------------------------------------------
# torch interchange on numpy trees (the JAX package's functions)
# ---------------------------------------------------------------------------


def _numpy_tree(x: Any) -> Any:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy_tree(v) for v in x)
    return x


def load_torch_checkpoint(filepath: str) -> dict:
    """torch.load a reference checkpoint to numpy."""
    return _numpy_tree(torch.load(filepath, map_location="cpu", weights_only=True))


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _convert_conv_entry(out: dict, module_path: list[str], pname: str, w: np.ndarray,
                        transposed: bool) -> None:
    """Map one torch conv tensor into the JAX param tree under module_path."""
    if transposed:
        tr = (2, 0, 1)  # (I,O,K) -> (K,I,O)
    elif w.ndim == 4:
        tr = (2, 3, 1, 0)  # (O,I,KH,KW) -> (KH,KW,I,O)
    else:
        tr = (2, 1, 0)  # (O,I,K) -> (K,I,O)
    if pname == "bias":
        _set(out, module_path + ["bias"], w)
    elif pname in ("weight_v", "weight_orig"):
        _set(out, module_path + ["v" if pname == "weight_v" else "kernel"], np.transpose(w, tr))
    elif pname == "weight_g":
        _set(out, module_path + ["g"], w.reshape(-1))
    elif pname == "weight":
        _set(out, module_path + ["kernel"], np.transpose(w, tr))
    elif pname == "weight_u":
        _set(out, module_path + ["__u"], w.reshape(-1))
    # torch sn's weight_v power-iteration buffer is recomputed; skip.


_GEN_KEY = re.compile(
    r"^(conv_pre|conv_post|ups\.(\d+)|resblocks\.(\d+)\.(convs1|convs2|convs)\.(\d+))\.(.+)$")


def convert_torch_generator(state_dict: dict) -> dict:
    """Reference generator state_dict -> the JAX Generator's ``{'params': ...}``
    (weight-normed or folded)."""
    params: dict = {}
    for key, w in state_dict.items():
        w = np.asarray(_numpy_tree(w))
        m = _GEN_KEY.match(key)
        if not m:
            raise KeyError(f"unrecognised generator key: {key}")
        head, up_i, rb_i, rb_kind, rb_j, pname = m.groups()
        if head in ("conv_pre", "conv_post"):
            _convert_conv_entry(params, [head], pname, w, transposed=False)
        elif head.startswith("ups."):
            _convert_conv_entry(params, [f"ups_{up_i}"], pname, w, transposed=True)
        else:
            _convert_conv_entry(params, [f"resblocks_{rb_i}", f"{rb_kind}_{rb_j}"], pname, w,
                                transposed=False)
    return {"params": params}


def export_torch_generator(params: dict, h=None) -> dict:
    """JAX Generator params -> a reference-layout ``state_dict`` of numpy
    arrays, the inverse of :func:`convert_torch_generator`: weight-normed
    params ({'v','g'}) give ``weight_v``/``weight_g``, folded ones
    ({'kernel'}) a plain ``weight``."""
    out: dict[str, np.ndarray] = {}

    def emit(torch_key: str, leaf: dict, transposed: bool) -> None:
        kern = np.asarray(leaf.get("v", leaf.get("kernel")))
        if transposed:
            tr, g_shape = (1, 2, 0), (-1, 1, 1)  # (K,I,O) -> (I,O,K)
        else:
            tr = (2, 1, 0) if kern.ndim == 3 else (3, 2, 0, 1)
            g_shape = (-1,) + (1,) * (kern.ndim - 1)
        if "v" in leaf and "g" in leaf:
            out[f"{torch_key}.weight_v"] = np.transpose(kern, tr)
            out[f"{torch_key}.weight_g"] = np.asarray(leaf["g"]).reshape(g_shape)
        else:
            out[f"{torch_key}.weight"] = np.transpose(kern, tr)
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
    return out


def save_torch_generator(filepath: str, params: dict, h=None) -> None:
    """Write a reference-compatible ``g_*`` checkpoint (``{'generator':
    state_dict}``, torch.save zip)."""
    state_dict = {k: torch.from_numpy(np.array(v))
                  for k, v in export_torch_generator(params, h).items()}
    torch.save({"generator": state_dict}, filepath)


def _convert_disc_stack(state_dict: dict) -> tuple[dict, dict]:
    """MPD/MSD keys discriminators.{i}.convs.{j}.* / .conv_post.* -> params
    and spectral trees."""
    params: dict = {}
    spectral: dict = {}
    pat = re.compile(r"^discriminators\.(\d+)\.(convs\.(\d+)|conv_post)\.(.+)$")
    # spectral_norm's 1-D weight_v buffer collides with weight_norm's weight_v
    spectral_mods = {k[: -len(".weight_orig")] for k in state_dict if k.endswith(".weight_orig")}
    for key, w in state_dict.items():
        if key.endswith(".weight_v") and key[: -len(".weight_v")] in spectral_mods:
            continue
        m = pat.match(key)
        if not m:
            raise KeyError(f"unrecognised discriminator key: {key}")
        disc_i, _conv, conv_j, pname = m.groups()
        mod = f"convs_{conv_j}" if conv_j is not None else "conv_post"
        _convert_conv_entry(params, [f"discriminators_{disc_i}", mod], pname,
                            np.asarray(_numpy_tree(w)), transposed=False)

    def hoist(node: dict, spec_node: dict) -> None:
        for k in list(node.keys()):
            if k == "__u":
                spec_node["u"] = node.pop(k)
            elif isinstance(node[k], dict):
                spec_node.setdefault(k, {})
                hoist(node[k], spec_node[k])
                if not spec_node[k]:
                    del spec_node[k]

    hoist(params, spectral)
    return params, spectral


def convert_torch_discriminators(do_ckpt: dict) -> dict:
    """Reference ``do_*`` checkpoint -> {'mpd': vars, 'msd': vars} (and its
    steps, epoch)."""
    out = {}
    for name in ("mpd", "msd"):
        if name in do_ckpt:
            params, spectral = _convert_disc_stack(do_ckpt[name])
            variables: dict = {"params": params}
            if spectral:
                variables["spectral"] = spectral
            out[name] = variables
    for extra in ("steps", "epoch"):
        if extra in do_ckpt:
            out[extra] = do_ckpt[extra]
    return out


def _l2n(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return x / (np.linalg.norm(x) + eps)


def export_torch_discriminators(mpd_vars: dict, msd_vars: dict, steps: int = 0,
                                epoch: int = 0) -> dict:
    """{'mpd','msd'} variables -> a reference-layout ``do_*`` dict (numpy),
    the inverse of :func:`convert_torch_discriminators`. Spectral-normed
    convs give ``weight_orig``, ``weight_u`` and the power-iteration vector
    ``weight_v = l2n(W_matᵀ u)``; no optimizer state."""

    def emit_stack(variables: dict) -> dict:
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
        return out

    return {"mpd": emit_stack(mpd_vars), "msd": emit_stack(msd_vars), "steps": int(steps),
            "epoch": int(epoch)}


def save_torch_discriminators(filepath: str, mpd_vars: dict, msd_vars: dict, steps: int = 0,
                              epoch: int = 0) -> None:
    """Write a reference-compatible ``do_*`` checkpoint (torch.save zip)."""
    do = export_torch_discriminators(mpd_vars, msd_vars, steps=steps, epoch=epoch)
    for name in ("mpd", "msd"):
        do[name] = {k: torch.from_numpy(np.array(v)) for k, v in do[name].items()}
    torch.save(do, filepath)


def _float_tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def generator_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX Generator params (``{'params': ...}`` or the inner dict) -> torch state_dict."""
    return _float_tensors(export_torch_generator(params.get("params", params)))


def discriminator_state_dict_from_jax(mpd_vars: dict, msd_vars: dict) -> dict[str, dict]:
    """JAX MPD/MSD variables (``{'params': ..., 'spectral': ...}``) ->
    ``{'mpd': state_dict, 'msd': state_dict}`` for the port's modules."""
    do = export_torch_discriminators(mpd_vars, msd_vars)
    return {"mpd": _float_tensors(do["mpd"]), "msd": _float_tensors(do["msd"])}


# ---------------------------------------------------------------------------
# distillation models (DSL modules)
# ---------------------------------------------------------------------------

DISTILL_MODELS = ("encoder", "decoder", "discriminator", "keepers", "hunters", "sniffers")
_GROUPED = ("keepers", "hunters", "sniffers")


def _dsl_to_torch(name: str, ndim: int) -> tuple:
    """The transpose of a DSL conv's JAX kernel to torch's layout: 2-D convs
    (``*_conv2``) (KH, KW, I, O) -> (O, I, KH, KW), transposed ones
    (``*_trans``) (K, I, O) -> (I, O, K), the rest (K, I, O) -> (O, I, K)."""
    if ndim == 4:
        return (3, 2, 0, 1)
    return (1, 2, 0) if name.endswith("_trans") else (2, 1, 0)


def _dsl_to_jax(name: str, ndim: int) -> tuple:
    """Inverse of :func:`_dsl_to_torch`."""
    if ndim == 4:
        return (2, 3, 1, 0)
    return (2, 0, 1) if name.endswith("_trans") else (2, 1, 0)


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
        kern = np.asarray(leaf.get("v", leaf.get("kernel")))
        tr = _dsl_to_torch(name, kern.ndim)
        if "v" in leaf:
            out[f"{key}.weight_v"] = np.transpose(kern, tr)
            out[f"{key}.weight_g"] = np.asarray(leaf["g"]).reshape((-1,) + (1,) * (kern.ndim - 1))
        elif u is not None:
            w_t = np.transpose(kern, tr)
            u = np.asarray(u).reshape(-1)
            out[f"{key}.weight_orig"] = w_t
            out[f"{key}.weight_u"] = u
            out[f"{key}.weight_v"] = _l2n(w_t.reshape(w_t.shape[0], -1).T @ u)
        else:
            out[f"{key}.weight"] = np.transpose(kern, tr)
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
                leaf["v"] = np.transpose(val, _dsl_to_jax(name, val.ndim))
            elif attr == "weight_g":
                leaf["g"] = val.reshape(-1)
            elif attr in ("weight_orig", "weight"):
                leaf["kernel"] = np.transpose(val, _dsl_to_jax(name, val.ndim))
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


# ---------------------------------------------------------------------------
# whole train states, in the JAX trainer's state-dict layout
# ---------------------------------------------------------------------------


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params_tree(module, tensors) -> dict:
    """Tensors aligned with ``module.parameters()`` -> the JAX module's
    params tree of those tensors (moments, gradients: the layout of its
    parameters)."""
    sd = {name: t for (name, _), t in zip(module.named_parameters(), tensors)}
    return dsl_variables_to_jax(sd)["params"]


def _params_tensors(module, tree: dict) -> list:
    """Inverse of :func:`_params_tree` (numpy arrays, in ``parameters()`` order)."""
    spectral = dsl_variables_to_jax(module.state_dict()).get("spectral", {})
    sd = dsl_state_dict_from_jax({"params": tree, "spectral": spectral})
    return [sd[name] for name, _ in module.named_parameters()]


def _split(modules: list, tensors: list) -> list:
    """A group's flat tensor list -> one list per module of the group."""
    out, at = [], 0
    for m in modules:
        n = len(list(m.parameters()))
        out.append(tensors[at:at + n])
        at += n
    return out


def _group_tree(keys: list, modules: list, tensors: list) -> dict:
    return {k: _params_tree(m, ts) for k, m, ts in zip(keys, modules, _split(modules, tensors))}


def _group_tensors(keys: list, modules: list, tree: dict) -> list:
    return [t for k, m in zip(keys, modules) for t in _params_tensors(m, tree[k])]


def _opt_to_jax(opt, to_tree) -> dict:
    inner = {"count": np.asarray(opt.count, np.int32), "mu": to_tree(opt.mu),
             "nu": to_tree(opt.nu), "nu_max": to_tree(opt.nu_max)}
    return {"count": np.asarray(opt.count, np.int32),
            "hyperparams": {"learning_rate": np.asarray(opt.learning_rate, np.float32)},
            "hyperparams_states": {}, "inner_state": {"0": inner, "1": {}, "2": {}}}


@torch.no_grad()
def _copy_into(dst: list, src: list) -> None:
    for d, s in zip(dst, src):
        d.copy_(_f32(s).reshape(d.shape))


def _opt_from_jax(opt, tree: dict, to_tensors) -> None:
    inner = tree["inner_state"]["0"]
    opt.count = int(inner["count"])
    opt.learning_rate = float(np.float32(tree["hyperparams"]["learning_rate"]))
    for name in ("mu", "nu", "nu_max"):
        _copy_into(getattr(opt, name), to_tensors(inner[name]))


def _group_modules(state, group: str) -> tuple[list, list]:
    from hifigan_tpu_torch.distill.model import expand_group_paths

    mods = state.models.modules()
    paths = expand_group_paths(group, mods)
    modules = []
    for path in paths:
        node = mods
        for p in path:
            node = node[p]
        modules.append(node)
    return ["/".join(p) for p in paths], modules


def _module_variables(module) -> dict:
    return dsl_variables_to_jax(module.state_dict())


def distill_train_state_to_jax(state) -> dict:
    """A port ``DistillTrainState`` -> the JAX trainer's state dict (numpy)."""
    opt_states, accum = {}, {}
    for g, opt in state.optimizers.items():
        keys, modules = _group_modules(state, g)
        opt_states[g] = _opt_to_jax(opt, lambda ts, k=keys, m=modules: _group_tree(k, m, ts))
        accum[g] = _group_tree(keys, modules, state.grad_accum[g])
    return {"step": np.asarray(state.step, np.int32),
            "variables": distill_variables_to_jax(distill_state_dicts(state.models)),
            "disc_copy": _module_variables(state.disc_copy),
            "hunter_copies": {k: _module_variables(h) for k, h in state.hunter_copies.items()},
            "opt_states": opt_states, "grad_accum": accum}


@torch.no_grad()
def load_distill_train_state(state, tree: dict):
    """Load a JAX-layout distill train-state dict (numpy leaves) into the
    port's ``state`` in place; returns ``state``."""
    state.step = int(tree["step"])
    load_distill_variables(state.models, distill_variables_from_jax(tree["variables"]))
    state.disc_copy.load_state_dict({k: _f32(v) for k, v in
                                     dsl_state_dict_from_jax(tree["disc_copy"]).items()})
    for k, h in state.hunter_copies.items():
        h.load_state_dict({n: _f32(v) for n, v in
                           dsl_state_dict_from_jax(tree["hunter_copies"][k]).items()})
    for g, opt in state.optimizers.items():
        keys, modules = _group_modules(state, g)
        _opt_from_jax(opt, tree["opt_states"][g],
                      lambda t, k=keys, m=modules: _group_tensors(k, m, t))
        _copy_into(state.grad_accum[g], _group_tensors(keys, modules, tree["grad_accum"][g]))
    return state


def sniffer_state_to_jax(state) -> dict:
    """A port ``SnifferTrainState`` -> the JAX sniffer trainer's state dict."""
    return {"step": np.asarray(state.step, np.int32),
            "variables": _module_variables(state.sniffer),
            "opt_state": _opt_to_jax(state.optimizer,
                                     lambda ts: _params_tree(state.sniffer, ts))}


@torch.no_grad()
def load_sniffer_state(state, tree: dict):
    """Load a JAX-layout sniffer train-state dict into ``state`` in place."""
    state.step = int(tree["step"])
    state.sniffer.load_state_dict({k: _f32(v) for k, v in
                                   dsl_state_dict_from_jax(tree["variables"]).items()})
    _opt_from_jax(state.optimizer, tree["opt_state"],
                  lambda t: _params_tensors(state.sniffer, t))
    return state
