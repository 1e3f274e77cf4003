"""Config canonicalisation for the DSL interpreter (a copy of
``hifigan_tpu/dsl/normalize.py``).

The reference config language distinguishes *lists* (sequential) from
*tuples* (nodes) (configurable_module.py:35-42). flax freezes module
attributes (lists become tuples), which would destroy that distinction — so
configs are normalised at module construction into an explicit form:

    sequence:  ('#seq', (cfg, cfg, ...))
    node:      ('#node', name, params, tags)

Params that themselves contain configs (fusion/sum/ensemble/list/dict/
recursive/res/sub_res/fmap/pfmap/all_in_one_*/encoder/decoder) are
normalised recursively; all other params pass through untouched (lists in
plain params are tupled for hashability).
"""

from __future__ import annotations

from collections.abc import Mapping

from typing import Any

SEQ = "#seq"
NODE = "#node"

# nodes whose params embed sub-configs, by shape of the params
_CONFIG_LIST_NODES = {"fusion", "sum", "ensemble", "list"}
_CONFIG_NODES = {"res", "sub_res"}


def is_normalized(cfg: Any) -> bool:
    return isinstance(cfg, tuple) and len(cfg) > 0 and cfg[0] in (SEQ, NODE)


def _tuplify(p: Any) -> Any:
    """Freeze plain (non-config) params: lists/dicts -> tuples/dict copies."""
    if isinstance(p, (list, tuple)):
        return tuple(_tuplify(v) for v in p)
    if isinstance(p, Mapping):
        return {k: _tuplify(v) for k, v in p.items()}
    return p


def _normalize_params(name: str, p: Any) -> Any:
    if name in _CONFIG_LIST_NODES:
        return tuple(normalize_config(c) for c in p)
    if name in _CONFIG_NODES:
        return normalize_config(p)
    if name == "dict":
        return {k: normalize_config(c) for k, c in p.items()}
    if name == "recursive":
        return _normalize_recursive(p)
    if name == "fmap":
        sub, tags = p
        return (normalize_config(sub), tuple(tags))
    if name == "pfmap":
        sub, tags, feature_models = p
        return (
            normalize_config(sub),
            tuple(tags),
            tuple(normalize_config(c) for c in feature_models),
        )
    if name in ("all_in_one_block", "all_in_one_discriminator"):
        before, raws, after = p
        return (
            normalize_config(before),
            tuple(normalize_config(c) for c in raws),
            normalize_config(after),
        )
    if name == "encoder":
        vo, splitters = p
        return (normalize_config(vo), tuple(normalize_config(c) for c in splitters))
    if name == "decoder":
        mergers, vo = p
        return (tuple(normalize_config(c) for c in mergers), normalize_config(vo))
    return _tuplify(p)


RLIST = "#rlist"  # structural list inside 'recursive' params (not sequential)


def _normalize_recursive(p: Any) -> Any:
    """'recursive' params: arbitrary dict/list nesting with configs at leaves
    (reference get_recursive_modules_from_configs, configurable_module.py:330:
    lists are *structure* mirroring the input pytree, never sequences)."""
    if isinstance(p, Mapping):
        return {k: _normalize_recursive(v) for k, v in p.items()}
    if isinstance(p, list):
        return (RLIST, tuple(_normalize_recursive(v) for v in p))
    # tuples at this level are node configs
    return normalize_config(p)


def normalize_config(cfg: Any) -> Any:
    """Raw reference-style config -> canonical ('#seq'/'#node', ...) form."""
    if is_normalized(cfg):
        return cfg
    if isinstance(cfg, list):
        tags: tuple = ()
        if cfg and isinstance(cfg[-1], list) and cfg[-1] and all(isinstance(t, str) for t in cfg[-1]):
            tags = tuple(cfg[-1])
            cfg = cfg[:-1]
        seq = (SEQ, tuple(normalize_config(c) for c in cfg))
        if tags:
            seq = (NODE, "#tagged", seq, tags)
        return seq
    if isinstance(cfg, tuple):
        tags = ()
        if len(cfg) > 1 and isinstance(cfg[-1], list) and cfg[-1] and all(isinstance(t, str) for t in cfg[-1]):
            tags = tuple(cfg[-1])
            cfg = cfg[:-1]
        name = cfg[0]
        params = cfg[1] if len(cfg) > 1 else None
        return (NODE, name, _normalize_params(name, params) if params is not None else None, tags)
    raise TypeError(f"config node must be list or tuple, got {type(cfg)}: {cfg!r}")
