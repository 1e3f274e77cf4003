"""Nested-structure utilities (port of ``hifigan_tpu/utils/pytree.py``).

The reference's tree map over parallel nested dict/list/tuple structures
(structure from the FIRST argument, the others indexed in parallel), on
nested dicts of torch tensors and numpy arrays; the migration of pre-vmap
ensemble checkpoints, on restored numpy trees (before any tensor exists).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch


def get_recursive(func: Callable, *data: Any, args: tuple = (), kwargs: dict | None = None,
                  **kwdata: Any) -> Any:
    """Apply ``func`` over parallel nested structures."""
    kwargs = kwargs or {}
    example = data[0] if data else next(iter(kwdata.values()))
    if isinstance(example, Mapping):
        return {key: get_recursive(func, *(d[key] for d in data), args=args, kwargs=kwargs,
                                   **{n: v[key] for n, v in kwdata.items()})
                for key in example}
    if isinstance(example, (list, tuple)):
        seq = [get_recursive(func, *(d[i] for d in data), args=args, kwargs=kwargs,
                             **{n: v[i] for n, v in kwdata.items()})
               for i in range(len(example))]
        return tuple(seq) if isinstance(example, tuple) else seq
    return func(*data, *args, **kwargs, **kwdata)


def do_recursive(func: Callable, *data: Any, args: tuple = (), kwargs: dict | None = None,
                 **kwdata: Any) -> None:
    """Side-effect walk of :func:`get_recursive`."""
    get_recursive(func, *data, args=args, kwargs=kwargs, **kwdata)


def _leaves(tree: Any) -> list:
    """Leaves in key-sorted order (the JAX package's tree order)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _stack(*trees: Any) -> Any:
    if isinstance(trees[0], Mapping):
        return {k: _stack(*(t[k] for t in trees)) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees], axis=0)


def restack_legacy_ensembles(restored: Any, template: Any) -> Any:
    """Migrate pre-vmap ensemble checkpoints to the stacked layout.

    A legacy checkpoint stores each ensemble member as a flat sibling named
    ``{base}_e{i}{inner}`` (member paths ``{base}_e{i}``, the member's own
    root ``m`` dropped); the stacked layout has one ``{base}_ens`` subtree
    with member leaves stacked on axis 0. Given a restored state dict and
    the target template, restack every legacy group the template expects as
    ``_ens``; other keys pass through. Returns a new dict.
    """
    if not isinstance(restored, Mapping) or not isinstance(template, Mapping):
        return restored
    out = dict(restored)
    for key, tsub in template.items():
        if key in out:
            out[key] = restack_legacy_ensembles(out[key], tsub)
            continue
        if not (key.endswith("_ens") and isinstance(tsub, Mapping)):
            continue
        base = key[: -len("_ens")]
        stacked_leaves = _leaves(tsub)
        if not stacked_leaves:
            continue
        n = int(stacked_leaves[0].shape[0])
        members, used = [], []
        for i in range(n):
            member = {}
            for inner in tsub:
                legacy = f"{base}_e{i}{inner[1:]}" if inner.startswith("m") else None
                if legacy is None or legacy not in restored:
                    member = None
                    break
                member[inner] = restored[legacy]
                used.append(legacy)
            if member is None:
                break
            members.append(member)
        if len(members) == n:
            out[key] = _stack(*members)
            for legacy in used:
                out.pop(legacy, None)
    return out


def detach_recursively(tree: Any, cpu: bool = False) -> Any:
    """Every tensor of a nested structure detached (``cpu=True``: also
    moved to the host); other leaves as they are."""

    def detach(x):
        if torch.is_tensor(x):
            x = x.detach()
            return x.cpu() if cpu else x
        return x

    return get_recursive(detach, tree)
