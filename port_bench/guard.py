"""The import guard: no JAX and no JAX package in a measured process.

A module counts by its top-level name (the part before the first dot),
compared whole: ``hifigan_tpu_torch`` is the port and passes, while
``hifigan_tpu`` and ``hifigan_tpu.models`` are the JAX package and fail.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hifigan_tpu"})


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
