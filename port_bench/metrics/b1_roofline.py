"""``b1_roofline.<kind>``: kernel B1 (the fused MRF stage,
``ops/resblock_tail.py`` -> ``csrc/resblock_tail.cu``), in %: the least time
of every B1 call the window made (``costs.kernels.b1_bound_ms``: each stage's
MRF work and bytes at the serving precision's peak, conv_post where it is
folded) over B1's profiled device time. A streaming step's calls are
counted at the rows they emit, not the context rows they recompute."""

from __future__ import annotations

import torch

from port_bench.costs.kernels import b1_bound_ms

KERNEL = r"mrf_stage_\w*kernel"


def read(ctx) -> float | None:
    seconds = ctx.trace.kernel_seconds(KERNEL)
    calls: dict = {}
    for u in ctx.window.units:
        for call in u.work.get("b1", ()):
            calls[call] = calls.get(call, 0) + 1
    if seconds <= 0 or not calls:
        return None
    h = ctx.run.h
    dtype = getattr(torch, h["serve_dtype"])
    bound_ms = sum(n * b1_bound_ms(h, batch, frames, dtype, post)
                   for (batch, frames, post), n in calls.items())
    return 100.0 * bound_ms * 1e-3 / seconds
