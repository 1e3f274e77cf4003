"""``b2_roofline.<kind>``: kernel B2 (the MSD conv stack,
``ops/conv_stack.py`` -> ``csrc/conv_stack.cu`` + ``conv_core.cuh``), in %:
the least time of the window's conv-stack passes (``costs.kernels.
b2_step_bound_ms``: 4 forward, 3 dx, 2 dW passes of each MSD scale a step,
fp32 as 3xTF32) over the device time of the conv-stack kernels (the conv
core's kernels and the stack's dz kernel; in a V1 train step nothing else
launches them)."""

from __future__ import annotations

from port_bench.costs.kernels import b2_step_bound_ms

KERNEL = r"conv_core::\w+_kernel|dz_kernel"


def read(ctx) -> float | None:
    seconds = ctx.trace.kernel_seconds(KERNEL)
    steps = [u.work for u in ctx.window.units if u.work.get("train_steps")]
    if seconds <= 0 or not steps:
        return None
    bound_ms = sum(w["train_steps"] * b2_step_bound_ms(ctx.run.h, w["batch"], w["segment"])
                   for w in steps)
    return 100.0 * bound_ms * 1e-3 / seconds
