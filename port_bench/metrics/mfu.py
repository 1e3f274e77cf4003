"""``mfu.<kind>``: the whole request's or step's share of the card's peak,
in %: the model FLOP the window completed (``costs.model_flops``, counted
over the plain reference, the same whatever implements the work) over the
traced window's length times the peak at the cell's precision (bf16 989
TFLOP/s for serving; fp32 training at 495 / 3 = 165 TFLOP/s, the
fp32-accurate tensor-core rate). A streaming step counts the frames it is
fed (16 x 32), flush frames included, not the context it recomputes."""

from __future__ import annotations

import torch

from port_bench.costs.kernels import FP32_MMA_FLOPS, peak_flops
from port_bench.costs.model_flops import generator_flops, train_step_flops


def read(ctx) -> float | None:
    h, units = ctx.run.h, ctx.window.units
    window_s = ctx.trace.window_s
    if not units or window_s <= 0:
        return None
    steps = [u.work for u in units if u.work.get("train_steps")]
    if steps:  # every step of a window has one shape
        w = steps[0]
        flop = len(steps) * train_step_flops(h, w["batch"], w["segment"])
        peak = FP32_MMA_FLOPS
    else:
        # every conv's output is T times the frame count long: FLOP are linear in frames
        flop = generator_flops(h, 1) * sum(u.work.get("gen_frames", 0) for u in units)
        peak = peak_flops(getattr(torch, h["serve_dtype"]))
    if flop <= 0:
        return None
    return 100.0 * flop / (window_s * peak)
