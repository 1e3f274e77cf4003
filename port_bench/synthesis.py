"""What the three synthesis drivers share: seeded generator weights, the
system under test (the port's entry point, or the reference in fp8 in its
place), the reference waveforms and the comparison.

The number compared, ``wav_err_ratio``, is a waveform's distance from the
fp32 reference in units of the distance that the configuration's serving
precision by itself causes: ||y - y_ref|| / ||y_bf16 - y_ref||, with y_bf16
the reference with every conv's input and weight rounded to bf16. A cell's
reading is the worst over the waveforms it checks. A sound bf16 path reads
about 1-2.5; an fp8 one, sixteen times coarser, ten times more; a wrong
sample or a lost chunk far more. (The plain relative error ||y - y_ref|| /
||y_ref|| swings by 8x between seeds: with seeded weights the waveform is
mostly a DC offset of random size, and how far rounding carries through the
generator depends on the weights. The ratio divides both out.)
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from port_bench import inputs
from port_bench.reference.generator import conv_shapes, generator
from port_bench.reference.numerics import BY_NAME, FP32, no_tf32

WEIGHTS, DATA = 0, 1  # the run's draw streams


def serve_dtype(h: Any) -> torch.dtype:
    return getattr(torch, h["serve_dtype"])


def generator_weights(run) -> dict:
    """The Generator's folded weights (upstream names) from the run's seed."""
    gen = inputs.generator_for(run.seed, run.device, WEIGHTS)
    params, _ = inputs.conv_weights(conv_shapes(run.h), gen, run.device, fold=True)
    return params


def fast_vocoder(run, params: dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """mel (B, M, T) -> waveform (B, 1, T * hop) on the device: the port's
    ``make_fast_vocoder`` with the configuration's serving settings, or for
    the control the reference in ``serve_control``."""
    h = run.h
    if run.program == "control":
        num = BY_NAME[h["serve_control"]]
        return lambda mel: generator(h, params, mel.to(run.device), num)
    from hifigan_tpu_torch.models import fast_infer

    return fast_infer.make_fast_vocoder(h, params, dtype=serve_dtype(h), device=run.device,
                                        fold_post=h["fold_post"], fold_up=h["fold_up"])


@torch.no_grad()
def reference_wavs(run, params: dict, mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 reference waveform (T * hop,) of one (M, T) mel, and the same
    with the serving precision's rounding (the yardstick of :func:`err_ratio`)."""
    with no_tf32():
        x = mel[None].to(run.device)
        return (generator(run.h, params, x, FP32)[0, 0],
                generator(run.h, params, x, BY_NAME[run.h["serve_dtype"]])[0, 0])


def err_ratio(got, ref: torch.Tensor, rounded: torch.Tensor) -> float:
    """||got - ref|| / ||rounded - ref|| in float64; inf for a missing,
    misshapen or non-finite waveform."""
    if got is None:
        return math.inf
    got = torch.as_tensor(np.asarray(got) if not torch.is_tensor(got) else got)
    got = got.reshape(-1).to(ref.device, torch.float64)
    ref = ref.reshape(-1).to(torch.float64)
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        return math.inf
    scale = (rounded.reshape(-1).to(torch.float64) - ref).norm().clamp_min(1e-30)
    return float((got - ref).norm() / scale)
