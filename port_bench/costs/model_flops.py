"""Model FLOP per request or train step, counted over the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` runs the reference on meta
tensors (no memory, no device) and counts the FLOP of every convolution and
matrix product, forward and backward, as a plain implementation does them.
So the count depends only on the model and the shapes, whatever implements
the work; an MFU built on it cannot pass 100% when a kernel changes. FFTs
are not counted (no formula is registered for them).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.discriminators import conv_shapes as disc_shapes
from port_bench.reference.generator import conv_shapes as gen_shapes
from port_bench.reference.generator import generator
from port_bench.reference.train_step import new_state, train_step


def _meta_params(shapes: dict, fold: bool) -> dict:
    out = {}
    for name, c in shapes.items():
        if c.norm == "spectral":
            out[f"{name}.weight_orig"] = torch.empty(c.shape, device="meta")
        elif fold:
            out[f"{name}.weight"] = torch.empty(c.shape, device="meta")
        else:
            out[f"{name}.weight_v"] = torch.empty(c.shape, device="meta")
            out[f"{name}.weight_g"] = torch.empty((c.shape[0],) + (1,) * (len(c.shape) - 1),
                                                  device="meta")
        out[f"{name}.bias"] = torch.empty(c.bias, device="meta")
    return out


def generator_flops(h: Any, frames: int, batch: int = 1) -> int:
    """FLOP of one forward of the Generator over ``batch`` x ``frames`` mel frames."""
    params = _meta_params(gen_shapes(h), fold=True)
    mel = torch.empty((batch, h["num_mels"], frames), device="meta")
    with FlopCounterMode(display=False) as counter:
        generator(h, params, mel)
    return counter.get_total_flops()


def train_step_flops(h: Any, batch: int, segment: int) -> int:
    """FLOP of one GAN train step at ``batch`` x ``segment``: both updates,
    forward and backward (the optimizers' elementwise work is not counted)."""
    params = {f"generator.{k}": v for k, v in _meta_params(gen_shapes(h), fold=False).items()}
    d_shapes = disc_shapes(h)
    params.update(_meta_params(d_shapes, fold=False))
    buffers = {}
    for name, c in d_shapes.items():
        if c.norm == "spectral":
            buffers[f"{name}.weight_u"] = torch.empty((c.shape[0],), device="meta")
            buffers[f"{name}.weight_v"] = torch.empty((math.prod(c.shape[1:]),), device="meta")
    state = new_state(h, params, buffers)
    audio = torch.empty((batch, segment), device="meta")
    mel = torch.empty((batch, h["num_mels"], segment // h["hop_size"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        train_step(h, state, audio, mel)
    return counter.get_total_flops()
