"""Kernel costs: frozen copies of ``chip_smoke.py``'s cost functions.

The copies keep their names and arithmetic, so a CPU test holds them equal
to the originals at V1's shapes. Each is counted from shapes: every input
byte read once, every output byte written once; a roofline share is the
bound over the kernel's device time.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s
bf16, 495 TFLOP/s TF32, 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s.
The port's fp32 conv kernels run 3xTF32 (three TF32 products a multiply-add),
so fp32 work on the tensor cores is bounded at 495 / 3 = 165 TFLOP/s.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

H100_BF16_FLOPS, H100_FP32_FLOPS, H100_BYTES_PER_S = 989e12, 67e12, 3.35e12
H100_TF32_FLOPS = 495e12
FP32_MMA_FLOPS = H100_TF32_FLOPS / 3

# Passes of each conv-stack entry point in one V1 train step, per MSD scale:
# the D update runs real and fake forward and backward with weight grads;
# the G update runs both forward again and only the fake one backward, for
# dx alone (the real one gets no gradient, the weights are frozen).
PASSES_PER_STEP = {"fwd": 4, "bwd_dx": 3, "bwd_dw": 2}


def peak_flops(dtype: torch.dtype) -> float:
    """The tensor-core peak that bounds work in ``dtype`` (bf16, or fp32 as 3xTF32)."""
    return H100_BF16_FLOPS if dtype == torch.bfloat16 else FP32_MMA_FLOPS


class StackLayer(NamedTuple):
    """One conv1d (+ leaky ReLU) layer of the MSD conv stack."""

    c_out: int
    kernel: int
    stride: int = 1
    groups: int = 1
    pad_l: int = 0
    pad_r: int = 0
    slope: float = 1.0


def out_len(t: int, spec) -> int:
    return (t + spec.pad_l + spec.pad_r - spec.kernel) // spec.stride + 1


def stage_cost(packed: dict, batch: int, seq: int, esize: int, post: bool,
               pre: dict | None = None) -> tuple[int, int]:
    """(operations, bytes) one stage call must do and move: x and the weights
    read once, the output written once; with a folded upsampler ``pre`` its
    taps' products (ceil(k / stride) input rows of C_in a stage row) and
    weights, x then being the (B, seq / stride, C_in) input."""
    c = packed["channels"]
    taps = sum(k for k, _, _ in packed["convs"])
    ops = 2 * batch * seq * taps * c * c + (2 * batch * seq * 7 * c if post else 0)
    wbytes = (packed["w"].numel() + packed["bias"].numel() + (7 * c + 1 if post else 0)) * esize
    out_bytes = batch * seq * 4 if post else batch * seq * c * esize
    x_bytes = batch * seq * c * esize
    if pre is not None:
        ops += 2 * batch * seq * pre["taps"] * pre["c_in"] * c
        wbytes += (pre["taps"] * pre["stride"] * pre["c_in"] * c + c) * esize
        x_bytes = batch * (seq // pre["stride"]) * pre["c_in"] * esize
    return ops, x_bytes + wbytes + out_bytes


def stack_cost(specs, x: torch.Tensor) -> tuple[int, int, int, int]:
    """(FLOP of one pass, fwd bytes, dx bytes, dW bytes) over input x: each
    pass's inputs read once and outputs written once; dx and dW do the
    forward's multiply-adds again."""
    n, t, c = x.shape
    esize = x.element_size()
    flop, act, wts = 0, 0, 0
    for sp in specs:
        t_out = out_len(t, sp)
        flop += 2 * n * t_out * sp.c_out * sp.kernel * (c // sp.groups)
        act += n * t_out * sp.c_out * esize
        wts += sp.kernel * (c // sp.groups) * sp.c_out * esize + sp.c_out * 4
        t, c = t_out, sp.c_out
    x_bytes = x.numel() * esize
    # fwd: x, W, b -> ys; dx: dys, ys, W -> dx; dW: x, ys, dys -> dW, db
    return flop, x_bytes + wts + act, 2 * act + wts + x_bytes, x_bytes + 2 * act + wts


def _out_lens(t: int, specs) -> list:
    lens = []
    for sp in specs:
        t = out_len(t, sp)
        lens.append(t)
    return lens


def _layer_flops(specs, x: torch.Tensor) -> list:
    n, t, c = x.shape
    out = []
    for sp, t_out in zip(specs, _out_lens(t, specs)):
        out.append(2 * n * t_out * sp.c_out * sp.kernel * (c // sp.groups))
        c = sp.c_out
    return out


def msd_passes(layer: int) -> dict:
    """Passes of MSD conv ``layer`` through the two ``msd_conv1d_lrelu``
    kernels in one V1 train step with ``msd_conv_impl='pallas'``, counted
    from the step's structure: per scale the D update traverses real and
    fake, the G update both again (4 forward). dx: the D update's inputs
    (the waveform and the detached fake) need no gradient, so conv_0 skips
    its dx there; in the G update the weights are frozen, so the real
    traversal has no backward at all and the fake one runs every conv's dx
    (3 dx, 1 for conv_0)."""
    return {"fwd": 4, "bwd_dx": 3 if layer else 1}


def conv_cost(x: torch.Tensor, k: int, ci_g: int, y: torch.Tensor) -> dict:
    """FLOP of one pass and the bytes each pass must move: forward x, W, b
    in and y out; dx dy, y, W in and dx out."""
    esize = x.element_size()
    w = k * ci_g * y.shape[2] * esize
    flop = 2 * y.numel() * k * ci_g
    return {"flop": flop, "fwd": x.numel() * esize + w + y.shape[2] * 4 + y.numel() * esize,
            "bwd_dx": 2 * y.numel() * esize + w + x.numel() * esize}


def bound_ms(flop: float, nbytes: float, peak: float) -> tuple[float, str]:
    ops_ms, bytes_ms = flop / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


# --- the shapes of a cell's kernel calls, from the configuration ---------------


def stage_packs(h: Any) -> list[dict]:
    """Each generator stage's MRF convs in the form :func:`stage_cost` reads
    (channels, (kernel, dilation, offset) per conv, weight and bias counts as
    meta tensors): the shapes of the program's packed stage, from ``h``."""
    packs = []
    is_rb1 = str(h["resblock"]) == "1"
    for i in range(len(h["upsample_rates"])):
        c = h["upsample_initial_channel"] // 2 ** (i + 1)
        convs, off = [], 0
        for k, dil in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            for d in dil:
                for dd in ((d, 1) if is_rb1 else (d,)):
                    convs.append((k, dd, off))
                    off += k * c * c
        packs.append({"channels": c, "convs": convs,
                      "w": torch.empty(off, device="meta"),
                      "bias": torch.empty(len(convs) * c, device="meta")})
    return packs


def b1_bound_ms(h: Any, batch: int, frames: int, dtype: torch.dtype, post: bool) -> float:
    """The least time of the stage calls that synthesise ``batch`` x ``frames``
    mel frames: each stage's MRF at its rate, conv_post folded into the last
    one when ``post``."""
    esize = torch.empty((), dtype=dtype).element_size()
    total, seq = 0.0, frames
    packs = stage_packs(h)
    for i, (u, packed) in enumerate(zip(h["upsample_rates"], packs)):
        seq *= u
        ops, nbytes = stage_cost(packed, batch, seq, esize, post and i == len(packs) - 1)
        total += bound_ms(ops, nbytes, peak_flops(dtype))[0]
    return total


def msd_stack_specs(width: int = 128) -> list[StackLayer]:
    """MSD layers 1-6 and conv_post, the conv-stack kernel's layers."""
    w = width
    layers = [(w, 41, 2, 4, 20), (2 * w, 41, 2, 16, 20), (4 * w, 41, 4, 16, 20),
              (8 * w, 41, 4, 16, 20), (8 * w, 41, 1, 16, 20), (8 * w, 5, 1, 1, 2)]
    specs = [StackLayer(ch, k, s, g, p, p, 0.1) for ch, k, s, g, p in layers]
    return specs + [StackLayer(1, 3, 1, 1, 1, 1, 1.0)]


def msd_scale_lengths(segment: int, scales: int = 3) -> list[int]:
    """Waveform length at each MSD scale: AvgPool1d(4, 2, padding=2) between."""
    out = [segment]
    for _ in range(scales - 1):
        out.append((out[-1] + 4 - 4) // 2 + 1)
    return out


def b2_step_bound_ms(h: Any, batch: int, segment: int) -> float:
    """The least time of the conv-stack passes in one V1 train step (fp32 as
    3xTF32): :data:`PASSES_PER_STEP` of each scale's stack over conv_0's
    output (B, T, width), each pass bounded by its FLOP or its bytes."""
    width = h.get("msd_width", 128)
    specs = msd_stack_specs(width)
    total = 0.0
    for t in msd_scale_lengths(segment, h.get("msd_num_scales", 3)):
        x = torch.empty((batch, t, width), dtype=torch.float32, device="meta")
        flop, b_fwd, b_dx, b_dw = stack_cost(specs, x)
        for kind, nbytes in (("fwd", b_fwd), ("bwd_dx", b_dx), ("bwd_dw", b_dw)):
            total += PASSES_PER_STEP[kind] * bound_ms(flop, nbytes, FP32_MMA_FLOPS)[0]
    return total
