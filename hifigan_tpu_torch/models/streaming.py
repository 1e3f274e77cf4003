"""Stateful streaming vocoder: mel chunks in, waveform chunks out, with
per-stage left-context state instead of receptive-field recompute.

PyTorch port of ``hifigan_tpu/models/streaming.py``. The halo streamer
(:func:`hifigan_tpu_torch.parallel.halo.streaming_vocode`) re-synthesizes a
``chunk + 2 * halo`` window per chunk; this one keeps a small buffer of each
block's last inputs (twice the block's one-sided receptive field, at that
block's rate) so each step computes only the new samples plus that context.

Exactness: every block applies its 'same'-padded ops to ``[buffer, new]``
and emits only interior outputs, which equal whole-utterance synthesis up
to float order. The first ``delay_samples`` emitted samples precede
position 0 (priming: drop them), and the following <= ``delay_samples`` can
differ slightly from whole-utterance synthesis, which zero-pads every
layer's input at t=0 while a streamer only has zero raw history. From
sample ``delay_samples`` on the stream is exact. End of stream: flush by
feeding silence.

With ``use_fast`` (on for a CUDA device) every stage's MRF runs in the
fused stage kernel (:func:`hifigan_tpu_torch.ops.resblock_tail.
fused_tail_stage`), one launch per stage and chunk; otherwise it is the
plain ``ResBlock1``/``ResBlock2`` mean.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.models.generator import Generator
from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, conv1d, conv_transpose1d, leaky_relu
from hifigan_tpu_torch.ops.resblock_tail import fused_tail_stage, pack_generator_tail


def _resblock_halo(h: Any) -> list[int]:
    """One-sided receptive field of each stage's MRF at the stage rate."""
    if str(h["resblock"]) == "1":  # per dilation d: conv(k, d) then conv(k, 1)
        def per(k, ds):
            return sum((k - 1) // 2 * d + (k - 1) // 2 for d in ds)
    else:  # per dilation d: one conv(k, d)
        def per(k, ds):
            return sum((k - 1) // 2 * d for d in ds)
    halo = max(per(k, ds) for k, ds in zip(h["resblock_kernel_sizes"],
                                           h["resblock_dilation_sizes"]))
    return [halo] * len(h["upsample_rates"])


def _tpu_block(ch: int) -> int | None:
    """The time block the JAX package's fused stage folds a width-``ch``
    stage into (None: it leaves that stage's MRF to XLA). The streamer
    rounds the MRF's context up to it, so ``delay_samples`` is the JAX
    package's for the same ``use_fast``."""
    if 128 % ch == 0 or ch % 128 == 0:
        return max(128 // ch, 1)
    return None


class Block(NamedTuple):
    """One step of the static plan: n inputs in, stride * n outputs out."""

    context: int  # R: inputs of history (and of delay) the block needs a side
    fn: Callable[[torch.Tensor], torch.Tensor]  # (B, n + 2R, C) -> its outputs
    channels: int  # of its input
    stride: int = 1  # the upsamplers'


def make_streaming_vocoder(h: Any, folded_state_dict: dict, dtype: torch.dtype = torch.bfloat16,
                           use_fast: bool | None = None,
                           device: str | torch.device | None = None):
    """(init_state, step, delay_samples) for chunked streaming.

    ``step(state, mel_chunk (B, M, F)) -> (state, wav (B, 1, F * hop) float32)``
    is a plain function of its arguments (the state is a list of device
    tensors); outputs stream ``delay_samples`` behind the input frontier.
    Weights go to ``device`` once (CUDA unless the caller passes another;
    with no GPU that raises). ``use_fast`` (default: on for CUDA) routes each
    stage's MRF through the fused stage kernel.
    """
    dev = resolve_device(device)
    if use_fast is None:
        use_fast = dev.type == "cuda"
    num_kernels = len(h["resblock_kernel_sizes"])
    ch0 = h["upsample_initial_channel"]
    mrf_halo = _resblock_halo(h)

    def param(name: str) -> torch.Tensor:
        return folded_state_dict[name].detach().to(device=dev, dtype=dtype)

    # torch layouts -> the ops' (K, I, O)
    pre_w, pre_b = param("conv_pre.weight").permute(2, 1, 0), param("conv_pre.bias")
    post_w, post_b = param("conv_post.weight").permute(2, 1, 0), param("conv_post.bias")
    if use_fast:
        packs = [pack_generator_tail(h, folded_state_dict, i, dtype=dtype, device=dev)
                 for i in range(len(h["upsample_rates"]))]
    else:
        gen = Generator(h, folded=True)
        gen.load_state_dict(folded_state_dict)
        gen = gen.to(device=dev, dtype=dtype).eval()

    def mrf(z: torch.Tensor, i: int) -> torch.Tensor:
        if use_fast:
            return fused_tail_stage(z, packs[i])
        zc = z.transpose(1, 2)
        xs = None
        for j in range(num_kernels):
            out = gen.resblocks[i * num_kernels + j](zc)
            xs = out if xs is None else xs + out
        return (xs / num_kernels).transpose(1, 2)

    ups = [(param(f"ups.{i}.weight").permute(2, 0, 1), param(f"ups.{i}.bias"))
           for i in range(len(h["upsample_rates"]))]

    def upsample(z: torch.Tensor, i: int, u: int, k: int) -> torch.Tensor:
        return conv_transpose1d(leaky_relu(z, LRELU_SLOPE), ups[i][0], ups[i][1], stride=u,
                                padding=(k - u) // 2)

    blocks = [Block(3, lambda z: conv1d(z, pre_w, pre_b, padding=3), h["num_mels"])]
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        ch = ch0 // 2 ** (i + 1)
        blocks.append(Block(-(-k // u), lambda z, i=i, u=u, k=k: upsample(z, i, u, k),
                            2 * ch, u))
        r_mrf = mrf_halo[i]
        block = _tpu_block(ch)
        if use_fast and block is not None:
            r_mrf = -(-r_mrf // block) * block  # a larger context stays exact
        blocks.append(Block(r_mrf, lambda z, i=i: mrf(z, i), ch))
    blocks.append(Block(
        3, lambda z: torch.tanh(conv1d(leaky_relu(z, 0.01), post_w, post_b,
                                             padding=3)).float(),
        ch0 // 2 ** len(h["upsample_rates"])))

    # total output delay in samples: each block's R at its input rate, scaled
    # by the upsampling at and after it
    delay_samples, scale = 0, 1
    for b in reversed(blocks):
        scale *= b.stride
        delay_samples += b.context * scale

    def init_state(batch: int = 1) -> list[torch.Tensor]:
        return [torch.zeros((batch, 2 * b.context, b.channels), dtype=dtype, device=dev)
                for b in blocks]

    @torch.no_grad()
    def step(state: list[torch.Tensor], mel_chunk: torch.Tensor):
        """mel_chunk (B, M, F) -> (new_state, wav (B, 1, F * hop))."""
        x = mel_chunk.to(device=dev, dtype=dtype).transpose(1, 2)
        new_state = []
        for b, buf in zip(blocks, state):
            r, n = b.context, x.shape[1]
            z = torch.cat([buf, x], dim=1)
            y = b.fn(z)
            x = y[:, r * b.stride:(r + n) * b.stride]
            new_state.append(z[:, z.shape[1] - 2 * r:].clone())
        return new_state, x.transpose(1, 2)

    return init_state, step, int(delay_samples)
