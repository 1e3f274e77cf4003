"""Low-latency vocoder with every MRF stage in the fused kernel.

PyTorch port of ``hifigan_tpu/models/fast_infer.py::make_fast_vocoder``:
conv_pre, the leaky ReLUs and the ConvTranspose1d upsamplers run as torch
ops; every stage's MRF goes through
:func:`hifigan_tpu_torch.ops.resblock_tail.fused_tail_stage`; conv_post is
folded into the last stage's kernel unless ``fold_post=False``; with
``fold_up=True`` the stages :func:`folds_upsampler` names take their leaky
ReLU and upsampler into the kernel too.
"""

from __future__ import annotations

from typing import Any

import torch

from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, conv1d, conv_transpose1d, leaky_relu
from hifigan_tpu_torch.ops.resblock_tail import (
    fused_tail_stage,
    pack_generator_tail,
    prepare_post,
    prepare_upsample,
)


def folds_upsampler(h: Any, stage: int) -> bool:
    """Whether ``fold_up=True`` folds stage ``stage``'s upsampler, as the
    JAX package chooses: its kernel folds time into 128 / C lanes and takes
    the upsampler where the input's lanes match, which is stride 2 with a
    time block the stride divides (stages 2 and 3 of V1 and V2, no V3
    stage). The CUDA kernel takes any stride; the choice is kept so both
    packages fold the same stages."""
    u = h["upsample_rates"][stage]
    ch = h["upsample_initial_channel"] // 2 ** (stage + 1)
    block = max(128 // ch, 1)
    return u == 2 and block % u == 0


def make_fast_vocoder(h: Any, folded_state_dict: dict, dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device | None = None, fold_post: bool = True,
                      fold_up: bool = False):
    """(h, folded state_dict) -> fn(mel (B, M, T)) -> wav (B, 1, T * hop) float32.

    Weights are packed once onto ``device`` (CUDA unless the caller passes
    another; with no GPU that raises). Every stage's MRF runs in the
    kernel: the JAX package's ``max_fused_ch`` / ``min_fused_stage`` exist
    for the TPU's VMEM, and the CUDA kernel takes any width. Each stage is
    one cooperative launch that walks the whole sequence conv by conv (bf16
    tensor cores, or 3xTF32 in fp32).
    ``fold_up`` runs the leaky ReLU and the upsampler of the stages
    :func:`folds_upsampler` names inside their kernel launch (off by default,
    as in the JAX package).
    """
    dev = resolve_device(device)
    num_stages = len(h["upsample_rates"])

    def param(name: str) -> torch.Tensor:
        return folded_state_dict[name].detach().to(device=dev, dtype=dtype)

    # torch layouts -> the ops' (K, I, O)
    pre_w, pre_b = param("conv_pre.weight").permute(2, 1, 0), param("conv_pre.bias")
    ups = [(param(f"ups.{i}.weight").permute(2, 0, 1), param(f"ups.{i}.bias"))
           for i in range(num_stages)]
    post_w, post_b = param("conv_post.weight").permute(2, 1, 0), param("conv_post.bias")

    stages = []
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        pre = (prepare_upsample(folded_state_dict, i, u, (k - u) // 2, dtype=dtype, device=dev)
               if fold_up and folds_upsampler(h, i) else None)
        stages.append((u, k, pack_generator_tail(h, folded_state_dict, i, dtype=dtype, device=dev),
                       pre))
    post_pack = prepare_post(folded_state_dict, dtype=dtype, device=dev) if fold_post else None

    @torch.no_grad()
    def fn(mel: torch.Tensor) -> torch.Tensor:
        x = mel.to(device=dev, dtype=dtype).transpose(1, 2)
        x = conv1d(x, pre_w, pre_b, padding=3)
        for i, (u, k, packed, pre) in enumerate(stages):
            if pre is None:
                x = leaky_relu(x, LRELU_SLOPE)
                up_w, up_b = ups[i]
                x = conv_transpose1d(x, up_w, up_b, stride=u, padding=(k - u) // 2)
            last_post = post_pack if i == num_stages - 1 else None
            x = fused_tail_stage(x.contiguous(), packed, post_pack=last_post, pre_pack=pre)
        if post_pack is not None:
            return x.transpose(1, 2)  # tail already folded in the kernel
        x = conv1d(leaky_relu(x, 0.01), post_w, post_b, padding=3)
        return torch.tanh(x).float().transpose(1, 2)

    return fn
