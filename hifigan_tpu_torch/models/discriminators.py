"""Multi-period and multi-scale discriminators (PyTorch port of
``hifigan_tpu/models/discriminators.py``).

- DiscriminatorP: reflect-pad the waveform to a multiple of the period,
  (B, T) -> (B, T/p, p, 1), five (5, 1)-kernel conv2d layers (the first four
  with stride (3, 1)), conv_post (3, 1) -> 1.
- MultiPeriodDiscriminator: periods (2, 3, 5, 7, 11).
- DiscriminatorS: conv_0 (k15) then six grouped conv1d layers and conv_post.
- MultiScaleDiscriminator: three scales, ``avg_pool1d(4, 2, padding=2)``
  between them (8192 -> 4097 -> 2049 samples), spectral norm on scale 0.

Waveforms are (B, T); feature maps come out channels-last, (B, T, C) and
(B, H, W, C), the JAX package's layout. Parameter names are the reference
state_dict's (``discriminators.0.convs.1.weight_v``, ``...conv_post.bias``;
``weight_orig``/``weight_u``/``weight_v`` on the spectral scale), so a
reference ``do_*`` loads with ``load_state_dict``. ``dtype`` is the compute
dtype of the convs (``disc_compute_dtype``); parameters stay float32.

``DiscriminatorS.conv_impl``:

- ``'xla'``: every layer as a PyTorch conv (the JAX package's name for its
  per-layer path, kept so ``msd_conv_impl`` means the same in a config);
- ``'fused_stack'``: conv_0 in PyTorch, layers 1-6 and conv_post through
  :func:`hifigan_tpu_torch.ops.conv_stack.fused_conv_stack` (the CUDA
  kernels on a CUDA tensor);
- ``'pallas'``: every layer, conv_0 and conv_post included, through
  :func:`hifigan_tpu_torch.ops.msd_conv.msd_conv1d_lrelu` with the leaky
  ReLU fused (``NormConv1d.fused_nwc``; the CUDA kernels on a CUDA tensor);
  the feature maps are the same post-activation tensors as ``'xla'``'s;
- ``'auto'``: ``'fused_stack'`` on CUDA, ``'xla'`` on the CPU.

The parameters do not depend on ``conv_impl``: a ``do_*`` written under one
loads under another. ``'fused_zoned'`` (a TPU lane layout whose feature maps
change the feature-loss divisor) raises, as does ``fused=True`` (one 2B pass
of real and fake, which the JAX package keeps off as a measured
pessimization).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from hifigan_tpu_torch.models.layers import NormConv1d, NormConv2d
from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, avg_pool1d, conv1d, leaky_relu, reflect_pad_1d
from hifigan_tpu_torch.ops.conv_stack import LayerSpec, fused_conv_stack

CONV_IMPLS = ("auto", "xla", "fused_stack", "pallas")


def _no_fused(fused: bool) -> None:
    if fused:
        raise NotImplementedError("fused=True (one 2B real+fake pass) is not ported: the JAX "
                                  "package keeps it off as a measured pessimization")


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 use_spectral_norm: bool = False, channels: Sequence[int] = (32, 128, 512, 1024),
                 dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        norm = "spectral" if use_spectral_norm else "weight"
        self.period, self.dtype = period, dtype
        chans = [1, *channels]
        self.convs = nn.ModuleList(
            NormConv2d(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1), (2, 0), norm=norm,
                       generator=generator)
            for i in range(len(channels))
        )
        self.convs.append(NormConv2d(chans[-1], chans[-1], (kernel_size, 1), (1, 1), (2, 0),
                                     norm=norm, generator=generator))
        self.conv_post = NormConv2d(chans[-1], 1, (3, 1), (1, 1), (1, 0), norm=norm,
                                    generator=generator)

    def forward(self, x: torch.Tensor, update_spectral: bool = False):
        """x (B, T) -> (logits (B, -1), fmaps (B, H, W, C) per layer)."""
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = reflect_pad_1d(x, (0, n_pad))
            t += n_pad
        x = x.reshape(b, t // self.period, self.period, 1)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv.nhwc(x, update_spectral, self.dtype), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post.nhwc(x, update_spectral, self.dtype)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 channels: Sequence[int] = (32, 128, 512, 1024),
                 dtype: torch.dtype | None = None, fused: bool = False,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        _no_fused(fused)
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, channels=channels, dtype=dtype, generator=generator)
            for p in periods
        )

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_spectral: bool = False):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            y_d_r, fmap_r = d(y, update_spectral)
            y_d_g, fmap_g = d(y_hat, update_spectral)
            y_d_rs.append(y_d_r)
            y_d_gs.append(y_d_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class DiscriminatorS(nn.Module):
    def __init__(self, use_spectral_norm: bool = False, width: int = 128,
                 dtype: torch.dtype | None = None, conv_impl: str = "auto",
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        if conv_impl == "fused_zoned":
            raise NotImplementedError("conv_impl='fused_zoned' is not ported: it is a TPU lane "
                                      "layout whose feature maps change the loss divisor")
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}; expected one of {CONV_IMPLS}")
        norm = "spectral" if use_spectral_norm else "weight"
        self.dtype, self.conv_impl = dtype, conv_impl
        w = width
        # (features, kernel, stride, groups, padding): reference src/models.py:195-203
        self.specs = [(w, 15, 1, 1, 7), (w, 41, 2, 4, 20), (w * 2, 41, 2, 16, 20),
                      (w * 4, 41, 4, 16, 20), (w * 8, 41, 4, 16, 20), (w * 8, 41, 1, 16, 20),
                      (w * 8, 5, 1, 1, 2)]
        c_in = [1] + [s[0] for s in self.specs[:-1]]
        self.convs = nn.ModuleList(
            NormConv1d(ci, ch, k, stride=s, padding=p, groups=g, norm=norm, generator=generator)
            for ci, (ch, k, s, g, p) in zip(c_in, self.specs)
        )
        self.conv_post = NormConv1d(w * 8, 1, 3, padding=1, norm=norm, generator=generator)

    def resolve_impl(self, x: torch.Tensor) -> str:
        if self.conv_impl == "auto":
            return "fused_stack" if x.device.type == "cuda" else "xla"
        return self.conv_impl

    def forward(self, x: torch.Tensor, update_spectral: bool = False, weight_grads: bool = True,
                pair: torch.Tensor | None = None):
        """x (B, T) -> (logits (B, -1), fmaps); with ``pair`` (a second
        waveform of x's shape) -> ((logits, fmaps), (logits2, fmaps2)), the
        weights (and the spectral power iteration) computed once for both
        (once per input under ``'pallas'``, as each JAX conv call does).
        ``weight_grads=False`` declares the weights constant in this call:
        the fused path then does no weight-gradient work."""
        b = x.shape[0]
        xs = [x[..., None]] if pair is None else [x[..., None], pair[..., None]]
        dtype = self.dtype or x.dtype
        impl = self.resolve_impl(x)
        if impl == "pallas":
            results = []
            for h in xs:
                fmap = []
                for conv in self.convs:
                    h = conv.fused_nwc(h, LRELU_SLOPE, update_spectral, dtype)
                    fmap.append(h)
                h = self.conv_post.fused_nwc(h, 1.0, update_spectral, dtype)
                fmap.append(h)
                results.append((h.reshape(b, -1), fmap))
            return results[0] if pair is None else tuple(results)
        layers = [conv.kernel_nwc(update_spectral, dtype)
                  for conv in [*self.convs, self.conv_post]]
        specs = [*self.specs, (1, 3, 1, 1, 1)]
        if impl == "fused_stack":
            (k0, b0), (_, _, _, _, p0) = layers[0], specs[0]
            hs = [leaky_relu(conv1d(h.to(dtype), k0, b0, padding=p0), LRELU_SLOPE).contiguous()
                  for h in xs]
            stack_specs = [LayerSpec(ch, k, s, g, p, p, LRELU_SLOPE)
                           for ch, k, s, g, p in specs[1:-1]] + [LayerSpec(1, 3, 1, 1, 1, 1, 1.0)]
            ys_multi = fused_conv_stack(hs, [kb[0] for kb in layers[1:]],
                                        [kb[1] for kb in layers[1:]], stack_specs,
                                        weight_grads=weight_grads)
            results = [(ys[-1].reshape(b, -1), [h, *ys]) for h, ys in zip(hs, ys_multi)]
        else:
            results = []
            for h in xs:
                h = h.to(dtype)
                fmap = []
                for i, ((kern, bias), (_, _, s, g, p)) in enumerate(zip(layers, specs)):
                    h = conv1d(h, kern, bias, stride=s, padding=p, groups=g)
                    if i < len(self.specs):  # conv_post has no activation
                        h = leaky_relu(h, LRELU_SLOPE)
                    fmap.append(h)
                results.append((h.reshape(b, -1), fmap))
        return results[0] if pair is None else tuple(results)


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, width: int = 128, num_scales: int = 3, dtype: torch.dtype | None = None,
                 fused: bool = False, conv_impl: str = "auto",
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        _no_fused(fused)
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=i == 0, width=width, dtype=dtype,
                           conv_impl=conv_impl, generator=generator)
            for i in range(num_scales)
        )

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_spectral: bool = False,
                weight_grads: bool = True):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i:
                y = avg_pool1d(y[..., None], 4, 2, padding=2)[..., 0]
                y_hat = avg_pool1d(y_hat[..., None], 4, 2, padding=2)[..., 0]
            if i == 0 and update_spectral:
                # the power iteration advances once per traversal (torch's
                # hook iterates on every forward): no shared call here
                (y_d_r, fmap_r), (y_d_g, fmap_g) = (d(y, update_spectral, weight_grads),
                                                    d(y_hat, update_spectral, weight_grads))
            else:
                (y_d_r, fmap_r), (y_d_g, fmap_g) = d(y, update_spectral, weight_grads,
                                                     pair=y_hat)
            y_d_rs.append(y_d_r)
            y_d_gs.append(y_d_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
