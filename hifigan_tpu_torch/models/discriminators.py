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
- ``'fused_zoned'``: ``'fused_stack'`` with the grouped layers of
  ``g >= zone_min_groups`` (at V1 layers 2-5) run as one zone chain
  (``ops/conv_stack.py::zone_grouped_layer``): the chain's input is folded
  at entry, its layers are banded grouped layers of 128 lanes a group, its
  output is unfolded at exit. The width must be a multiple of 128. The
  chain's feature maps stay in the zone layout, as the JAX package returns
  them: a permutation of the ``'xla'`` maps, plus zeroed fold-padding lanes
  where a length does not divide the fold (the 4097- and 2049-sample
  scales), so a mean over such a map (``feature_loss``) divides by a larger
  count than under ``'xla'``. Logits are the same;
- ``'pallas'``: every layer, conv_0 and conv_post included, through
  :func:`hifigan_tpu_torch.ops.msd_conv.msd_conv1d_lrelu` with the leaky
  ReLU fused (``NormConv1d.fused_nwc``; the CUDA kernels on a CUDA tensor);
  the feature maps are the same post-activation tensors as ``'xla'``'s;
- ``'auto'``: ``'fused_stack'`` on CUDA, ``'xla'`` on the CPU. (The JAX
  package resolves it to ``'fused_zoned'`` on its accelerators; the port
  keeps the maps, and so the loss, of ``'xla'`` unless a config names the
  zoned form.)

``mesh`` / ``mesh_batch_axis`` (``DiscriminatorS``, ``MultiScaleDiscriminator``):
the fused paths call the stack's batch-sharded form
(``fused_conv_stack(mesh=)``): inside a data-parallel step on this rank's
rows, elsewhere split over the axis and gathered back.

``fused=True`` (``MultiPeriodDiscriminator``, ``MultiScaleDiscriminator``;
the config's ``disc_fused``): real and fake are concatenated along the
batch and each sub-discriminator runs once on the 2B rows, its logits and
maps sliced at B, with any ``conv_impl``. On the spectral scale 0 one power
iteration (``update_spectral``) then serves both halves, where the unfused
call runs one per traversal, so the D update's scale-0 weights differ from
the unfused step's: a different result, as in the JAX package.

The parameters do not depend on ``conv_impl`` or ``fused``: a ``do_*``
written under one loads under another.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from hifigan_tpu_torch.models.layers import NormConv1d, NormConv2d
from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, avg_pool1d, conv1d, leaky_relu, reflect_pad_1d
from hifigan_tpu_torch.ops.conv_stack import (
    LayerSpec,
    fold_group_zones,
    fused_conv_stack,
    unfold_group_zones,
    zone_grouped_layer,
)

CONV_IMPLS = ("auto", "xla", "fused_stack", "fused_zoned", "pallas")


def _split_halves(b: int, logits: torch.Tensor, fmap: list) -> tuple:
    """One 2B call's (logits, maps) as the real and fake halves."""
    return (logits[:b], [f[:b] for f in fmap]), (logits[b:], [f[b:] for f in fmap])


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
        self.fused = fused
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, channels=channels, dtype=dtype, generator=generator)
            for p in periods
        )

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_spectral: bool = False):
        b = y.shape[0]
        yy = torch.cat([y, y_hat]) if self.fused else None
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            if self.fused:
                (y_d_r, fmap_r), (y_d_g, fmap_g) = _split_halves(b, *d(yy, update_spectral))
            else:
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
                 generator: torch.Generator | None = None, mesh=None,
                 mesh_batch_axis: str = "data", zone_min_groups: int = 8) -> None:
        super().__init__()
        self.mesh, self.mesh_batch_axis = mesh, mesh_batch_axis
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}; expected one of {CONV_IMPLS}")
        if conv_impl == "fused_zoned" and width % 128:
            raise ValueError(f"conv_impl='fused_zoned' needs a width that is a multiple of 128, "
                             f"got {width}")
        norm = "spectral" if use_spectral_norm else "weight"
        self.dtype, self.conv_impl, self.zone_min_groups = dtype, conv_impl, zone_min_groups
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

    def stack_layers(self) -> list[tuple[int, int, int, int, int, int, float]]:
        """Layers 1-6 and conv_post as (c_in, c_out, kernel, stride, groups,
        padding, slope)."""
        specs = [*self.specs, (1, 3, 1, 1, 1)]
        c_in = [s[0] for s in specs[:-1]]
        return [(ci, ch, k, s, g, p, LRELU_SLOPE if i < len(self.specs) else 1.0)
                for i, (ci, (ch, k, s, g, p)) in enumerate(zip(c_in, specs[1:]), start=1)]

    def runs(self, zoned: bool) -> list[tuple[int | None, list[int]]]:
        """The stack's runs, each ``(groups, [layer indices])`` into
        :meth:`stack_layers`: a zone chain (``groups``) where each layer has
        ``g >= zone_min_groups`` and a group's channels tile 128 lanes with
        an integer row stride (the JAX partition), else a standard run
        (``None``) of consecutive layers."""
        out: list = []
        for i, (ci, ch, _, s, g, _, _) in enumerate(self.stack_layers()):
            ci_g, co_g = ci // g, ch // g
            zonable = (zoned and g >= self.zone_min_groups and 128 % ci_g == 0
                       and 128 % co_g == 0 and ((128 // co_g) * s) % (128 // ci_g) == 0)
            kind = g if zonable else None
            if out and out[-1][0] == kind:
                out[-1][1].append(i)
            else:
                out.append((kind, [i]))
        return out

    def forward(self, x: torch.Tensor, update_spectral: bool = False, weight_grads: bool = True,
                pair: torch.Tensor | None = None):
        """x (B, T) -> (logits (B, -1), fmaps); with ``pair`` (a second
        waveform of x's shape) -> ((logits, fmaps), (logits2, fmaps2)), the
        weights, the zone tables and the spectral power iteration computed
        once for both (once per input under ``'pallas'``, as each JAX conv
        call does). ``weight_grads=False`` declares the weights constant in
        this call: the fused paths then do no weight-gradient work."""
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
        if impl in ("fused_stack", "fused_zoned"):
            (k0, b0), (_, _, _, _, p0) = layers[0], specs[0]
            outs = [leaky_relu(conv1d(h.to(dtype), k0, b0, padding=p0), LRELU_SLOPE).contiguous()
                    for h in xs]
            fmaps = [[h] for h in outs]
            for groups, idx in self.runs(impl == "fused_zoned"):
                outs = (self._zone_run(outs, fmaps, idx, layers[1:], groups, weight_grads)
                        if groups else self._std_run(outs, fmaps, idx, layers[1:], weight_grads))
            results = [(o.reshape(b, -1), fm) for o, fm in zip(outs, fmaps)]
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

    def _stack(self, xs, kernels, biases, specs, weight_grads):
        return fused_conv_stack(xs, kernels, biases, specs, weight_grads=weight_grads,
                                mesh=self.mesh, batch_axis=self.mesh_batch_axis)

    def _std_run(self, outs, fmaps, idx, layers, weight_grads):
        stack = self.stack_layers()
        specs = [LayerSpec(ch, k, s, g, p, p, slope)
                 for _, ch, k, s, g, p, slope in (stack[i] for i in idx)]
        ys_multi = self._stack(outs, [layers[i][0] for i in idx], [layers[i][1] for i in idx],
                               specs, weight_grads)
        for fm, ys in zip(fmaps, ys_multi):
            fm.extend(ys)
        return [ys[-1] for ys in ys_multi]

    def zone_chain(self, layers, idx, t: int) -> tuple:
        """The zone chain of a run ``idx`` of :meth:`runs` over an input of
        ``t`` rows: (banded kernels, biases, zone specs, entry fold, exit
        fold, exit length). ``layers[i]`` is stack layer i's (kernel, bias)."""
        stack = self.stack_layers()
        g = stack[idx[0]][4]
        zks, zbs, zspecs = [], [], []
        for i in idx:
            ci, ch, k, s, gg, p, slope = stack[i]
            zk, zb, spec = zone_grouped_layer(layers[i][0], layers[i][1], s, p, 128 // (ci // gg),
                                              128 // (ch // gg), gg, slope, t)
            zks.append(zk)
            zbs.append(zb)
            zspecs.append(spec)
            t = (t + 2 * p - k) // s + 1
        return (zks, zbs, zspecs, 128 // (stack[idx[0]][0] // g), 128 // (stack[idx[-1]][1] // g),
                t)

    def _zone_run(self, outs, fmaps, idx, layers, g, weight_grads):
        """Fold at entry, the chain's banded layers in one stack call, unfold
        at exit; the chain's maps stay in the zone layout."""
        zks, zbs, zspecs, f_entry, f_exit, t = self.zone_chain(layers, idx, outs[0].shape[1])
        ys_multi = self._stack([fold_group_zones(o, g, f_entry) for o in outs], zks, zbs, zspecs,
                               weight_grads)
        for fm, ys in zip(fmaps, ys_multi):
            fm.extend(ys)
        return [unfold_group_zones(ys[-1], g, f_exit, t_out=t).contiguous() for ys in ys_multi]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, width: int = 128, num_scales: int = 3, dtype: torch.dtype | None = None,
                 fused: bool = False, conv_impl: str = "auto",
                 generator: torch.Generator | None = None, mesh=None,
                 mesh_batch_axis: str = "data", zone_min_groups: int = 8) -> None:
        super().__init__()
        self.fused = fused
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=i == 0, width=width, dtype=dtype,
                           conv_impl=conv_impl, generator=generator, mesh=mesh,
                           mesh_batch_axis=mesh_batch_axis, zone_min_groups=zone_min_groups)
            for i in range(num_scales)
        )

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, update_spectral: bool = False,
                weight_grads: bool = True):
        b = y.shape[0]
        yy = torch.cat([y, y_hat]) if self.fused else None
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i and self.fused:
                yy = avg_pool1d(yy[..., None], 4, 2, padding=2)[..., 0]
            elif i:
                y = avg_pool1d(y[..., None], 4, 2, padding=2)[..., 0]
                y_hat = avg_pool1d(y_hat[..., None], 4, 2, padding=2)[..., 0]
            if self.fused:
                # one call on the 2B rows, scale 0 included: one power
                # iteration serves both halves
                (y_d_r, fmap_r), (y_d_g, fmap_g) = _split_halves(
                    b, *d(yy, update_spectral, weight_grads))
            elif i == 0 and update_spectral:
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
