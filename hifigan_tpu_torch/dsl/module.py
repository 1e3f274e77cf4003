"""Declarative module-config interpreter (PyTorch port of ``hifigan_tpu/dsl/module.py``).

One ``nn.Module`` interprets a whole normalised config tree in ``forward``.
Layout as in the JAX package: activations are channels-last (B, T, C),
waveforms (B, T, 1), and every node evaluation returns ``(y, feats)`` with
``feats`` the tagged captures ``[(tags, value), ...]`` that ``fmap`` /
``pfmap`` nodes consume.

Parameters are created by :meth:`ConfigurableModule.build`, which evaluates
the config once on example inputs (as flax's ``init`` does), under the
flax names: ``convs[<path>_conv]`` (a :class:`NormConv1d`), one
``ensembles[<path>_ens]`` list of member modules per homogeneous ensemble
(the flax tree stacks them on axis 0), valve ratios as buffers named
``<path>_ratio`` and spectral ``u`` as each conv's ``weight_u``. The weight
carrier (``train/checkpoint.py``) is therefore a rename.

``member_impl``: ``'auto'`` and ``'fused'`` evaluate each all-in-one
discriminator member (``pfmap(all_in_one_discriminator)``) through
:mod:`hifigan_tpu_torch.dsl.fused_member` on every device, with a
homogeneous ensemble's members in one call (the stream-graph kernel for CUDA
tensors, its plain version for CPU tensors); ``'interpret'`` evaluates node
by node. A member the pattern matcher rejects is interpreted.

``conv_impl`` (the JAX module's values) picks how ``conv`` / ``conv_rech``
nodes run (:meth:`ConfigurableModule._conv_backend`): ``'pallas'`` through
:func:`hifigan_tpu_torch.ops.msd_conv.msd_conv1d_lrelu` at slope 1.0 (the
CUDA kernels for CUDA tensors), except a node with stride > 1 and dilation
> 1, which stays on the direct conv; ``'pallas_interpret'`` (the JAX
test mode) is an alias of ``'pallas'``: the op itself takes its plain
version for CPU tensors; ``'auto'``, ``'xla'`` and ``'folded'`` (the JAX time-fold lowering, the
same function) the direct conv. Ensemble members inherit it.

``stream_impl``: ``'fused'`` (and ``'fused_interpret'``, the JAX test mode,
an alias) evaluates a module called with one tensor through the
stream-fusion pass (:mod:`hifigan_tpu_torch.dsl.stream_fusion`): runs of
narrow stream ops become one stream-graph segment each (the kernel for CUDA
tensors, its plain version for CPU tensors), everything else the
interpreter at its own paths; ``'auto'`` and ``'interpret'`` interpret.
Parameters are always built by the interpreter, so the flag never changes
them.

``conv2`` (a ``NormConv2d`` named ``<path>_conv2``, (N, H, W, C)), ``trans``
(a ``NormConvTranspose1d`` named ``<path>_trans``), ``trans_shuffle`` and
``up`` with linear interpolation follow the JAX nodes; ``trans2`` raises
``NotImplementedError`` as the JAX node does.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from hifigan_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from hifigan_tpu_torch.dsl.normalize import RLIST, SEQ, is_normalized, normalize_config
from hifigan_tpu_torch.models.layers import NormConv1d, NormConv2d, NormConvTranspose1d
from hifigan_tpu_torch.ops import msd_conv
from hifigan_tpu_torch.ops.conv import avg_pool1d, conv1d, leaky_relu

Feats = list
CONV_IMPLS = ("auto", "xla", "folded", "pallas", "pallas_interpret")
STREAM_IMPLS = ("auto", "interpret", "fused", "fused_interpret")


def dsl_padding(kernel: int, stride: int = 1, dilation: int = 1) -> int:
    """extra_utils.get_1d_padding: ((k-1)*d + 1) // 2."""
    return ((kernel - 1) * dilation + 1) // 2


def dsl_padding_trans(kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """extra_utils.get_1d_padding_trans -> (padding, output_padding)."""
    total = (kernel - 1) * dilation + 1 - stride
    return total // 2 + total % 2, total % 2


def padding_period(length: int, period: int) -> tuple[int, int]:
    """extra_utils.get_1d_padding_period: centre-pad to a period multiple."""
    total = int(math.ceil(length / period) * period - length)
    return total // 2, total // 2 + total % 2


def _norm_name(norm_type) -> str:
    if norm_type == "spectral":
        return "spectral"
    if norm_type == "none":
        return "none"
    return "weight"


def _conv_params(chin, chout, kernel, stride=1, dilation=1, groups=1, init=0.01, norm_type=None):
    return (int(chin), int(chout), int(kernel), int(stride), int(dilation), int(groups),
            float(init), _norm_name(norm_type))


def tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, Mapping):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        out = [tree_map(fn, *vals) for vals in zip(*trees)]
        return tuple(out) if isinstance(t0, tuple) else out
    return fn(*trees)


def sorted_dicts(cfg):
    """The config with every dict's keys sorted: what the JAX package's
    vmapped ensemble hands its members (flax flattens module attributes and
    inputs as pytrees), so a dict-valued ``split`` inside a homogeneous
    ensemble assigns channels in sorted-key order and a ``merge_dict`` of a
    dict input concatenates in that order."""
    if isinstance(cfg, Mapping):
        return {k: sorted_dicts(cfg[k]) for k in sorted(cfg)}
    if isinstance(cfg, tuple):
        return tuple(sorted_dicts(c) for c in cfg)
    return cfg


def _cast_float(tree, dtype):
    return tree_map(lambda a: a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                    else a, tree)


class ConfigurableModule(nn.Module):
    """Interpreter for the tuple/list module-config language."""

    def __init__(self, config, mel_sampling_rate_override: int | None = None,
                 update_spectral: bool = False, compute_dtype=None, member_impl: str = "auto",
                 stream_impl: str = "auto", conv_impl: str = "auto",
                 weight_grads: bool = True) -> None:
        super().__init__()
        if stream_impl not in STREAM_IMPLS:
            raise ValueError(f"unknown stream_impl {stream_impl!r}; expected one of {STREAM_IMPLS}")
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}; expected one of {CONV_IMPLS}")
        if member_impl not in ("auto", "fused", "interpret"):
            raise ValueError(f"unknown member_impl {member_impl!r}")
        self.config = config if is_normalized(config) else normalize_config(config)
        self.mel_sampling_rate_override = mel_sampling_rate_override
        self.update_spectral = update_spectral
        self.compute_dtype = (getattr(torch, compute_dtype) if isinstance(compute_dtype, str)
                              else compute_dtype)
        self.member_impl = member_impl
        self.stream_impl = stream_impl
        self.conv_impl = conv_impl
        self.weight_grads = weight_grads
        self.convs = nn.ModuleDict()
        self.ensembles = nn.ModuleDict()
        self.valves = nn.Module()
        self._building = False
        self._gen: torch.Generator | None = None  # init draws while building
        self._noise: torch.Generator | None = None  # noise draws in a call

    # -- construction --------------------------------------------------------

    def _member_kwargs(self) -> dict:
        return dict(mel_sampling_rate_override=self.mel_sampling_rate_override,
                    update_spectral=self.update_spectral, compute_dtype=self.compute_dtype,
                    member_impl=self.member_impl, conv_impl=self.conv_impl,
                    weight_grads=self.weight_grads)

    def build(self, *example, generator: torch.Generator | None = None) -> "ConfigurableModule":
        """Create every parameter by evaluating the config once on ``example``
        (CPU tensors); draws come from ``generator``."""
        self._building, self._gen = True, generator
        try:
            with torch.no_grad():
                self._call(example, None)
        finally:
            self._building, self._gen = False, None
        return self

    def _conv_module(self, name: str, in_ch: int, chout: int, k: int, s: int, d: int, g: int,
                     init: float, norm: str) -> NormConv1d:
        return self._param_module(name, lambda: NormConv1d(
            in_ch, chout, k, stride=s, padding=dsl_padding(k, s, d), dilation=d, groups=g,
            norm=norm, generator=self._gen, init_std=init))

    def _param_module(self, name: str, make) -> nn.Module:
        """The conv module named ``name``, made by ``make()`` while building."""
        if name not in self.convs:
            if not self._building:
                raise KeyError(f"{name}: parameters are missing (call build first)")
            self.convs[name] = make()
        return self.convs[name]

    def conv_weights(self, name: str, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """Effective (kernel (K, I, O), bias) of a conv in ``dtype``; advances
        the spectral power iteration when the module updates it."""
        return self.convs[name].kernel_nwc(self.update_spectral and not self._building, dtype)

    # -- calls -------------------------------------------------------------

    def forward(self, *x, generator: torch.Generator | None = None):
        return self._call(x, generator)[0]

    def _call(self, args: tuple, generator):
        self._noise = generator
        cd = self.compute_dtype
        if cd is not None:
            args = tuple(_cast_float(a, cd) for a in args)
        if self.stream_impl in ("fused", "fused_interpret") and len(args) == 1 and (
                not self._building):
            from hifigan_tpu_torch.dsl.stream_fusion import eval_stream_fused

            y, feats = eval_stream_fused(self, self.config, args[0], "m")
        else:
            y, feats = self._eval(self.config, args, "m")
        if cd is not None:
            y = _cast_float(y, torch.float32)
            feats = [(t, _cast_float(v, torch.float32)) for t, v in feats]
        return y, feats

    def _fused(self) -> bool:
        return self.member_impl in ("auto", "fused") and not self._building

    # -- core recursion ----------------------------------------------------

    def _eval(self, cfg, args: tuple, path: str) -> tuple[Any, Feats]:
        if not is_normalized(cfg):
            cfg = normalize_config(cfg)
        if cfg[0] == SEQ:
            feats: Feats = []
            val = args
            for i, sub in enumerate(cfg[1]):
                out, f = self._eval(sub, val, f"{path}_{i}")
                feats.extend(f)
                val = (out,)
            return val[0], feats
        _, name, params, tags = cfg
        if name == "#tagged":
            y, feats = self._eval(params, args, path)
        else:
            if name == "valve" and tags:
                path = f"{path}__{'+'.join(tags)}"
            y, feats = self._node(name, params, args, path)
        if tags:
            feats = feats + [(tags, y)]
        return y, feats

    def _conv_backend(self, stride: int, dilation: int) -> str:
        """'kernel' (msd_conv1d_lrelu) or 'direct' (conv1d) for a 1-D conv
        node, as the JAX module's ``_conv_backend`` resolves ``conv_impl``."""
        if self.conv_impl in ("pallas", "pallas_interpret") and (stride == 1 or dilation == 1):
            return "kernel"
        return "direct"

    def _conv_node(self, p, x, name: str):
        chin, chout, k, s, d, g, init, norm = _conv_params(*p)
        mod = self._conv_module(name, x.shape[-1], chout, k, s, d, g, init, norm)
        kern, bias = self.conv_weights(name, x.dtype)
        backend = self._conv_backend(s, d)
        if backend == "direct":
            return conv1d(x, kern, bias, stride=s, padding=mod.padding, dilation=d, groups=g)
        return msd_conv.msd_conv1d_lrelu(x, kern, bias, stride=s, padding=mod.padding,
                                         dilation=d, groups=g)

    def _node(self, name: str, p, args: tuple, path: str) -> tuple[Any, Feats]:
        x = args[0]
        feats: Feats = []
        if name == "tanh":
            return torch.tanh(x), feats
        if name == "sigmoid":
            return torch.sigmoid(x), feats
        if name == "avg_ch":
            return x.mean(dim=-1, keepdim=True), feats
        if name == "merge":
            return torch.cat(list(x), dim=-1), feats
        if name == "merge_dict":
            return torch.cat(list(x.values()), dim=-1), feats
        if name == "softmax":
            return torch.softmax(x, dim=-1), feats

        if name == "conv":
            return self._conv_node(p, x, f"{path}_conv"), feats
        if name == "conv_rech":
            p = list(p)
            if len(p) > 3 and p[3] is None:
                p[3] = int(p[1]) // math.gcd(int(p[0]), int(p[1]))
            chin, chout, k, s, d, g, init, norm = _conv_params(*p)
            y = self._conv_node((chin, s * chin, k, s, d, g, init, norm), x, f"{path}_convrech")
            b, t, c = y.shape
            return y.reshape(b, (t * c) // chout, chout), feats
        if name == "conv_shuffle":
            chin, chout, k, s, d, g, init, norm = _conv_params(*p)
            if g == 1:
                return self._eval(("conv", (chin, chout, k, s, d, g, init)), args, f"{path}_cs")
            seq = [("conv", (chin, chout, k, s, d, g, init)), ("shuffle", g),
                   ("conv", (chout, chout, 1, 1, 1, chout // g, init)), ("unshuffle", g)]
            return self._eval(seq, args, f"{path}_cs")
        if name == "conv2":
            chin, chout, k, s, d, g, init, norm = _conv_params(*p)
            pad = dsl_padding(k, s, d)
            mod = self._param_module(f"{path}_conv2", lambda: NormConv2d(
                x.shape[-1], chout, (k, k), (s, s), (pad, pad), groups=g, norm=norm,
                generator=self._gen, dilation=(d, d), init_std=init))
            return mod.nhwc(x, self.update_spectral and not self._building), feats
        if name == "trans":
            chin, chout, k, s, d, g, init, norm = _conv_params(*p)
            pad, out_pad = dsl_padding_trans(k, s, d)
            if g != 1:
                raise NotImplementedError("grouped transposed conv not used by the reference "
                                          "configs")
            mod = self._param_module(f"{path}_trans", lambda: NormConvTranspose1d(
                x.shape[-1], chout, k, stride=s, padding=pad, norm=norm, generator=self._gen,
                output_padding=out_pad, init_std=init))
            return mod.nwc(x, self.update_spectral and not self._building), feats
        if name == "trans_shuffle":
            chin, chout, k, s, d, g, init, norm = _conv_params(*p)
            if g == 1:
                return self._eval(("trans", (chin, chout, k, s, d, g, init)), args, f"{path}_ts")
            seq = [("conv", (chin, chin, 1, 1, 1, chin // g, init)), ("shuffle", g),
                   ("trans", (chin, chout, k, s, 1, 1, init)), ("unshuffle", g)]
            return self._eval(seq, args, f"{path}_ts")
        if name == "trans2":
            raise NotImplementedError("trans2 is unused by all reference configs")

        if name == "up":
            stride, mode = p
            if mode == "nearest":
                return torch.repeat_interleave(x, int(stride), dim=1), feats
            # linear, align_corners=False: jax.image.resize's half-pixel centres
            y = F.interpolate(x.transpose(1, 2), scale_factor=int(stride), mode="linear",
                              align_corners=False)
            return y.transpose(1, 2), feats
        if name == "pool":
            k, s = (int(v) for v in p)
            return avg_pool1d(x, k, s, padding=dsl_padding(k, s)), feats
        if name == "poold":
            k, s, d = (int(v) for v in p)
            # AvgPool1dDilated as the JAX node computes it: windows of k along
            # (B, T/d, d, C)'s time axis, the stride over its phase axis
            b, t, c = x.shape
            y = avg_pool1d(x.reshape(b, t // d, d * c), k, 1, padding=dsl_padding(k, s))
            return y.reshape(b, -1, d, c)[:, :, ::s].reshape(b, -1, c), feats

        if name == "roll":
            period = int(p[0]) if isinstance(p, (tuple, list)) else int(p)
            pad_mode = p[1] if isinstance(p, (tuple, list)) and len(p) > 1 else "constant"
            b, t, c = x.shape
            lo, hi = padding_period(t, period)
            if pad_mode == "reflect":
                y = F.pad(x.transpose(1, 2), (lo, hi), mode="reflect").transpose(1, 2)
            else:
                y = F.pad(x, (0, 0, lo, hi))
            return y.reshape(b, (t + lo + hi) // period, period * c), feats
        if name == "unroll":
            period = int(p[0]) if isinstance(p, (tuple, list)) else int(p)
            b, t, c = x.shape
            return x.reshape(b, t * period, c // period), feats
        if name == "repl":
            return torch.cat([x] * int(p), dim=-1), feats
        if name == "shuffle":
            g = int(p)
            b, t, c = x.shape
            return x.reshape(b, t, g, c // g).transpose(-1, -2).reshape(b, t, c), feats
        if name == "unshuffle":
            g = int(p)
            b, t, c = x.shape
            return x.reshape(b, t, c // g, g).transpose(-1, -2).reshape(b, t, c), feats

        if name == "mel":
            sr, out_ch, k, s = (int(v) for v in p[:4])
            if self.mel_sampling_rate_override:
                sr = self.mel_sampling_rate_override
            lo, hi = padding_period(x.shape[1], s)
            wav = F.pad(x[..., 0], (lo, hi))
            cfg = MelConfig(n_fft=k, num_mels=out_ch, sampling_rate=sr, hop_size=s, win_size=k,
                            fmin=0.0, fmax=None)
            return log_mel_spectrogram(wav, cfg).transpose(-1, -2), feats

        if name in ("fusion", "sum"):
            outs = []
            for i, sub in enumerate(p):
                out, f = self._eval(sub, args, f"{path}_{'fus' if name == 'fusion' else 'sum'}{i}")
                outs.append(out)
                feats.extend(f)
            total = sum(outs)
            return (total / len(outs) if name == "fusion" else total), feats
        if name == "chunk":
            return tuple(torch.chunk(x, int(p), dim=-1)), feats
        if name == "split":
            if isinstance(p, Mapping):
                parts = torch.split(x, list(p.values()), dim=-1)
                return dict(zip(p.keys(), parts)), feats
            return tuple(torch.split(x, int(p), dim=-1)), feats
        if name == "one_hot":
            channels, _dim = p
            return F.one_hot(x.long(), int(channels)).float(), feats
        if name == "list":
            outs = []
            for i, (sub, xi) in enumerate(zip(p, x)):
                out, f = self._eval(sub, (xi,), f"{path}_l{i}")
                outs.append(out)
                feats.extend(f)
            return outs, feats
        if name == "dict":
            outs = {}
            for key, sub in p.items():
                out, f = self._eval(sub, (x[key],), f"{path}_d{key}")
                outs[key] = out
                feats.extend(f)
            return outs, feats
        if name == "recursive":
            return self._recursive(p, x, f"{path}_r", feats), feats
        if name in ("res", "sub_res"):
            out, f = self._eval(p, args, f"{path}_{'res' if name == 'res' else 'sres'}")
            feats.extend(f)
            return (x + out if name == "res" else x - out), feats
        if name == "valve":
            key = f"{path}_ratio"
            if not hasattr(self.valves, key):
                if not self._building:
                    raise KeyError(f"{key}: valve is missing (call build first)")
                self.valves.register_buffer(key, torch.tensor(float(p), dtype=torch.float32))
            return x * getattr(self.valves, key).to(x.dtype), feats
        if name == "noise":
            b, t, _ = x.shape
            gen = self._noise
            z = torch.randn((b, t, int(p)), generator=gen,
                            device=x.device if gen is None else gen.device)
            return z.to(x.device, x.dtype), feats
        if name == "lrelu":
            return leaky_relu(x, float(p)), feats

        if name == "fmap":
            sub_cfg, tags_to_find = p
            out, f = self._eval(sub_cfg, args, f"{path}_fm")
            captured = [v for t, v in f if any(tag in tags_to_find for tag in t)]
            return {"output": out, "features": captured}, f
        if name == "pfmap":
            if self._fused():
                from hifigan_tpu_torch.dsl.fused_member import (
                    StreamUnsupported,
                    eval_members_pfmap,
                    parse_member,
                )

                try:  # static pattern check first: a rejected member is interpreted
                    plan = parse_member(p, path)
                except StreamUnsupported:
                    pass
                else:
                    outs, member_feats = eval_members_pfmap([self], path, args, plan)
                    return tree_map(lambda s: s[0], outs), member_feats[0]
            sub_cfg, tags_to_find, feature_models = p
            out, f = self._eval(sub_cfg, args, f"{path}_pfm")
            captured = [v for t, v in f if any(tag in tags_to_find for tag in t)]
            processed = []
            for i, feat in enumerate(captured):
                pv, pf = self._eval(feature_models[i % len(feature_models)], (feat,),
                                    f"{path}_pfmm{i}")
                processed.append(pv)
                feats.extend(pf)
            return {"output": out, "features": processed}, f + feats

        if name == "ensemble":
            return self._ensemble(p, args, path)
        if name == "all_in_one_block":
            before_cfg, raw_cfgs, after_cfg = p
            xx, raw = args
            out, f = self._eval(before_cfg, (xx,), f"{path}_aib_b")
            feats.extend(f)
            branch_outs = [out]
            for i, rc in enumerate(raw_cfgs):
                ro, rf = self._eval(rc, (raw,), f"{path}_aib_r{i}")
                branch_outs.append(ro)
                feats.extend(rf)
            max_len = max(o.shape[1] for o in branch_outs)
            cat = torch.cat([F.pad(o, (0, 0, 0, max_len - o.shape[1])) for o in branch_outs],
                            dim=-1)
            out, f = self._eval(after_cfg, (cat,), f"{path}_aib_a")
            feats.extend(f)
            return out, feats
        if name == "all_in_one_discriminator":
            before_cfg, blocks_cfgs, after_cfg = p
            raw = x
            out, f = self._eval(before_cfg, (raw,), f"{path}_aiod_b")
            feats.extend(f)
            for i, bc in enumerate(blocks_cfgs):
                out, f = self._eval(bc, (out, raw), f"{path}_aiod_{i}")
                feats.extend(f)
            out, f = self._eval(after_cfg, (out,), f"{path}_aiod_a")
            feats.extend(f)
            return out, feats
        if name == "encoder":
            vo_cfg, splitters_cfgs = p
            e, f = self._eval(vo_cfg, args, f"{path}_enc")
            feats.extend(f)
            outs = []
            for i, sc in enumerate(splitters_cfgs):
                o, sf = self._eval(sc, (e,), f"{path}_enc_s{i}")
                outs.append(o)
                feats.extend(sf)
            return outs, feats
        if name == "decoder":
            mergers_cfgs, vo_cfg = p
            merged = []
            for i, (mc, xi) in enumerate(zip(mergers_cfgs, x)):
                o, mf = self._eval(mc, (xi,), f"{path}_dec_m{i}")
                merged.append(o)
                feats.extend(mf)
            out, f = self._eval(vo_cfg, (sum(merged),), f"{path}_dec")
            feats.extend(f)
            return out, feats
        raise ValueError(f"Unknown module type [{name}]")

    # -- ensembles ---------------------------------------------------------

    def _ensemble(self, p, args: tuple, path: str) -> tuple[Any, Feats]:
        subs = [s if is_normalized(s) else normalize_config(s) for s in p]
        feats: Feats = []
        if len(subs) > 1 and all(s == subs[0] for s in subs[1:]):
            key = f"{path}_ens"
            if key not in self.ensembles:
                if not self._building:
                    raise KeyError(f"{key}: ensemble members are missing (call build first)")
                members = nn.ModuleList(
                    ConfigurableModule(sorted_dicts(subs[0]), **self._member_kwargs())
                    for _ in subs)
                for mem in members:
                    mem._building, mem._gen = True, self._gen
                self.ensembles[key] = members
            members = self.ensembles[key]
            # the JAX nn.vmap hands its members dict inputs key-sorted too
            args = sorted_dicts(args)
            stacked = member_feats = None
            if self._fused():
                stacked, member_feats = self._ensemble_fused(members, members[0].config, args)
            if stacked is None:
                results = [mem._call(args, self._noise) for mem in members]
                stacked = tree_map(lambda *xs: torch.stack(xs, 0), *[r[0] for r in results])
                member_feats = [r[1] for r in results]
            for mem in members:
                mem._building, mem._gen = False, None
            for f in member_feats:
                feats.extend(f)
        else:
            results = []
            for i, sub in enumerate(subs):
                out, f = self._eval(sub, args, f"{path}_e{i}")
                results.append(out)
                feats.extend(f)
            stacked = tree_map(lambda *xs: torch.stack(xs, 0), *results)
        means = tree_map(lambda s: s.mean(0), stacked)
        variances = tree_map(lambda s: s.var(0, unbiased=True), stacked)
        return {"mean": means, "variance": variances}, feats

    @staticmethod
    def _ensemble_fused(members, member_cfg, args):
        """All members of a pfmap(all_in_one_discriminator) ensemble in one
        fused call, or (None, None) where the pattern matcher rejects it."""
        from hifigan_tpu_torch.dsl.fused_member import (
            StreamUnsupported,
            eval_members_pfmap,
            parse_member,
        )

        if member_cfg[0] == SEQ or member_cfg[1] != "pfmap":
            return None, None
        try:
            plan = parse_member(member_cfg[2], "m")
        except StreamUnsupported:
            return None, None
        cd = members[0].compute_dtype
        cargs = tuple(_cast_float(a, cd) for a in args) if cd is not None else args
        outs, member_feats = eval_members_pfmap(list(members), "m", cargs, plan)
        tags = member_cfg[3]
        if tags:
            member_feats = [f + [(tags, tree_map(lambda s, i=i: s[i], outs))]
                            for i, f in enumerate(member_feats)]
        if cd is not None:
            outs = _cast_float(outs, torch.float32)
            member_feats = [[(t, _cast_float(v, torch.float32)) for t, v in f]
                            for f in member_feats]
        return outs, member_feats

    def _recursive(self, cfgs, x, path: str, feats: Feats):
        is_leaf_cfg = is_normalized(cfgs)
        if isinstance(x, Mapping):
            return {k: self._recursive(cfgs if is_leaf_cfg else cfgs[k], v, f"{path}_{k}", feats)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            sub_cfgs = ([cfgs] * len(x) if is_leaf_cfg else
                        list(cfgs[1] if isinstance(cfgs, tuple) and cfgs[0] == RLIST else cfgs))
            seq = [self._recursive(c, v, f"{path}_{i}", feats)
                   for i, (c, v) in enumerate(zip(sub_cfgs, x))]
            return tuple(seq) if isinstance(x, tuple) else seq
        out, f = self._eval(cfgs, (x,), path)
        feats.extend(f)
        return out
