"""Distillation trainer (PyTorch port of ``hifigan_tpu/distill/train.py``,
``make_train_step``).

One step computes every loss of the GAN autoencoder in one pass and runs
ONE backward of the sum of the subtrees whose ``loss_backward`` flag is
set. The JAX step's ``stop_gradient`` walls are ``detach()`` here, and its
frozen copies (the discriminator the generator is judged by, the hunters the
generator hunts against) are separate modules whose parameters take no
gradient, refreshed from the live ones after each step. The discriminator
is called four times a step:

- the frozen copy on the real audio (its expansion to the mix size plus the
  batch): no backward;
- the frozen copy on all generated audio: gradients to the audio only
  (``weight_grads=False``);
- the live discriminator on the real batch and on the detached generated
  audio: weight gradients only, its spectral ``u`` advancing once a call.

Six optimizer groups (``flat_optimizer_groups``), each AdamW-amsgrad
(optax ``scale_by_amsgrad`` -> ``add_decayed_weights(0.01)`` -> learning
rate, as :func:`make_optimizer` in the JAX trainer): gradients accumulate
over ``accumulated_grad_batches`` steps, then each group is scaled by
``1/N``, clipped to global norm ``gradient_clip``, skipped (zero update)
when its norm is not finite, and stepped with ``lr * lr_decay**step``. The
update reads each group's norm on the host (one synchronisation a group).

The step updates the state's modules and optimizer tensors in place and
returns ``(state, losses)``, the losses a nested dict of detached scalars
with a ``'total'`` per level. ``make_eval_step`` returns the validation
step: the same losses and the data the callbacks read (waveforms, mels,
label predictions), with no gradient and no change to any state.
``distill/main.py`` drives both from a corpus, with the callbacks.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from hifigan_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from hifigan_tpu_torch.distill.cycles import calculate_cycles
from hifigan_tpu_torch.distill.losses import get_losses_by_types, recursive_loss
from hifigan_tpu_torch.distill.model import DistillModels, expand_group_paths, flat_optimizer_groups
from hifigan_tpu_torch.distill.tensor_ops import expand, mix, unmix
from hifigan_tpu_torch.dsl.module import ConfigurableModule, tree_map


def _merge_dicts(*dicts):
    out: dict = {}

    def merge(base, remote):
        for k, v in remote.items():
            if k in base and isinstance(base[k], dict) and isinstance(v, Mapping):
                merge(base[k], v)
            else:
                base[k] = v

    for d in dicts:
        merge(out, d)
    return out


def calculate_losses(loss, factor, backward, data):
    """Walk loss/factor/backward trees over the data tree: (nested losses
    with a 'total' per level, the sum of the subtrees flagged for backward)."""

    def walk(loss, factor, backward, data):
        if isinstance(data, Mapping):
            if "total" in data:
                raise ValueError("'total' is a reserved key in loss data trees")
            losses = {}
            total = 0.0
            trained = 0.0
            for key in data.keys():
                sub_losses, sub_total, sub_trained = walk(
                    loss[key] if isinstance(loss, Mapping) else loss,
                    factor[key] if isinstance(factor, Mapping) else factor,
                    backward[key] if isinstance(backward, Mapping) else False,
                    data[key])
                losses[key] = sub_losses
                total = sub_total + total
                trained = sub_trained + trained
            losses["total"] = total
        else:
            value = recursive_loss(loss, *data) * factor
            losses, total, trained = value, value, 0.0
        if isinstance(backward, bool) and backward:
            trained = total
        return losses, total, trained

    losses, _total, trained = walk(loss, factor, backward, data)
    return losses, trained


class AmsGradW:
    """optax ``chain(scale_by_amsgrad(b1, b2), add_decayed_weights(wd),
    scale_by_learning_rate(lr))`` over a list of parameters, in place, with
    ``torch._foreach_*`` ops (a few launches per group, not a few per
    parameter). The bias corrections are taken in float32, as optax does."""

    def __init__(self, params: list[torch.Tensor], b1: float, b2: float,
                 weight_decay: float = 0.01, eps: float = 1e-8, learning_rate: float = 0.0):
        self.params = params
        self.b1, self.b2, self.wd, self.eps = b1, b2, weight_decay, eps
        self.learning_rate = learning_rate  # the last update's (optax's injected value)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.nu_max = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr: float, apply: bool = True) -> None:
        """One update. ``apply=False`` (the NaN/Inf guard) leaves the
        parameters as they are; the moments advance all the same, as in the
        JAX step."""
        self.count += 1
        self.learning_rate = lr
        count = np.float32(self.count)
        c1 = float(np.float32(1) - np.float32(self.b1) ** count)
        c2 = float(np.float32(1) - np.float32(self.b2) ** count)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        torch._foreach_maximum_(self.nu_max, torch._foreach_div(self.nu, c2))
        denom = torch._foreach_sqrt(self.nu_max)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.wd)
        if apply:
            torch._foreach_add_(self.params, upd, alpha=-lr)


@dataclasses.dataclass
class DistillTrainState:
    step: int
    models: DistillModels
    disc_copy: ConfigurableModule
    hunter_copies: dict
    optimizers: dict  # {group: AmsGradW}
    grad_accum: dict  # {group: [fp32 tensors]}


def _copy_state(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Refresh a frozen copy (parameters and buffers) from its live module."""
    d, s = dst.state_dict(keep_vars=True), src.state_dict(keep_vars=True)
    torch._foreach_copy_([d[k].data for k in s], [s[k].data for k in s])


def _model_at(models: DistillModels, path: tuple) -> ConfigurableModule:
    node: Any = models.modules()
    for p in path:
        node = node[p]
    return node


class DistillTrainer:
    def __init__(self, models: DistillModels, config: dict, loop_type: str = "train"):
        self.models = models
        self.config = config
        learning = config["learning"]
        self.loss_funcs = get_losses_by_types(learning["loss_funcs"])
        self.loss_factors = learning["loss_factors"]
        self.loss_backward = learning["loss_backward"]
        self.flat_groups = flat_optimizer_groups(learning["optimizers"])
        self.b1, self.b2 = learning["adam_b1"], learning["adam_b2"]
        self.lr_decay = learning["lr_decay"]
        self.accumulate = learning.get("accumulated_grad_batches", 1)
        self.clip_value = learning.get("gradient_clip", 1000.0)
        loop_cfg = config["loops"][loop_type]
        batch = loop_cfg["batch_size"]
        self.rolls = (batch, *calculate_cycles(batch, loop_cfg["mix_size"]))
        self.batch_size = batch
        self.segment_length = loop_cfg["segment_length"]
        mel = config["mel"]
        self.mel_cfg = MelConfig(n_fft=mel["n_fft"], num_mels=mel["num_mels"],
                                 sampling_rate=config["sampling_rate"], hop_size=mel["hop_size"],
                                 win_size=mel["win_size"], fmin=mel["fmin"], fmax=mel["fmax"])

    def group_params(self, group: str) -> list[torch.nn.Parameter]:
        params = []
        for path in expand_group_paths(group, self.models.modules()):
            params += list(_model_at(self.models, path).parameters())
        return params

    def create_state(self, seed: int = 0, build: bool = True) -> DistillTrainState:
        """The train state; with ``build``, the models' parameters are drawn
        first (seeded), else they are used as loaded."""
        m = self.models
        if build:
            m.build(self.segment_length, seed)
        optimizers = {g: AmsGradW(self.group_params(g), self.b1, self.b2, learning_rate=lr)
                      for g, lr in self.flat_groups.items()}
        accum = {g: [torch.zeros_like(p) for p in opt.params] for g, opt in optimizers.items()}
        return DistillTrainState(step=0, models=m, disc_copy=m.frozen_discriminator(),
                                 hunter_copies={k: m.frozen_copy(h) for k, h in m.hunters.items()},
                                 optimizers=optimizers, grad_accum=accum)

    # ------------------------------------------------------------------

    def compute_losses(self, state: DistillTrainState, batch: dict, generator=None):
        """(trained total, losses) of one batch: ``batch['audio']`` (B, T),
        ``batch['time_labels']`` {group: {label: (B, T_emb) int}}."""
        m = self.models
        dev = m.device
        wav = torch.as_tensor(batch["audio"], dtype=torch.float32, device=dev)
        time_labels = tree_map(lambda a: torch.as_tensor(a, device=dev).long(),
                               batch["time_labels"])
        weights = m.label_weights
        x = wav[:, :, None]
        emb_narrow = m.encoder(x, generator=generator)
        mix_key = next(iter(emb_narrow.keys()))
        mix_size = sum(self.rolls)

        wav_order = expand(x, mix_size, 0)
        emb_order = {k: expand(v, mix_size, 0) for k, v in emb_narrow.items()}
        emb_mix = dict(emb_order)
        emb_mix[mix_key] = mix(emb_mix[mix_key], self.rolls, 0)
        wav_generated_mix = m.decoder(emb_mix, generator=generator)
        wav_generated_narrow = wav_generated_mix[: self.batch_size]
        emb_generated_mix = m.encoder(wav_generated_mix, generator=generator)
        emb_generated_order = dict(emb_generated_mix)
        emb_generated_order[mix_key] = unmix(emb_generated_order[mix_key], self.rolls, 0)
        wav_regenerated_order = m.decoder(emb_generated_order, generator=generator)

        wav_generated_all = torch.cat([wav_regenerated_order, wav_generated_mix], 0)
        wav_generated_order_all = torch.cat([wav_regenerated_order, wav_generated_narrow], 0)
        wav_order_all = torch.cat([wav_order, x], 0)
        det_emb = {k: v.detach() for k, v in emb_narrow.items()}
        det_wav_generated_all = wav_generated_all.detach()

        def mel(w):
            return log_mel_spectrogram(w[..., 0], self.mel_cfg)

        def adversarial_data():
            t = state.disc_copy(wav_order_all, generator=generator)
            g = state.disc_copy(wav_generated_all, generator=generator)
            t_mean, t_fmap = t["output"]["mean"], t["features"]
            g_mean, g_fmap = g["output"]["mean"], g["features"]
            g_fmap_clipped = [f[: wav_order_all.shape[0]] for f in g_fmap]
            return {
                "disc": {
                    "main": {"truth": t_mean["output"], "generated": -g_mean["output"]},
                    "sub": {"truth": t_mean["features"],
                            "generated": [-lo for lo in g_mean["features"]]},
                },
                "fmap": (g_fmap_clipped, t_fmap),
            }

        def labelled(preds):
            return {k1: {k2: (cls2, time_labels[k1][k2], weights[k1][k2])
                         for k2, cls2 in cls.items()} for k1, cls in preds.items()}

        keepers_data = {key: labelled(m.keepers[key](emb_narrow[key], generator=generator)["mean"])
                        for key in m.keepers}
        hunt_data = {}
        for key in m.hunters:
            with torch.no_grad():
                keeper_preds = m.keepers[key](det_emb[key], generator=generator)["mean"]
                bias = m.sniffers[key](keeper_preds[key], generator=generator)["mean"]
            hunter_preds = state.hunter_copies[key](emb_narrow[key], generator=generator)["mean"]
            hunt_data[key] = {
                l1: {l2: (hunter_preds[l1][l2], b2, time_labels[l1][l2], weights[l1][l2])
                     for l2, b2 in b.items()}
                for l1, b in bias.items()}

        generator_data = _merge_dicts(
            {"raw_recon": {"wav": (wav_generated_order_all, wav_order_all),
                           "mel": (mel(wav_generated_order_all), mel(wav_order_all))},
             "emb_recon": (emb_generated_order, emb_order)},
            {"adversarial": {"discriminator": adversarial_data()}},
            {"keepers": keepers_data},
            {"adversarial": {"hunters": hunt_data}},
        )

        # live discriminator: the first call's power iteration feeds the second
        t = m.discriminator(x, generator=generator)["output"]["mean"]
        g = m.discriminator(det_wav_generated_all, generator=generator)["output"]["mean"]
        disc_data = {"main": {"truth": t["output"], "generated": -g["output"]},
                     "sub": {"truth": t["features"], "generated": [-lo for lo in g["features"]]}}

        hunters_data = {key: labelled(m.hunters[key](det_emb[key], generator=generator)["mean"])
                        for key in m.hunters}
        sniffers_data = {}
        for key in m.sniffers:
            with torch.no_grad():
                keeper_preds = m.keepers[key](det_emb[key], generator=generator)["mean"]
            bias = m.sniffers[key](keeper_preds[key], generator=generator)["mean"]
            sniffers_data[key] = {
                l1: {l2: (b2, time_labels[l1][l2], weights[l1][l2]) for l2, b2 in b.items()}
                for l1, b in bias.items()}

        all_data = {"generator": generator_data, "discriminator": disc_data,
                    "hunters": hunters_data, "sniffers": sniffers_data}
        losses, trained = calculate_losses(self.loss_funcs, self.loss_factors,
                                           self.loss_backward, all_data)
        return trained, losses

    # ------------------------------------------------------------------

    def make_train_step(self):
        """``step(state, batch, generator=None) -> (state, losses)``."""
        groups = list(self.flat_groups)

        def step(state: DistillTrainState, batch: dict, generator=None):
            for opt in state.optimizers.values():
                for p in opt.params:
                    p.grad = None
            trained, losses = self.compute_losses(state, batch, generator)
            trained.backward()
            with torch.no_grad():
                for g in groups:
                    pairs = [(a, p.grad) for a, p in zip(state.grad_accum[g],
                                                         state.optimizers[g].params)
                             if p.grad is not None]
                    if pairs:
                        torch._foreach_add_([a for a, _ in pairs], [d for _, d in pairs])
                    for p in state.optimizers[g].params:
                        p.grad = None
            state.step += 1
            if state.step % self.accumulate == 0:
                lr_scale = float(np.float32(self.lr_decay) ** np.float32(state.step))
                with torch.no_grad():
                    for g in groups:
                        grads = torch._foreach_div(state.grad_accum[g], float(self.accumulate))
                        gnorm = float(torch.linalg.vector_norm(
                            torch.stack(torch._foreach_norm(grads))))
                        torch._foreach_mul_(grads, min(1.0, self.clip_value / (gnorm + 1e-6)))
                        state.optimizers[g].step(grads, float(np.float32(self.flat_groups[g])
                                                              * np.float32(lr_scale)),
                                                 apply=bool(np.isfinite(gnorm)))
                        torch._foreach_zero_(state.grad_accum[g])
            with torch.no_grad():
                _copy_state(state.disc_copy, self.models.discriminator)
                for k, h in self.models.hunters.items():
                    _copy_state(state.hunter_copies[k], h)
            return state, tree_map(lambda v: v.detach(), losses)

        return step

    # ------------------------------------------------------------------

    def make_eval_step(self):
        """``eval(state, batch, generator=None) -> (losses, data)``: the
        step's losses and ``data`` = ``{'wav': {truth, generated}, 'mel':
        {truth, generated}, 'label': {truth, keep, sniff, hunt}}``, as the
        JAX eval step gives them; no gradient, and the live discriminator's
        spectral state is left as it was (the JAX step discards it). Noise
        nodes draw from ``generator``."""
        m = self.models

        @torch.no_grad()
        def eval_fn(state: DistillTrainState, batch: dict, generator=None):
            bufs = {k: v.clone() for k, v in m.discriminator.named_buffers()}
            try:
                _trained, losses = self.compute_losses(state, batch, generator)
            finally:
                live = dict(m.discriminator.named_buffers())
                for k, v in bufs.items():
                    live[k].copy_(v)
            wav = torch.as_tensor(batch["audio"], dtype=torch.float32, device=m.device)
            x = wav[:, :, None]
            emb = m.encoder(x, generator=generator)
            wav_generated = m.decoder(emb, generator=generator)

            def mel(w):
                return log_mel_spectrogram(w[..., 0], self.mel_cfg)

            keeps, sniffs, hunts = {}, {}, {}
            for key in m.keepers:
                kp = m.keepers[key](emb[key], generator=generator)["mean"]
                keeps.update(kp)
                sniffs.update(m.sniffers[key](kp[key], generator=generator)["mean"])
                hunts.update(m.hunters[key](emb[key], generator=generator)["mean"])
            data = {
                "wav": {"truth": x, "generated": wav_generated},
                "mel": {"truth": mel(x), "generated": mel(wav_generated)},
                "label": {"truth": tree_map(lambda a: torch.as_tensor(a, device=m.device),
                                            batch["time_labels"]),
                          "keep": keeps, "sniff": sniffs, "hunt": hunts},
            }
            return tree_map(lambda v: v.detach(), losses), data

        return eval_fn
