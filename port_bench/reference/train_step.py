"""The HiFi-GAN V1 GAN train step (jik876/hifi-gan ``train.py``), functional.

One step, in upstream order: the generator runs once on the input mel; the
discriminator update (LSGAN loss of MPD and MSD on the real and the detached
generated waveform), AdamW on every MPD and MSD parameter; then the
generator update against the updated discriminators: LSGAN generator loss,
feature matching x2 and 45 x the L1 distance of the log-mels
(``fmax_for_loss``), AdamW on the generator. AdamW as ``torch.optim.AdamW``
writes it: decoupled weight decay 0.01, betas from the configuration, eps
1e-8, bias-corrected moments. The discriminators' gradients in the
generator update are never formed (their weights are constants there).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from port_bench.reference.discriminators import mpd, msd
from port_bench.reference.generator import generator
from port_bench.reference.mel import log_mel
from port_bench.reference.numerics import FP32, Numerics

WEIGHT_DECAY = 0.01
EPS = 1e-8


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl))
    return loss * 2


def discriminator_loss(real, generated) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(real, generated):
        loss = loss + torch.mean(torch.square(1.0 - dr)) + torch.mean(torch.square(dg))
    return loss


def generator_loss(generated) -> torch.Tensor:
    loss = 0.0
    for dg in generated:
        loss = loss + torch.mean(torch.square(1.0 - dg))
    return loss


@dataclasses.dataclass
class AdamW:
    lr: float
    betas: tuple[float, float]
    step: int = 0
    m: dict = dataclasses.field(default_factory=dict)
    v: dict = dataclasses.field(default_factory=dict)

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        self.step += 1
        b1, b2 = self.betas
        bc1, bc2 = 1.0 - b1 ** self.step, 1.0 - b2 ** self.step
        for name, p in params.items():
            g = grads[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            p.mul_(1.0 - self.lr * WEIGHT_DECAY)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / bc2 ** 0.5).add_(EPS)
            p.addcdiv_(m, denom, value=-self.lr / bc1)


@dataclasses.dataclass
class TrainState:
    """Parameters by upstream name, prefixed ``generator.``, ``mpd.``, ``msd.``;
    the spectral-norm buffers (``msd....weight_u`` / ``weight_v``)."""

    params: dict
    buffers: dict
    opt_g: AdamW
    opt_d: AdamW


def new_state(h: Any, params: dict, buffers: dict) -> TrainState:
    """A state on fresh fp32 copies of ``params`` and ``buffers``."""
    p = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
    b = {k: v.detach().float().clone() for k, v in buffers.items()}
    betas = (h["adam_b1"], h["adam_b2"])
    return TrainState(p, b, AdamW(h["learning_rate"], betas), AdamW(h["learning_rate"], betas))


def _group(params: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def train_step(h: Any, state: TrainState, audio: torch.Tensor, mel: torch.Tensor,
               num: Numerics = FP32) -> tuple[dict, dict]:
    """One step in place on ``state``: (losses, {name: gradient}) where the
    gradients are the ones each optimizer received."""
    p = state.params
    gen_p = _group(p, "generator.")
    d_names = [k for k in p if not k.startswith("generator.")]
    d_p = {k: p[k] for k in d_names}

    y = audio.float()
    y_mel = log_mel(h, y, "fmax_for_loss")
    y_g_hat = generator(h, gen_p, mel, num)[:, 0, :]

    f_r, f_g, _, _ = mpd(h, d_p, y, y_g_hat.detach(), num)
    s_r, s_g, _, _ = msd(h, d_p, state.buffers, y, y_g_hat.detach(), num)
    loss_d = discriminator_loss(f_r, f_g) + discriminator_loss(s_r, s_g)
    d_grads = dict(zip(d_names, torch.autograd.grad(loss_d, [d_p[k] for k in d_names])))
    state.opt_d.update(d_p, d_grads)

    frozen = {k: v.detach() for k, v in d_p.items()}
    loss_mel = torch.mean(torch.abs(y_mel - log_mel(h, y_g_hat, "fmax_for_loss"))) * 45.0
    _, y_df_g, fm_f_r, fm_f_g = mpd(h, frozen, y, y_g_hat, num)
    _, y_ds_g, fm_s_r, fm_s_g = msd(h, frozen, state.buffers, y, y_g_hat, num)
    loss_g = (generator_loss(y_df_g) + generator_loss(y_ds_g) + feature_loss(fm_f_r, fm_f_g)
              + feature_loss(fm_s_r, fm_s_g) + loss_mel)
    g_names = [f"generator.{k}" for k in gen_p]
    g_grads = dict(zip(g_names, torch.autograd.grad(loss_g, list(gen_p.values()))))
    state.opt_g.update({k: p[k] for k in g_names}, g_grads)
    losses = {"loss_gen_all": loss_g.detach(), "loss_disc_all": loss_d.detach()}
    return losses, {**d_grads, **g_grads}
