"""GAN losses for the vocoder (PyTorch port of ``hifigan_tpu/models/losses.py``).

All take lists of tensors and return float32 scalars.
"""

from __future__ import annotations

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """L1 feature matching over every layer of every sub-discriminator, x2;
    the real feature maps are constants."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach().float() - gl.float()))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LSGAN discriminator loss (1 - D(y))^2 + D(G(z))^2."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean(torch.square(1.0 - dr.float()))
        g_loss = torch.mean(torch.square(dg.float()))
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LSGAN generator loss (1 - D(G(z)))^2."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean(torch.square(1.0 - dg.float()))
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def mel_l1_loss(mel_real: torch.Tensor, mel_gen: torch.Tensor) -> torch.Tensor:
    """L1 mel reconstruction term (weight 45 in the HiFi-GAN recipe)."""
    return torch.mean(torch.abs(mel_real - mel_gen))
