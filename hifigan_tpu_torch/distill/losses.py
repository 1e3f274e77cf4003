"""Distillation loss system (PyTorch port of ``hifigan_tpu/distill/losses.py``).

- recursive_loss: fold a leaf loss over parallel nested structures.
- loss registry '-'/'+'/'seg_bce'/'seg_bias_bce'/'l2'/'l1'/'cos'.
- SegBCE family: per-class one-hot BCE with inverse-class-frequency weights
  and +1-smoothed per-class normalisation; SegBiasBCE normalises the
  prediction between the sniffer's bias estimate and the truth.

Classifier probabilities are channels-last (B, T, C); targets are int label
maps (B, T).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F

EPSILON = 1e-08


def recursive_loss(loss_func, x, *args):
    if isinstance(x, Mapping):
        return sum(recursive_loss(loss_func, x[k], *[a[k] for a in args]) for k in x.keys())
    if isinstance(x, (list, tuple)):
        return sum(recursive_loss(loss_func, x[i], *[a[i] for a in args]) for i in range(len(x)))
    return loss_func(x, *args)


def minus_mean_loss(*x):
    return +sum(torch.mean(_x) for _x in x)


def plus_mean_loss(*x):
    return -sum(torch.mean(_x) for _x in x)


def l1_loss(x, target):
    return torch.mean(torch.abs(x - target))


def l2_loss(x, target):
    return torch.mean(torch.square(x - target))


def cosine_loss(x, target):
    """torch CosineEmbeddingLoss with target=1: mean(1 - cos_sim) over the
    batch, flattening all non-batch dims."""
    fx = x.reshape(x.shape[0], -1)
    ft = target.reshape(target.shape[0], -1)
    cos = torch.sum(fx * ft, dim=1) / (
        torch.linalg.vector_norm(fx, dim=1) * torch.linalg.vector_norm(ft, dim=1) + EPSILON)
    return torch.mean(1.0 - cos)


def ratios_to_weights(ratios, device=None) -> torch.Tensor:
    """Inverse-frequency class weights; zero ratios clamped to the smallest
    non-zero ratio."""
    ratios = np.asarray(ratios, dtype=np.float64)
    nonzero = ratios[ratios != 0]
    smallest = nonzero.min() if nonzero.size else EPSILON
    ratios = np.where(ratios == 0, smallest, ratios)
    return torch.from_numpy((ratios ** -1.0).astype(np.float32)).to(device)


def _binary_cross_entropy(p, target):
    p = torch.clamp(p, 0.0, 1.0)
    log_p = torch.log(torch.clamp(p, min=1e-12))
    log_1p = torch.log(torch.clamp(1.0 - p, min=1e-12))
    return -(target * log_p + (1.0 - target) * log_1p)


def normalize_segmentation_loss(loss, target, true_weights, false_weights):
    """Per-class true/false means (+1-smoothed), inverse-frequency weighted.
    loss/target: (B, T, C); weights: (C,)."""
    sum_dims = tuple(i for i in range(loss.dim()) if i not in (0, loss.dim() - 1))
    false_target = 1.0 - target
    true_per_class = (target * loss).sum(dim=sum_dims) / (target.sum(dim=sum_dims) + 1)
    false_per_class = (false_target * loss).sum(dim=sum_dims) / (false_target.sum(dim=sum_dims) + 1)
    return (true_per_class * true_weights).mean() + (false_per_class * false_weights).mean()


def _one_hot(labels, num_classes, like):
    return F.one_hot(torch.as_tensor(labels, device=like.device).long(),
                     num_classes).to(like.dtype)


def seg_bce_loss(x, target, ratios=None):
    """x: (B, T, C) probabilities; target: (B, T) int labels;
    ratios: {'true': (C,), 'false': (C,)} class frequencies."""
    one_hot = _one_hot(target, x.shape[-1], x)
    ce = _binary_cross_entropy(x, one_hot)
    return normalize_segmentation_loss(ce, one_hot, ratios_to_weights(ratios["true"], x.device),
                                       ratios_to_weights(ratios["false"], x.device))


def seg_bias_bce_loss(x, target, truth, ratios=None):
    """Hunt-the-bias loss: x (hunter probs), target (sniffer bias probs),
    truth (B, T) int labels."""
    one_hot_truth = _one_hot(truth, x.shape[-1], x)
    high = torch.maximum(one_hot_truth, target)
    low = torch.minimum(one_hot_truth, target)
    scale = high - low + EPSILON
    x_norm = torch.clamp((x - low) / scale, 0.0, 1.0)
    biased_ce = _binary_cross_entropy(x_norm, 1.0 - one_hot_truth) * (scale * scale)
    return normalize_segmentation_loss(biased_ce, target,
                                       ratios_to_weights(ratios["true"], x.device),
                                       ratios_to_weights(ratios["false"], x.device))


loss_types = {
    "-": minus_mean_loss,
    "+": plus_mean_loss,
    "seg_bce": seg_bce_loss,
    "seg_bias_bce": seg_bias_bce_loss,
    "l2": l2_loss,
    "l1": l1_loss,
    "cos": cosine_loss,
}


def get_loss_by_type(loss_type: str):
    return loss_types[loss_type]


def get_losses_by_types(loss_type):
    if isinstance(loss_type, Mapping):
        return {k: get_losses_by_types(t) for k, t in loss_type.items()}
    return get_loss_by_type(loss_type)
