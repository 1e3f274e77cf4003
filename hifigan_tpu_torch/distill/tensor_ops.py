"""Batch mixing ops (PyTorch port of ``hifigan_tpu/distill/tensor_ops.py``).

expand: tile the batch axis (with a final partial copy) up to ``size``.
mix:    split the batch axis into segments of the given sizes and roll
        segment i by +i — the batch-mixing permutation.
unmix:  inverse (roll by -i).
cut_and_roll: roll the tail (from ``cut``) of an axis by one batch position.
"""

from __future__ import annotations

import torch


def expand(tensor: torch.Tensor, size: int, dim: int = 0) -> torch.Tensor:
    n = tensor.shape[dim]
    reps, rem = divmod(size, n)
    parts = [tensor] * reps
    if rem:
        parts.append(tensor.narrow(dim, 0, rem))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]


def _split_sizes(tensor: torch.Tensor, rolls, dim: int):
    return torch.split(tensor, list(rolls), dim=dim)


def mix(tensor: torch.Tensor, rolls, dim: int = 0) -> torch.Tensor:
    parts = _split_sizes(tensor, rolls, dim)
    return torch.cat([torch.roll(p, i, dims=dim) for i, p in enumerate(parts)], dim=dim)


def unmix(tensor: torch.Tensor, rolls, dim: int = 0) -> torch.Tensor:
    parts = _split_sizes(tensor, rolls, dim)
    return torch.cat([torch.roll(p, -i, dims=dim) for i, p in enumerate(parts)], dim=dim)


def cut_and_roll(tensor: torch.Tensor, cut: int, cut_dim: int, roll_dim: int) -> torch.Tensor:
    length = tensor.shape[cut_dim]
    head = tensor.narrow(cut_dim, 0, cut)
    tail = torch.roll(tensor.narrow(cut_dim, cut, length - cut), 1, dims=roll_dim)
    return torch.cat([head, tail], dim=cut_dim)
