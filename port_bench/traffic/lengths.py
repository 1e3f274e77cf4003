"""Utterance lengths of a mix, the same set for every seed.

A mix's ``utterances`` block gives a duration distribution (a normal with
``mean_s`` and ``std_s``, clipped to ``[min_s, max_s]``) and a ``count``. The
set is the distribution's ``count`` quantiles (midpoints), so every seed gets
the same sizes and so the same work; the seed only orders them. Durations
become mel frames at the configuration's hop and rate, rounded up to
``round_frames``.
"""

from __future__ import annotations

import math
import random
import statistics
from typing import Any


def durations(utt: dict) -> list[float]:
    """The ``count`` quantile midpoints of the clipped normal, ascending."""
    dist = statistics.NormalDist(utt["mean_s"], utt["std_s"])
    n = utt["count"]
    return [min(max(dist.inv_cdf((i + 0.5) / n), utt["min_s"]), utt["max_s"]) for i in range(n)]


def frames(h: Any, utt: dict, round_frames: int) -> list[int]:
    """Each duration as mel frames, rounded up to a multiple of ``round_frames``."""
    hop, sr = h["hop_size"], h["sampling_rate"]
    return [math.ceil(math.ceil(d * sr / hop) / round_frames) * round_frames
            for d in durations(utt)]


def order(n: int, seed: int, salt: str) -> list[int]:
    """A permutation of range(n) drawn from the seed."""
    idx = list(range(n))
    random.Random(f"{seed}:{salt}").shuffle(idx)
    return idx


def buckets(frames: list[int], batch: int) -> list[tuple[int, list[int]]]:
    """Batches of ``batch`` utterances of one length, ascending: each length's
    utterances in order, its last batch filled from its first ones."""
    out = []
    for f in sorted(set(frames)):
        idx = [i for i, x in enumerate(frames) if x == f]
        idx = [idx[i % len(idx)] for i in range(-(-len(idx) // batch) * batch)]
        out += [(f, idx[j:j + batch]) for j in range(0, len(idx), batch)]
    return out


def groups(n: int, size: int) -> list[list[int]]:
    """Utterances 0..n-1 (ascending length) dealt into n // size groups of
    ``size``: group g takes g, g + G, g + 2G, ..., so each spans the lengths."""
    n_groups = n // size
    return [list(range(g, n_groups * size, n_groups)) for g in range(n_groups)]
