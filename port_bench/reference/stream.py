"""The part of a streamed utterance that must equal whole-utterance synthesis.

A stream is fed an utterance's mel chunk by chunk, then silence to flush it,
and emits its waveform ``delay`` samples behind the input frontier (the
streamer's own declared delay). Whole-utterance synthesis zero-pads every
layer at both ends of the utterance; a stream has zero history at the start
and silence after the end instead. So the two agree exactly, up to float
order, on the samples whose receptive field lies inside the utterance:
``[R, n - R)`` with R the Generator's one-sided receptive field
(:func:`port_bench.reference.generator.receptive_field`).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from port_bench.reference.generator import receptive_field


def crop(h: Any, streamed: np.ndarray, delay: int, n_samples: int) -> tuple[np.ndarray, slice]:
    """(the streamed samples of utterance positions [R, n - R), that slice of
    the whole-utterance waveform). ``streamed`` is the stream's output from
    its first chunk on."""
    r = receptive_field(h)
    if n_samples <= 2 * r:
        raise ValueError(f"an utterance of {n_samples} samples has no interior (R={r})")
    return streamed[delay + r:delay + n_samples - r], slice(r, n_samples - r)
