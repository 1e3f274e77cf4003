"""Faults planted in the program, for the checks that ``correct`` must fail.

Each fault breaks the timed path underneath the harness, by replacing one
of the program's functions while the context is open:

- ``frozen``: the state is returned unchanged (the trainer's optimizer steps
  do nothing; the streamer's step hands back the state it was given);
- ``half_batch``: half of the batch is left out (the train step runs on the
  first half of the rows, its losses the means over them; batch synthesis
  computes the first half of the rows and returns them twice);
- ``alter``: an answer is altered where it is produced (the middle tenth of
  every synthesised or streamed waveform, or of the generator's output in
  the train step, is zeroed).

The calibration runs on the card read the faults' numbers at the cell's
size; the CPU tests see each one turn ``correct`` false.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("frozen", "half_batch", "alter")


def _zero_middle(y: torch.Tensor) -> torch.Tensor:
    n = y.shape[-1]
    y = y.clone()
    y[..., n * 9 // 20:n * 11 // 20] = 0
    return y


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` in every entry point the drivers call."""
    from hifigan_tpu_torch.models import Generator, fast_infer, streaming
    from hifigan_tpu_torch.train import vocoder

    saved = [(vocoder, "_step_optimizer", vocoder._step_optimizer),
             (vocoder, "make_train_step", vocoder.make_train_step),
             (fast_infer, "make_fast_vocoder", fast_infer.make_fast_vocoder),
             (streaming, "make_streaming_vocoder", streaming.make_streaming_vocoder),
             (Generator, "forward", Generator.forward)]
    make_fast, make_stream = fast_infer.make_fast_vocoder, streaming.make_streaming_vocoder
    make_step, forward = vocoder.make_train_step, Generator.forward

    def streamer(*a, **kw):
        init, step, delay = make_stream(*a, **kw)
        if name == "frozen":
            return init, lambda state, chunk: (state, step(state, chunk)[1]), delay
        if name == "alter":
            def altered(state, chunk):
                state, y = step(state, chunk)
                return state, _zero_middle(y)
            return init, altered, delay
        return init, step, delay

    def fast(*a, **kw):
        fn = make_fast(*a, **kw)
        if name == "alter":
            return lambda mel: _zero_middle(fn(mel))
        if name == "half_batch":
            def half(mel):
                y = fn(mel[:max(1, mel.shape[0] // 2)])
                return torch.cat([y, y])[:mel.shape[0]]
            return half
        return fn

    def train_step(h, *a, **kw):
        step = make_step(h, *a, **kw)
        if name != "half_batch":
            return step

        def half(state, batch):
            n = max(1, batch["audio"].shape[0] // 2)
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half

    try:
        streaming.make_streaming_vocoder = streamer
        fast_infer.make_fast_vocoder = fast
        vocoder.make_train_step = train_step
        if name == "frozen":
            vocoder._step_optimizer = lambda *a, **kw: None
        if name == "alter":
            Generator.forward = lambda self, x: _zero_middle(forward(self, x))
        yield
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)
