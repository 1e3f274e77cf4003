"""Live streaming: ``streams`` streams in lockstep through the stateful
streamer (``make_streaming_vocoder``: ``init_state`` / ``step``).

Each stream is one utterance of the mix's length set. The set, in ascending
length, is dealt into groups of ``streams`` (group g takes utterances g,
g + G, g + 2G, ...), so every group spans the distribution and every seed
gets the same groups; the seed orders the groups and the streams within
each. A group starts together, is fed ``chunk_frames`` mel frames a step,
then silence (the log-mel floor) until its longest utterance has come out
past the streamer's delay, and the batch state is made anew for the next
group. A unit is one step of all streams, timed from the call into the
program to the chunk's arrival in host memory; it completes the audio of
the utterances that it emits. Set-up sends one group through. The check
compares the streams of a seeded sample of the completed groups, inside
their utterance, with the fp32 reference's whole-utterance waveform. In the
control's run the reference, in the control precision, synthesises each
checked stream whole in the streamer's place.
"""

from __future__ import annotations

import math
import random
import sys
import time
import traceback

import numpy as np
import torch

from port_bench import inputs, synthesis
from port_bench.harness import Reading, Unit, Window
from port_bench.reference import stream
from port_bench.reference.generator import generator, receptive_field
from port_bench.reference.numerics import BY_NAME
from port_bench.traffic import lengths

SILENCE = math.log(1e-5)  # the log-mel of silence (the clamp floor)


class Driver:
    def __init__(self, run):
        self.run = run
        h, mix = run.h, run.mix
        s, self.chunk = mix["streams"], mix["chunk_frames"]
        self.hop, self.sr = h["hop_size"], h["sampling_rate"]
        self.frames = lengths.frames(h, mix["utterances"], 1)
        groups = lengths.groups(len(self.frames), s)
        n_groups = len(groups)
        self.groups = [[grp[i] for i in lengths.order(s, run.seed, f"streams{g}")]
                       for g, grp in enumerate(groups)]
        self.order = lengths.order(n_groups, run.seed, "groups")
        self.params = synthesis.generator_weights(run)
        gen = inputs.generator_for(run.seed, run.device, synthesis.DATA)
        self.mels = [m.cpu() for m in inputs.mels_for(h, self.frames, gen, run.device)]
        if run.program == "control":
            self.init_state = self.step = None
            self.delay = receptive_field(h)
        else:
            from hifigan_tpu_torch.models import streaming

            self.init_state, self.step, self.delay = streaming.make_streaming_vocoder(
                h, self.params, dtype=synthesis.serve_dtype(h), device=run.device)
        lag = -(-self.delay // self.hop)  # frames of silence that flush the delay
        self.chunks = []  # per group: the host chunks (streams, M, chunk) of each step
        for grp in self.groups:
            steps = -(-(max(self.frames[u] for u in grp) + lag) // self.chunk)
            full = torch.full((s, h["num_mels"], steps * self.chunk), SILENCE)
            for k, u in enumerate(grp):
                full[k, :, :self.frames[u]] = self.mels[u]
            self.chunks.append([full[..., i * self.chunk:(i + 1) * self.chunk].contiguous()
                                for i in range(steps)])
        rng = random.Random(f"{run.seed}:check")
        self.keep = set(rng.sample(range(n_groups), min(mix["check_groups"], n_groups)))
        self.kept: dict = {}
        if self.step is not None:  # one group through: every shape of the cell
            state = self.init_state(s)
            for c in self.chunks[self.order[0]]:
                state, y = self.step(state, c)
                y.cpu()

    def _audio_s(self, grp: list, i: int) -> float:
        """Seconds of utterance audio in step ``i``'s output of a group."""
        a, b = i * self.chunk * self.hop - self.delay, (i + 1) * self.chunk * self.hop - self.delay
        return sum(max(0, min(b, self.frames[u] * self.hop) - max(a, 0))
                   for u in grp) / self.sr

    def window(self, seconds: float) -> Window:
        run, units, failed, attempted = self.run, [], 0, 0
        s = len(self.groups[0])
        t0 = time.perf_counter()
        if self.step is None:  # the control streams nothing: it is read whole in check()
            return Window(units, t0, t0, 0, 0)
        j = 0
        while time.perf_counter() - t0 < seconds:
            g = self.order[j % len(self.order)]
            keep = j < len(self.order) and g in self.keep
            outs = []
            state = self.init_state(s)
            for i, chunk in enumerate(self.chunks[g]):
                if time.perf_counter() - t0 >= seconds:
                    break
                attempted += 1
                try:
                    with run.span("port_bench.chunk"):
                        start = time.perf_counter()
                        with run.span("program call"):
                            state, y = self.step(state, chunk)
                        called = time.perf_counter()
                        with run.span("wait for the output"):
                            wav = y.cpu()
                    end = time.perf_counter()
                except Exception:  # a step that fails is counted; the group stops
                    failed += 1
                    traceback.print_exc(file=sys.stderr)
                    break
                units.append(Unit(start, end, self._audio_s(self.groups[g], i), called - start,
                                  {"gen_frames": s * self.chunk,
                                   "b1": [(s, self.chunk, False)]}))
                if keep:
                    outs.append(wav)
            else:
                if keep:
                    self.kept[g] = torch.cat(outs, dim=2)
            j += 1
        t1 = units[-1].end if units else time.perf_counter()
        return Window(units, t0, t1, attempted, failed)

    def release(self) -> None:
        self.init_state = self.step = None

    @torch.no_grad()
    def _control_outputs(self) -> None:
        """The control in the streamer's place: each kept group's utterances
        synthesised whole in the control precision, placed ``delay`` samples
        into their stream as the streamer places them."""
        num = BY_NAME[self.run.h["serve_control"]]
        for g in self.keep:
            rows = []
            for u in self.groups[g]:
                wav = generator(self.run.h, self.params, self.mels[u][None].to(self.run.device),
                                num)[0, 0].cpu()
                rows.append(torch.cat([torch.zeros(self.delay), wav]))
            n = max(r.numel() for r in rows)
            self.kept[g] = torch.stack([torch.nn.functional.pad(r, (0, n - r.numel()))
                                        for r in rows])[:, None]

    def check(self, limits: dict) -> list:
        """The worst error ratio (:func:`synthesis.err_ratio`), over every
        stream of the kept groups, of the streamed samples inside the
        utterance (:func:`stream.crop`)."""
        if self.run.program == "control":
            self._control_outputs()
        if not self.kept:
            return [Reading("wav_err_ratio", float("inf"), limits["wav_err_ratio"])]
        worst = 0.0
        for g, out in sorted(self.kept.items()):
            for k, u in enumerate(self.groups[g]):
                ref, rounded = synthesis.reference_wavs(self.run, self.params, self.mels[u])
                got, sl = stream.crop(self.run.h, np.asarray(out[k, 0]), self.delay,
                                      self.frames[u] * self.hop)
                worst = max(worst, synthesis.err_ratio(got, ref[sl], rounded[sl]))
        return [Reading("wav_err_ratio", worst, limits["wav_err_ratio"])]
