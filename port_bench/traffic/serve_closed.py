"""Closed-loop serving: one client, one request at a time, B = ``batch``.

Each request is one utterance of the mix's length set (frames rounded up to
``round_frames``), in an order drawn from the seed and cycled. Its mel waits
in host memory; a request is timed from the call into the program to the
waveform's arrival in host memory (``.cpu()``), and the next one is sent when
it is back. Set-up makes the weights and the mels on the device from the
seed and sends every distinct shape once. Every returned waveform is kept;
once the window has closed, the check compares a sample of them drawn from
the seed, the longest request among them, with the fp32 reference.
"""

from __future__ import annotations

import random
import sys
import time
import traceback

import torch

from port_bench import inputs, synthesis
from port_bench.harness import Reading, Unit, Window
from port_bench.traffic import lengths


class Driver:
    def __init__(self, run):
        self.run = run
        h, mix = run.h, run.mix
        self.batch = mix["batch"]
        self.frames = lengths.frames(h, mix["utterances"], mix["round_frames"])
        self.order = lengths.order(len(self.frames), run.seed, "requests")
        self.params = synthesis.generator_weights(run)
        gen = inputs.generator_for(run.seed, run.device, synthesis.DATA)
        n = len(self.frames)
        mels = inputs.mels_for(h, self.frames * self.batch, gen, run.device)
        # request i: rows i, i + n, ... of the drawn mels; held in host memory
        self.mels = [torch.stack(mels[i::n][:self.batch]).cpu() for i in range(n)]
        self.fn = synthesis.fast_vocoder(run, self.params)
        self.audio_s = [f * h["hop_size"] / h["sampling_rate"] * self.batch for f in self.frames]
        self.kept: list = []
        for f in sorted(set(self.frames)):  # every shape of the cell, once
            self.fn(self.mels[self.frames.index(f)]).cpu()

    def window(self, seconds: float) -> Window:
        run, units, failed = self.run, [], 0
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            r = self.order[i % len(self.order)]
            i += 1
            try:
                with run.span("port_bench.request"):
                    start = time.perf_counter()
                    with run.span("program call"):
                        y = self.fn(self.mels[r])
                    called = time.perf_counter()
                    with run.span("wait for the output"):
                        wav = y.cpu()
                end = time.perf_counter()
            except Exception:  # a request that fails is counted, the loop goes on
                failed += 1
                traceback.print_exc(file=sys.stderr)
                continue
            units.append(Unit(start, end, self.audio_s[r], called - start,
                              {"gen_frames": self.frames[r] * self.batch,
                               "b1": [(self.batch, self.frames[r], run.h["fold_post"])]}))
            self.kept.append((r, wav))
        t1 = units[-1].end if units else time.perf_counter()
        return Window(units, t0, t1, i, failed)

    def release(self) -> None:
        self.fn = None

    def check(self, limits: dict) -> list:
        """The worst error ratio (:func:`synthesis.err_ratio`) over a seeded sample of the completed
        requests (``check_requests`` of them, the longest one among them)."""
        done = {}
        for r, wav in self.kept:
            done.setdefault(r, wav)
        if not done:
            return [Reading("wav_err_ratio", float("inf"), limits["wav_err_ratio"])]
        rng = random.Random(f"{self.run.seed}:check")
        ids = sorted(done)
        sample = set(rng.sample(ids, min(self.run.mix["check_requests"] - 1, len(ids))))
        sample.add(max(ids, key=lambda r: (self.frames[r], -r)))
        worst = 0.0
        for r in sorted(sample):
            for b in range(self.batch):
                ref, rounded = synthesis.reference_wavs(self.run, self.params, self.mels[r][b])
                worst = max(worst, synthesis.err_ratio(done[r][b], ref, rounded))
        return [Reading("wav_err_ratio", worst, limits["wav_err_ratio"])]
