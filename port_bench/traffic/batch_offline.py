"""Offline batch synthesis: batches of ``batch`` utterances of one length
bucket, dispatched ahead with ``in_flight`` batches on the device.

The mix's length set is rounded up to ``round_frames`` (the buckets) and cut
into batches within each bucket (a bucket's last batch is filled from the
bucket's start), the same batches for every seed; the seed orders them.
The mels wait on the device (a corpus being vocoded). A batch's waveform is
copied into pinned host memory asynchronously; it counts once that copy has
finished. Set-up sends every bucket's shape once. The check compares a
seeded sample of the completed batches, the longest bucket among them, with
the fp32 reference, every utterance of each.
"""

from __future__ import annotations

import collections
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
        frames = lengths.frames(h, mix["utterances"], mix["round_frames"])
        b = mix["batch"]
        self.batches = lengths.buckets(frames, b)  # (frames, [utterance indices])
        self.order = lengths.order(len(self.batches), run.seed, "batches")
        self.params = synthesis.generator_weights(run)
        gen = inputs.generator_for(run.seed, run.device, synthesis.DATA)
        mels = inputs.mels_for(h, frames, gen, run.device)
        self.mels = [torch.stack([mels[i] for i in idx]) for _, idx in self.batches]
        hop = h["hop_size"]
        self.audio_s = [f * hop / h["sampling_rate"] * len(idx) for f, idx in self.batches]
        self.fn = synthesis.fast_vocoder(run, self.params)
        longest = max(f for f, _ in self.batches)
        pinned = run.device.type == "cuda"
        self.host = [torch.empty(b * longest * hop, pin_memory=pinned)
                     for _ in range(mix["in_flight"])]
        rng = random.Random(f"{run.seed}:check")
        keep = rng.sample(range(len(self.order)), min(mix["check_batches"] - 1, len(self.order)))
        keep.append(min(j for j, k in enumerate(self.order) if self.batches[k][0] == longest))
        self.keep = set(keep)  # positions in the order, within its first cycle
        self.kept: dict = {}
        for f in sorted(set(f for f, _ in self.batches)):  # every bucket's shape, once
            k = next(k for k, (g, _) in enumerate(self.batches) if g == f)
            self.fn(self.mels[k]).cpu()

    def window(self, seconds: float) -> Window:
        run, units, failed = self.run, [], 0
        pending = collections.deque()
        slots = len(self.host)

        def complete():
            j, k, start, called, done, out = pending.popleft()
            with run.span("wait for the output"):
                done.synchronize()
            end = time.perf_counter()
            f, idx = self.batches[k]
            units.append(Unit(start, end, self.audio_s[k], called - start,
                              {"gen_frames": f * len(idx),
                               "b1": [(len(idx), f, run.h["fold_post"])]}))
            if j in self.keep and j not in self.kept:
                self.kept[j] = out.clone()

        t0 = time.perf_counter()
        j = 0
        while time.perf_counter() - t0 < seconds:
            k = self.order[j % len(self.order)]
            f, idx = self.batches[k]
            try:
                with run.span("port_bench.batch"):
                    start = time.perf_counter()
                    with run.span("program call"):
                        y = self.fn(self.mels[k])
                    called = time.perf_counter()
                    out = self.host[j % slots][:y.numel()].view(y.shape)
                    out.copy_(y, non_blocking=True)
                    done = torch.cuda.Event() if run.device.type == "cuda" else _Done()
                    done.record()
            except Exception:  # a batch that fails is counted, the loop goes on
                failed += 1
                traceback.print_exc(file=sys.stderr)
                j += 1
                continue
            pending.append((j, k, start, called, done, out))
            j += 1
            if len(pending) >= self.run.mix["in_flight"]:
                complete()
        while pending:
            complete()
        t1 = units[-1].end if units else time.perf_counter()
        return Window(units, t0, t1, j, failed)

    def release(self) -> None:
        self.fn = None

    def check(self, limits: dict) -> list:
        """The worst error ratio (:func:`synthesis.err_ratio`) over every utterance
        of the kept batches."""
        if not self.kept:
            return [Reading("wav_err_ratio", float("inf"), limits["wav_err_ratio"])]
        worst = 0.0
        for j, out in sorted(self.kept.items()):
            k = self.order[j % len(self.order)]
            for row in range(out.shape[0]):
                ref, rounded = synthesis.reference_wavs(self.run, self.params,
                                                        self.mels[k][row])
                worst = max(worst, synthesis.err_ratio(out[row], ref, rounded))
        return [Reading("wav_err_ratio", worst, limits["wav_err_ratio"])]


class _Done:
    """A finished event, for a run on the CPU (where every call is synchronous)."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass
