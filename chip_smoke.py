#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``hifigan_tpu_torch/csrc`` (nvcc, sm_90a,
into the git-ignored ``build/kernels``), then:

1. prints the card's name and power limit and the kernels' build time;
2. holds the fused MRF-stage kernel against its plain PyTorch version at
   every V1 stage, full width, at the lengths of a 256-frame request, B=1,
   B=4 and B=16 (the batches whose tiles the main path uses): fp32 (the
   3xTF32 body) with TF32 off within 1e-4, bf16 (the tensor-core body)
   within BF16_REL_TOL of the plain version's peak (see below), both one
   cooperative launch per stage, and V2's four stages (C 64 to 8) at B=1 in
   bf16; prints each call's plan (body, schedule, grid, tile, shared
   memory), errors, times and TFLOP/s, and the stages' sum per V1 request
   at each batch beside the cuDNN chain's (bf16 and fp32); then the same kernel with the
   upsampler folded in (``pre_pack``) at V1's and V2's stages 2 and 3 (the
   stages ``fold_up`` folds), the previous stage's output of a 256-frame
   request as input, B=1, B=4 and B=16 and a ragged T_in at B=3, fp32 (V1)
   and bf16, printing the kernel's time with and without the upsampling
   phase, the plain version's and the cuDNN chain's (transposed conv
   included) and the bound with the upsampler's work;
3. serves V1 mel->wav requests of (1, 80, 256) and (16, 80, 256) through
   ``make_fast_vocoder`` in bf16 with seeded random weights, with the
   launch counts set to 0 just before and read just after (and after each
   request), then the same requests through ``make_fast_vocoder(fold_up=
   True)`` counted the same way; checks shapes, finiteness, the [-1, 1]
   range and each path's error against the plain fp32 ``Generator`` within
   SERVE_REL_TOL of its peak; prints ms per request (median of SERVE_REPS,
   the two paths timed in turn), the real-time factor, launches per request and the folded path's
   distance from the unfolded one; then the same two requests through
   ``make_fast_vocoder(dtype=torch.float32)`` unfolded and with ``fold_up``
   (the fp32 body), counted the same way, each within FP32_TOL of the fp32
   ``Generator``'s peak, with ms per request and the real-time factor;
3b. streams a seeded STREAM_FRAMES-frame V1 mel in STREAM_CHUNK-frame chunks
   at B=1 and B=4 through the stateful streamer (``make_streaming_vocoder``,
   bf16, every stage's MRF through the kernel; the counts set to 0 just
   before and read just after, and per chunk) and the halo streamer
   (``streaming_vocode`` over ``make_fast_vocoder``), each held against
   whole-utterance ``make_fast_vocoder`` synthesis within SERVE_REL_TOL of
   its peak (the stateful one from sample ``delay_samples`` on), then one
   fp32 stateful pass (the 3xTF32 body) against the fp32 ``Generator``
   within FP32_TOL; prints delay_samples, ms per chunk and the real-time
   factor;
4. runs ``python -m hifigan_tpu_torch.cli.infer --fast`` end to end on a
   synthetic sine wav with a torch ``g_*`` file and ``config.json``, then
   with ``--streaming_chunk 32`` and with ``--streaming_chunk 32
   --streaming_state``, checking each wav's length, and ``python -m
   hifigan_tpu_torch.cli.infer_e2e --streaming_chunk 32`` on a seeded
   103-frame mel (its length checked);
5. holds the MSD conv-stack kernels (``fused_conv_stack``: forward, dx, dW
   + db) against their plain versions at the three V1 MSD scales, full
   width, conv_0's output as input, seeded ``MultiScaleDiscriminator``
   weights, N=2 and N=16, fp32 (TF32 off) within FP32_TOL and bf16 within
   BF16_REL_TOL of the plain tensor's peak: every layer's output, and dx,
   dW, db for a loss on every feature map, on the logits only, and with
   ``weight_grads=False``; prints per-pass times of kernel, plain version
   and the cuDNN conv chain, and the bound; then the same holds for the
   zone form: V1's zone chain (layers 2-5 as banded grouped layers on the
   time-folded layout, ``zone_grouped_layer``) at the three scales, layer
   1's output folded as input (scales 1 and 2 end every layer on a partial
   row: its fold-padding lanes must be exact zeros), with per-pass times
   beside the std form's and cuDNN's grouped chain over the same layers and
   the bound from the banded MACs;
6. holds the port's average pool (the MSD's waveform pool, a DSL pool)
   against the CPU, forward and input gradient; trains V1 at full size
   (B=16, 8192 samples, seeded weights, seeded
   synthetic audio) for TRAIN_STEPS steps of ``make_train_step`` with the
   counts set to 0 just before and read just after (and per step): checks
   finite metrics, that every parameter group and scale 0's spectral ``u``
   move, the per-step launches against the count derived from the step's
   structure, and step 1's metrics against the same step with
   ``msd_conv_impl='xla'`` within TRAIN_REL_TOL; before those, step 1 at
   HOLD_BATCH x 8192 from the seeded state against the same step on the
   CPU (``msd_conv_impl='xla'``, computed once for phases 6 and 11): the
   generator's, MPD's and MSD's gradients (Adam first moments) leaf by leaf
   within STEP_GRAD_TOL and updated parameters group by group within
   STEP_UPDATE_TOL, beside the CPU step's own floor (its conv outputs
   jittered by JITTER); prints ms per step and the conv-stack kernels' ms
   per step; then (6b) TRAIN_STEPS steps in bench.py's bf16 training
   precision (``disc_compute_dtype`` and ``gen_compute_dtype``
   'bfloat16'): finite metrics, every group moving, the derived launches
   per step, ms per step; then (6c) the same under ``msd_conv_impl=
   'fused_zoned'`` and under ``disc_fused: true``: step 1 at HOLD_BATCH
   against the same config's CPU step (gradients and parameters, beside its
   jittered floor), TRAIN_STEPS steps in turns with the 'fused_stack' step
   (finite metrics, every group and scale 0's u moving, the conv-stack
   launches and the zone layers' against the derived counts, ms per step),
   and the zoned step 1's MSD feature loss beside the std form's;
7. runs ``python -m hifigan_tpu_torch.cli.train`` on synthetic wavs for
   two steps that write ``g_*``/``do_*``, then again, resuming from them;
8. holds the stream-graph kernels (``fused_stream_graph``: forward, dx,
   dW + db) against their plain versions at every segment of a production
   all-in-one discriminator member (``configs/distill.json``, 3 members,
   seeded weights, 12 elements of 43,680 samples), fp32 (TF32 off) within
   FP32_TOL and bf16 within BF16_REL_TOL of the plain tensor's peak: every
   produced level, and dx, dW, db with every input and weight differentiated,
   with ``weight_grads=False``, and with the weights alone; checks that each
   segment's pass is exactly one launch (forward, dx, dW + db) and that two
   backward runs give the same bits (dx, dW, db) at every segment in both
   dtypes; prints per-segment and per-pass times of kernel and plain
   version, the interpreter's cuDNN conv chain over the whole
   discriminator, and the bound;
9. runs DISTILL_STEPS distillation train steps of ``configs/distill.json``
   at its shipped scale (B=3 x 43,680 samples, fp32, TF32 off, seeded
   weights and synthetic audio, the label set of ``bench.py``) with the
   gradient accumulation cut to 1 (in memory, printed), with the counts set
   to 0 just before and read just after (and per step): checks finite
   losses, that every parameter of the six optimizer groups and the live
   discriminator's spectral power-iteration vector ``v`` move (its ``u``
   has one entry, the before conv having one output channel, so it stays
   +-1), the per-step launches against the
   count derived from the step's structure, and step 1's loss tree against
   the same step with ``member_impl='interpret'`` within DISTILL_REL_TOL,
   its gradients (Adam first moments) leaf by leaf within STEP_GRAD_TOL and
   its updated parameters group by group within STEP_UPDATE_TOL, beside the
   reference's own floor (its conv outputs jittered by JITTER); prints ms
   per step, the host time spent in the stream-graph wrapper and its launch
   functions in steps 3 on, and the stream-graph kernels' share of one
   profiled step;
10. holds the per-layer conv kernels (``msd_conv1d_lrelu``: forward and
   dx) against their plain versions at every V1 MSD layer (full width, the
   three scales' lengths of a B=16 x 8192 step, N=2 and N=16) and at every
   distinct conv call of ``configs/distill.json`` at its step's shapes (the
   generator and classifiers, and the discriminator's members interpreted),
   fp32 (TF32 off) within FP32_TOL and bf16 within BF16_REL_TOL of the plain
   tensor's peak, dx over the kernel's own saved output; prints each call's
   plan, per-layer times of kernel, plain version and cuDNN, TFLOP/s and the
   bound;
11. trains V1 as in phase 6 with ``msd_conv_impl='pallas'`` (every MSD conv
   through the per-layer kernels), the launches per step against the
   derived count (``msd_launches_per_step``), step 1 against
   ``msd_conv_impl='xla'`` and step 1's gradients and parameters against
   the CPU step as in phase 6;
12. runs distillation steps as in phase 9 with ``conv_impl='pallas'`` (every
   conv node of the generator and classifiers through the per-layer
   kernels; the members through the stream-graph kernels), both kernels'
   launches per step against their derived counts
   (``distill_msd_launches_per_step``, each model's conv-op calls held
   against its conv nodes) and step 1 (losses, gradients, parameters)
   against ``conv_impl='auto'``; prints ms per step and both kernels' share
   of one profiled step;
13. extracts log-mels through ``log_mel_spectrogram(y, MelConfig.from_hparams(
   h, method='pallas'))`` at B=16 x 10 s, 16 x 8192 and 16 x 8305 samples
   (the kernel's FFT route) with the count set to 0 just before and read just
   after, holds the fused log-mel kernel against its plain version (forward
   within 2e-4 + 1e-4 |plain|, the gradient of a sin-weighted sum within
   FP32_TOL of its peak, or no further than the plain version's plus that
   from the gradient with a float64 forward's cotangent), then the same on
   16 x 10 s at each geometry of
   ``MEL_GEOMETRIES`` (n_fft = 4 hop: 1200 with radix-5 and 3 passes, 1100
   with radix 11, 1764 at 44.1 kHz with radix 7, 1028 through Bluestein,
   4096 at 2 frames a block, 6404 on the dense route), each one's route and
   frames a block checked against the plan and its launches counted per
   route, and prints kernel, plain and cuFFT times, the bound of the work a
   log-mel needs (a real FFT per frame) and that of the dense-DFT algorithm;
14. serves the distillation autoencoder (``configs/distill.json``, full
   width, fp32, TF32 off, seeded weights): writes an experiment directory
   with the port's writers (``config.yaml`` with ``models.stream_impl``
   'fused', another with 'auto'; ``checkpoints/latest`` as flax msgpack of
   ``{"step", "variables": {encoder, decoder}}``; three synthetic 10 s, 16
   kHz wavs), runs ``python -m hifigan_tpu_torch.cli.infer_autoencoding
   --device cuda`` on both (cuDNN's TF32 off through NVIDIA_TF32_OVERRIDE),
   checks each wav's length (159,978 samples), finiteness and range and the
   fused files within FP32_TOL of the 'auto' files' peak plus one int16
   step; then in process, with the count set to 0 just before and read just
   after, autoencodes the three clips through ``cli.autoencode`` (one
   stream-graph forward launch a fused run: 6 a clip), holds them within
   FP32_TOL of 'auto', prints the runs the pass forms, holds every run's
   segment against its plain version at B=1 and B=3 and prints ms a clip
   (fused and 'auto' timed in turn, the real-time factor), the segments'
   kernel and plain ms, the interpreter's cuDNN chain over the same runs
   and the bound;
15. runs distillation steps as in phase 9 with ``models.stream_impl``
   'fused': launches per step against the members' count plus two
   encoder and two decoder calls' fused runs a pass, step 1 (losses,
   gradients, parameters) against ``stream_impl='auto'``, and every run's
   segment of one encoder + decoder pass at the step's batch (forward, dx,
   dW, db) against the plain versions over the kernel's own outputs, with
   their times; prints ms per step and the idle share of a profiled step;
16. runs the validation eval step (``make_eval_step``, 3 x 109,200) with
   stream_impl 'fused' and 'auto' on the same state: finite trees of the
   right shapes, losses within DISTILL_REL_TOL, the live discriminator's
   state unchanged; then two ``LabelBiasSnifferTrainer`` steps and an eval
   step on the card (finite losses, every parameter moving);
17. trains distillation from its entry point: prints which of pandas,
   matplotlib, yaml, tensorboard, scipy, msgpack, flax and jax import (the
   port needs none but scipy) and which host libraries
   load (libhost_dsp, lame/mpg123, vorbis, libgsm) and so which path each
   augmentation takes; writes a seeded corpus (16 clips of 8 s at 16 kHz, 4
   speakers, 2 sexes, word and phone TextGrids, train and test data
   configs, noise and room-impulse assets for every augmentation option of
   ``configs/distill.json``); runs ``python -m
   hifigan_tpu_torch.cli.warm_cache`` on it, then ``python -m
   hifigan_tpu_torch.distill.main`` on a copy of ``configs/distill.json``
   with ``accumulated_grad_batches`` 1 (printed) for 20 steps and again to
   22 (the second run resumes at step 20), checking the experiment
   directory's files; restores ``checkpoints/latest`` into ``DistillModels``
   on the card; runs ``distill.main.train()`` in process for 3 steps with
   the counts set to 0 just before and read just after, each step's
   stream-graph launches against ``distill_launches_per_step`` and its
   losses finite, printing ms per step through ``train()`` (data engine and
   callbacks included) beside phase 9's bare step and the data engine's
   host time a batch; runs ``python -m hifigan_tpu_torch.cli.train_sniffers``
   for 4 steps and checks its checkpoints;
18. prints one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

Every phase prints its wall time.

Any failed check raises: the script then exits non-zero and prints no ok
line. Without a CUDA device, or without the package beside it, it exits 2.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
FRAMES = 256
SEED = 1234
FP32_TOL = 1e-4
# bf16 keeps 8 significant bits, so one rounding step is 2^-8 of a value's
# magnitude. Kernel and plain version both accumulate in fp32 but in another
# order, so a conv output lying near a rounding boundary can round to the
# neighbouring bf16 value in one and not the other; the chain of 18 convs
# carries such one-ulp flips forward. Allowed: 2^-4 (16 steps at the top of
# the range) of the plain version's peak magnitude. The cuDNN bf16 chain's
# distance from the plain version is printed beside it for scale.
BF16_REL_TOL = 2.0 ** -4
# The served bf16 waveform against the fp32 Generator: every layer rounds to
# bf16 and the 72 convs of the four stages carry the flips forward, as in
# phase 2, so the same allowance: 2^-4 of the fp32 waveform's peak.
SERVE_REL_TOL = 2.0 ** -4
BATCHES = (1, 4, 16)
PRE_BATCHES = (1, 4, 16)
SERVE_REPS = {1: 21, 16: 9}  # timed requests of each serving path, in turn
STREAM_CHUNK = 32  # mel frames a streaming step
STREAM_FRAMES = 320  # the streamed mel
H100_BF16_FLOPS, H100_FP32_FLOPS, H100_BYTES_PER_S = 989e12, 67e12, 3.35e12
# fp32 operations on the tensor cores as 3xTF32 (three TF32 products a
# multiply-add, the fp32-class precision the kernels keep): the rate that
# bounds the fp32 conv kernels (B1's fp32 body, B2, B5). H100_FP32_FLOPS,
# the CUDA cores' rate, still bounds B3 and B4, which use no tensor cores.
H100_TF32_FLOPS = 495e12
FP32_MMA_FLOPS = H100_TF32_FLOPS / 3
STACK_BATCHES = (2, 16)
SEGMENT = 8192
TRAIN_STEPS = 5
# Step 1's five metrics, fused conv stack against per-layer cuDNN convs from
# the same state and batch (TF32 off): the forward differs by float order
# (~1e-6 relative), and the D update's AdamW step moves each weight by about
# lr * sign(g), so a gradient that is float noise around zero may step the
# other way in one of them; that moves the G losses by far less than 1e-3.
TRAIN_REL_TOL = 1e-3
DISTILL_STEPS = 5
# Step 1's loss tree, fused members against the interpreter from the same
# state and batch (fp32, TF32 off): the forwards differ by float order only.
DISTILL_REL_TOL = 1e-3
# Step 1's gradients and updated parameters against the same reference step.
# The step's losses have kinks (leaky-ReLU masks, L1 signs, the log clip),
# so float-order noise moves a few gradient elements by far more than its
# own size: the reference step with every conv output jittered by JITTER
# (relative; the per-layer conv kernel's outputs differ from cuDNN's by
# about as much) is printed beside as the floor. Allowed: each leaf's
# gradient within 5e-2 of its norm; each group's parameter difference
# within 0.2 of its update's norm, i.e. AdamW's ~lr * sign(g) first step
# taken the other way on about 1% of the elements.
STEP_GRAD_TOL = 5e-2
STEP_UPDATE_TOL = 0.2
JITTER = 1e-7
HOLD_BATCH = 2  # the V1 step-1 hold's batch: a CPU step within the run's time
SG_ELEMENTS = 12  # elements per member in phase 8: the generated-audio traversals' batch
# bench.py's label set for the distillation step (copied: bench.py imports JAX)
DISTILL_LABELS = {
    "content": {"speaker": list(range(40)), "sex": list(range(3)),
                "phones": list(range(72)), "sad": list(range(2))},
    "style": {"mic-brand": list(range(5)), "noise": list(range(5)),
              "rir": list(range(3)), "lowpass": list(range(2)),
              "highpass": list(range(2)), "reverb": list(range(2)),
              "hilbert": list(range(2)), "codec": list(range(5))},
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_mrf(xc: torch.Tensor, convs: list, n_rb: int, pair: int, post=None) -> torch.Tensor:
    """The MRF stage conv by conv in cuDNN, (B, C, T) layout: a yardstick only."""
    acc = None
    per = len(convs) // n_rb
    for rb in range(n_rb):
        h = xc
        for p0 in range(0, per, pair):
            t = h
            for w, b, d in convs[rb * per + p0: rb * per + p0 + pair]:
                t = F.conv1d(F.leaky_relu(t, 0.1), w, b, padding=(w.shape[2] - 1) * d // 2,
                             dilation=d)
            h = h + t
        acc = h if acc is None else acc + h
    out = acc / n_rb
    if post is None:
        return out
    return torch.tanh(F.conv1d(F.leaky_relu(out, 0.01), post[0], post[1], padding=3))


def library_weights(packed: dict, post_pack: dict | None) -> tuple[list, tuple | None]:
    """A packed stage's convs as (weight (O, I, K), bias, dilation) and its
    post conv as (weight, bias), for :func:`library_mrf`."""
    c = packed["channels"]
    convs = []
    for ci, (k, d, off) in enumerate(packed["convs"]):
        w = packed["w"][off:off + k * c * c].view(k, c, c).permute(2, 1, 0).contiguous()
        convs.append((w, packed["bias"][ci], d))
    post = (None if post_pack is None
            else (post_pack["w"].t()[None].contiguous(), post_pack["bias"]))
    return convs, post


def stage_inputs_of(h, sd, mel: torch.Tensor, dev) -> tuple[list, list]:
    """Each MRF stage's input from a seeded generator's front (conv_pre, the
    upsamplers and the plain stages before it), and each stage's head (the
    input of its leaky ReLU and upsampler: conv_pre's or the previous
    stage's output), fp32, (B, T, C)."""
    from hifigan_tpu_torch.ops import conv as ops
    from hifigan_tpu_torch.ops import resblock_tail as tail

    inputs, heads = [], []
    with torch.no_grad():
        x = ops.conv1d(mel.transpose(1, 2), sd["conv_pre.weight"].to(dev).permute(2, 1, 0),
                       sd["conv_pre.bias"].to(dev), padding=3)
        for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
            heads.append(x.contiguous())
            x = ops.conv_transpose1d(ops.leaky_relu(x), sd[f"ups.{i}.weight"].to(dev).permute(2, 0, 1),
                                     sd[f"ups.{i}.bias"].to(dev), stride=u,
                                     padding=(k - u) // 2).contiguous()
            inputs.append(x)
            x = tail.fused_tail_stage_reference(x, tail.pack_generator_tail(h, sd, i, device=dev))
    return inputs, heads


def mrf_phase(h, sd, mel: torch.Tensor, dev, name: str, dtypes, batches) -> dict:
    """Phase 2: the MRF-stage kernel against its plain version at every stage
    of config ``h``, full width, the lengths of a 256-frame request: fp32
    within FP32_TOL (the 3xTF32 body), bf16 within BF16_REL_TOL of the plain
    version's peak (the tensor-core body). Prints each call's plan (body,
    schedule, grid, tile, channel chunk, shared memory), errors, times,
    TFLOP/s and bound; sums the stage times per request, dtype and batch."""
    from hifigan_tpu_torch.ops import resblock_tail as tail

    n_stages = len(h["upsample_rates"])
    inputs, _ = stage_inputs_of(h, sd, mel, dev)
    errs = {dtype: 0.0 for dtype in dtypes}
    per_dtype = {dtype: {b: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops": 0, "bytes": 0}
                         for b in batches} for dtype in dtypes}
    for dtype in dtypes:
        esize = torch.tensor([], dtype=dtype).element_size()
        for i in range(n_stages):
            post = i == n_stages - 1
            packed = tail.pack_generator_tail(h, sd, i, dtype=dtype, device=dev)
            post_pack = tail.prepare_post(sd, dtype=dtype, device=dev) if post else None
            lib_convs, lib_post = library_weights(packed, post_pack)
            for batch in batches:
                xs = inputs[i][:batch].to(dtype).contiguous()
                plan = tail.plan_tail_stage(packed, batch, xs.shape[1], dtype, post,
                                            tail._sm_count(dev.index or 0),
                                            functools.partial(tail._blocks_per_sm, dev.index or 0))
                with torch.no_grad():
                    got = tail.fused_tail_stage(xs, packed, post_pack=post_pack)
                    torch.cuda.synchronize()
                    ref = tail.fused_tail_stage_reference(xs, packed, post_pack)
                    xc = xs.transpose(1, 2).contiguous()
                    lib = library_mrf(xc, lib_convs, packed["n_rb"], packed["pair_size"], lib_post)
                tag = f"{name} stage {i} {dtype} B={batch}"
                check(got.shape == ref.shape and got.dtype == ref.dtype,
                      f"{tag}: {tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
                err = (got.float() - ref.float()).abs().max().item()
                lib_err = (lib.transpose(1, 2).float() - ref.float()).abs().max().item()
                peak = ref.float().abs().max().item()
                tol = FP32_TOL if dtype == torch.float32 else BF16_REL_TOL * peak
                reps = {1: 20, 4: 5}.get(batch, 2)
                with torch.no_grad():
                    k_ms = time_ms(lambda: tail.fused_tail_stage(xs, packed, post_pack=post_pack), reps)
                    p_ms = time_ms(lambda: tail.fused_tail_stage_reference(xs, packed, post_pack), reps)
                    l_ms = time_ms(lambda: library_mrf(xc, lib_convs, packed["n_rb"],
                                                       packed["pair_size"], lib_post), reps)
                ops_n, bytes_n = stage_cost(packed, batch, xs.shape[1], esize, post)
                peak_rate = H100_BF16_FLOPS if dtype == torch.bfloat16 else FP32_MMA_FLOPS
                bound = max(ops_n / peak_rate, bytes_n / H100_BYTES_PER_S) * 1e3
                print(f"{name} stage {i} C={packed['channels']} T={xs.shape[1]} B={batch} "
                      f"{str(dtype)[6:]}{' +post' if post else ''} [{plan['body']}, "
                      f"{plan['schedule']}, grid {plan['grid']}, tile {plan['tile']}x{plan['bn']}, "
                      f"chunk {plan['kc']}, smem {plan['smem']} B, {plan['items']} items]: "
                      f"max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}, peak {peak:.3f}, cudnn chain {lib_err:.3e}) "
                      f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms cudnn {l_ms:.4f} ms "
                      f"bound {bound:.4f} ms ({ops_n / k_ms / 1e9:.2f} TFLOP/s)")
                check(err <= tol, f"{tag}: error {err} > {tol}")
                errs[dtype] = max(errs[dtype], err)
                r = per_dtype[dtype][batch]
                r["ms"] += k_ms
                r["plain_ms"] += p_ms
                r["library_ms"] += l_ms
                r["ops"] += ops_n
                r["bytes"] += bytes_n
    for dtype, rows in per_dtype.items():
        rate = H100_BF16_FLOPS if dtype == torch.bfloat16 else FP32_MMA_FLOPS
        for r in rows.values():
            r["bound_ms"] = max(r["ops"] / rate, r["bytes"] / H100_BYTES_PER_S) * 1e3
    per_batch = per_dtype.get(torch.bfloat16)
    return {"errs": errs, "per_batch": per_batch, "per_batch_fp32": per_dtype.get(torch.float32),
            "request": per_batch[batches[0]] if per_batch else None}


def stage_cost(packed: dict, batch: int, seq: int, esize: int, post: bool,
               pre: dict | None = None) -> tuple[int, int]:
    """(operations, bytes) one stage call must do and move: x and the weights
    read once, the output written once; with a folded upsampler ``pre`` its
    taps' products (ceil(k / stride) input rows of C_in a stage row) and
    weights, x then being the (B, seq / stride, C_in) input."""
    c = packed["channels"]
    taps = sum(k for k, _, _ in packed["convs"])
    ops = 2 * batch * seq * taps * c * c + (2 * batch * seq * 7 * c if post else 0)
    wbytes = (packed["w"].numel() + packed["bias"].numel() + (7 * c + 1 if post else 0)) * esize
    out_bytes = batch * seq * 4 if post else batch * seq * c * esize
    x_bytes = batch * seq * c * esize
    if pre is not None:
        ops += 2 * batch * seq * pre["taps"] * pre["c_in"] * c
        wbytes += (pre["taps"] * pre["stride"] * pre["c_in"] * c + c) * esize
        x_bytes = batch * (seq // pre["stride"]) * pre["c_in"] * esize
    return ops, x_bytes + wbytes + out_bytes


def pre_phase(h, sd, mel: torch.Tensor, dev, name: str, dtypes, batches) -> dict:
    """Phase 2, folded upsampler: the MRF-stage kernel with ``pre_pack``
    against its plain version at every stage ``make_fast_vocoder(fold_up=
    True)`` folds, full width, the previous stage's output of a 256-frame
    request as input (and a ragged T_in at B=3): fp32 (the 3xTF32 body)
    within FP32_TOL, bf16 within BF16_REL_TOL of the plain version's peak.
    Prints the kernel's time with and without the upsampling phase (the
    latter on the upsampled input), the plain version's, the cuDNN chain's
    (leaky ReLU, conv_transpose1d, the MRF conv by conv) and the bound with
    the upsampler's work added."""
    from hifigan_tpu_torch.models.fast_infer import folds_upsampler
    from hifigan_tpu_torch.ops import resblock_tail as tail

    n_stages = len(h["upsample_rates"])
    _, heads = stage_inputs_of(h, sd, mel, dev)
    errs = {dtype: 0.0 for dtype in dtypes}
    per_dtype = {dtype: {b: {"ms": 0.0, "ms_without_pre": 0.0, "plain_ms": 0.0,
                             "library_ms": 0.0, "ops": 0, "bytes": 0} for b in batches}
                 for dtype in dtypes}
    for dtype in dtypes:
        esize = torch.tensor([], dtype=dtype).element_size()
        for i in (i for i in range(n_stages) if folds_upsampler(h, i)):
            u, k = h["upsample_rates"][i], h["upsample_kernel_sizes"][i]
            post = i == n_stages - 1
            packed = tail.pack_generator_tail(h, sd, i, dtype=dtype, device=dev)
            pre = tail.prepare_upsample(sd, i, u, (k - u) // 2, dtype=dtype, device=dev)
            post_pack = tail.prepare_post(sd, dtype=dtype, device=dev) if post else None
            c = packed["channels"]
            lib_convs, lib_post = library_weights(packed, post_pack)

            def lib_chain(xc):
                xu = F.conv_transpose1d(F.leaky_relu(xc, 0.1), pre["weight"], pre["bias"],
                                        stride=u, padding=(k - u) // 2)
                return library_mrf(xu, lib_convs, packed["n_rb"], packed["pair_size"], lib_post)

            cases = [(b, heads[i].shape[1]) for b in batches] + [(3, heads[i].shape[1] - 37)]
            for batch, t_in in cases:
                xs = heads[i][:batch, :t_in].to(dtype).contiguous()
                t = t_in * u
                plan = tail.plan_tail_stage(packed, batch, t, dtype, post,
                                            tail._sm_count(dev.index or 0),
                                            functools.partial(tail._blocks_per_sm, dev.index or 0),
                                            pre=pre)
                with torch.no_grad():
                    got = tail.fused_tail_stage(xs, packed, post_pack=post_pack, pre_pack=pre)
                    torch.cuda.synchronize()
                    ref = tail.fused_tail_stage_reference(xs, packed, post_pack, pre)
                    xc = xs.transpose(1, 2).contiguous()
                    lib = lib_chain(xc)
                    xu = tail.upsample_reference(xs, pre).transpose(1, 2).contiguous()
                tag = f"{name} stage {i} {dtype} B={batch} T_in={t_in} pre_pack"
                check(got.shape == ref.shape == (batch, t, 1 if post else c)
                      and got.dtype == ref.dtype, f"{tag}: {tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
                err = (got.float() - ref.float()).abs().max().item()
                lib_err = (lib.transpose(1, 2).float() - ref.float()).abs().max().item()
                peak = ref.float().abs().max().item()
                tol = FP32_TOL if dtype == torch.float32 else BF16_REL_TOL * peak
                check(err <= tol, f"{tag}: error {err} > {tol}")
                errs[dtype] = max(errs[dtype], err)
                if batch not in batches:  # the ragged case: held, not timed
                    print(f"{tag} C={c} from {pre['c_in']} [{plan['body']}, grid {plan['grid']}]: "
                          f"max_abs_err {err:.3e} (tol {tol:.3e}, peak {peak:.3f})")
                    continue
                reps = 20 if batch == 1 else 5
                with torch.no_grad():
                    k_ms = time_ms(lambda: tail.fused_tail_stage(xs, packed, post_pack=post_pack,
                                                                 pre_pack=pre), reps)
                    k0_ms = time_ms(lambda: tail.fused_tail_stage(xu, packed, post_pack=post_pack),
                                    reps)
                    p_ms = time_ms(lambda: tail.fused_tail_stage_reference(xs, packed, post_pack,
                                                                           pre), reps)
                    l_ms = time_ms(lambda: lib_chain(xc), reps)
                ops_n, bytes_n = stage_cost(packed, batch, t, esize, post, pre)
                peak_rate = H100_BF16_FLOPS if dtype == torch.bfloat16 else FP32_MMA_FLOPS
                bound = max(ops_n / peak_rate, bytes_n / H100_BYTES_PER_S) * 1e3
                print(f"{tag} C={c} from {pre['c_in']} [{plan['body']}, {plan['schedule']}, grid "
                      f"{plan['grid']}, smem {plan['smem']} B, {plan['items']} items]: "
                      f"max_abs_err {err:.3e} (tol "
                      f"{tol:.3e}, peak {peak:.3f}, cudnn chain {lib_err:.3e}) kernel "
                      f"{k_ms:.4f} ms (without the upsampling phase {k0_ms:.4f} ms) plain "
                      f"{p_ms:.4f} ms cudnn {l_ms:.4f} ms bound {bound:.4f} ms "
                      f"({ops_n / k_ms / 1e9:.2f} TFLOP/s)")
                r = per_dtype[dtype][batch]
                for key, v in (("ms", k_ms), ("ms_without_pre", k0_ms), ("plain_ms", p_ms),
                               ("library_ms", l_ms), ("ops", ops_n), ("bytes", bytes_n)):
                    r[key] += v
    for dtype, rows in per_dtype.items():
        rate = H100_BF16_FLOPS if dtype == torch.bfloat16 else FP32_MMA_FLOPS
        for r in rows.values():
            r["bound_ms"] = max(r["ops"] / rate, r["bytes"] / H100_BYTES_PER_S) * 1e3
    return {"errs": errs, "per_batch": per_dtype.get(torch.bfloat16),
            "per_batch_fp32": per_dtype.get(torch.float32)}


def stream_phase(h, sd, fast, plain, dev, mel_gen) -> dict:
    """Phase 3b: both streamers at STREAM_CHUNK-frame chunks over a seeded
    STREAM_FRAMES-frame mel, B=1 and B=4. The stateful streamer
    (``make_streaming_vocoder``, bf16, every stage's MRF through the kernel,
    launches counted per chunk), from sample ``delay_samples`` on within
    SERVE_REL_TOL of the peak of whole-utterance ``make_fast_vocoder``
    synthesis; the halo streamer (``streaming_vocode`` over
    ``make_fast_vocoder``) against the same, everywhere; then one fp32
    stateful pass (the 3xTF32 body) within FP32_TOL of the fp32 Generator
    after the delay. Prints delay_samples, ms per chunk (host clock, a
    synchronize a chunk, median) and the real-time factor."""
    from hifigan_tpu_torch.models.streaming import make_streaming_vocoder
    from hifigan_tpu_torch.ops import resblock_tail as tail
    from hifigan_tpu_torch.parallel.halo import generator_halo_frames, streaming_vocode

    hop = int(np.prod(h["upsample_rates"]))
    n_stages = len(h["upsample_rates"])
    chunk_s = STREAM_CHUNK * hop / h["sampling_rate"]
    mels = {b: (torch.randn((b, h["num_mels"], STREAM_FRAMES), generator=mel_gen) * 2 - 5).to(dev)
            for b in (1, 4)}
    with torch.no_grad():
        full = {b: fast(m) for b, m in mels.items()}  # whole-utterance references
    torch.cuda.synchronize()
    init_state, step, delay = make_streaming_vocoder(h, sd)
    halo = generator_halo_frames(h)
    out = {"delay_samples": delay, "ms_per_chunk": {}, "halo_ms_per_chunk": {}}

    def run_stateful(step_fn, state, mel):
        outs, chunk_ms, per_chunk = [], [], []
        for s0 in range(0, mel.shape[-1], STREAM_CHUNK):
            before = tail.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, wav = step_fn(state, mel[:, :, s0:s0 + STREAM_CHUNK])
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            per_chunk.append(tail.LAUNCHES - before)
            outs.append(wav)
        return torch.cat(outs, dim=-1), chunk_ms, per_chunk

    tail.LAUNCHES = 0  # the stateful streamer's path
    results = {b: run_stateful(step, init_state(b), m) for b, m in mels.items()}
    out["launches"] = tail.LAUNCHES
    tail.LAUNCHES = 0  # the halo streamer's path
    halo_runs = {}
    for b, m in mels.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = streaming_vocode(lambda p, x: fast(x), None, m, STREAM_CHUNK, halo, hop)
        halo_runs[b] = (wav, (time.perf_counter() - t0) * 1e3 / (STREAM_FRAMES // STREAM_CHUNK))
    out["halo_launches"] = tail.LAUNCHES
    for b, (stream, chunk_ms, per_chunk) in results.items():
        ref = full[b]
        total = ref.shape[-1]
        tag = f"stateful stream B={b}"
        check(tuple(stream.shape) == tuple(ref.shape) and bool(torch.isfinite(stream).all()),
              f"{tag}: {tuple(stream.shape)} or non-finite")
        check(all(n == n_stages for n in per_chunk),
              f"{tag}: launches per chunk {per_chunk}, expected {n_stages}")
        want = ref[:, :, delay:total - delay]
        err = (stream[:, :, 2 * delay:] - want).abs().max().item()
        peak = want.abs().max().item()
        ms = float(np.median(chunk_ms))
        out["ms_per_chunk"][b] = ms
        print(f"{tag}, {STREAM_CHUNK}-frame chunks, bf16: delay_samples {delay}; "
              f"{ms:.3f} ms per chunk (median of {len(chunk_ms)}, first {chunk_ms[0]:.3f}), "
              f"{b * chunk_s / (ms / 1e3):.1f}x real time; launches per chunk {per_chunk[0]}; "
              f"from the delay on vs whole-utterance make_fast_vocoder max_abs_err {err:.3e} "
              f"(tol {SERVE_REL_TOL * peak:.3e}, peak {peak:.4f})")
        check(err <= SERVE_REL_TOL * peak, f"{tag}: {err} > {SERVE_REL_TOL} * {peak}")
        wav, ms = halo_runs[b]
        err = float(np.abs(wav - ref.float().cpu().numpy()).max())
        peak = ref.abs().max().item()
        out["halo_ms_per_chunk"][b] = ms
        print(f"halo stream B={b} (streaming_vocode over make_fast_vocoder, halo {halo} frames, "
              f"windows of {STREAM_CHUNK + 2 * halo}): {ms:.3f} ms per chunk (mean of "
              f"{STREAM_FRAMES // STREAM_CHUNK}), {b * chunk_s / (ms / 1e3):.1f}x real time; vs "
              f"whole-utterance max_abs_err {err:.3e} (tol {SERVE_REL_TOL * peak:.3e})")
        check(wav.shape == tuple(ref.shape) and err <= SERVE_REL_TOL * peak,
              f"halo stream B={b}: {wav.shape} error {err} > {SERVE_REL_TOL} * {peak}")
    # fp32: the 3xTF32 body on chunks, against the fp32 Generator
    init32, step32, delay32 = make_streaming_vocoder(h, sd, dtype=torch.float32)
    mel = mels[1][:, :, :4 * STREAM_CHUNK]
    tail.LAUNCHES = 0
    stream, chunk_ms, per_chunk = run_stateful(step32, init32(1), mel)
    out["fp32_launches"] = tail.LAUNCHES
    with torch.no_grad():
        ref = plain(mel)
    total = ref.shape[-1]
    err = (stream[:, :, 2 * delay32:] - ref[:, :, delay32:total - delay32]).abs().max().item()
    out["fp32_err"] = err
    out["fp32_ms_per_chunk"] = float(np.median(chunk_ms[1:]))
    print(f"stateful stream fp32 B=1 ({mel.shape[-1]} frames): delay_samples {delay32}, "
          f"{out['fp32_ms_per_chunk']:.3f} ms per chunk (median after the first, "
          f"{chunk_ms[0]:.3f}), {chunk_s / (out['fp32_ms_per_chunk'] / 1e3):.1f}x real time, "
          f"launches per chunk {per_chunk}; from "
          f"the delay on vs the fp32 Generator max_abs_err {err:.3e} (tol {FP32_TOL})")
    check(delay32 == delay and all(n == n_stages for n in per_chunk) and err <= FP32_TOL,
          f"fp32 stateful stream: delay {delay32}, launches {per_chunk}, error {err}")
    return out


def serve_fp32_phase(h, sd, mels: dict, refs: dict, dev) -> dict:
    """Phase 3, fp32: the requests ``mels`` through ``make_fast_vocoder(
    dtype=torch.float32)``, unfolded and with ``fold_up`` (the fp32 body on
    every stage), each path's launch count set to 0 just before and read
    just after its run (and after each request); each waveform within
    FP32_TOL of the fp32 ``Generator``'s peak (``refs``); ms per request
    (median of SERVE_REPS, the two paths in turn) and the real-time factor."""
    from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
    from hifigan_tpu_torch.ops import resblock_tail as tail

    n_stages = len(h["upsample_rates"])
    hop = int(np.prod(h["upsample_rates"]))
    paths = {"": make_fast_vocoder(h, sd, dtype=torch.float32),
             " fold_up": make_fast_vocoder(h, sd, dtype=torch.float32, fold_up=True)}
    out = {"launches": {}, "per_request": {}, "ms": {}, "err": 0.0}
    wavs = {}
    for tag, fn in paths.items():
        tail.LAUNCHES = 0
        per = {}
        for b, m in mels.items():
            before = tail.LAUNCHES
            wavs[tag, b] = fn(m)
            per[str(b)] = tail.LAUNCHES - before
        torch.cuda.synchronize()
        out["launches"][tag] = tail.LAUNCHES
        out["per_request"][tag] = per
        check(all(n == n_stages for n in per.values()),
              f"fp32 serve{tag}: launches per request {per}, expected {n_stages} each")
    for b, m in mels.items():
        req_ms = {tag: [] for tag in paths}
        for _ in range(SERVE_REPS[b]):
            for tag, fn in paths.items():
                t0 = time.perf_counter()
                fn(m)
                torch.cuda.synchronize()
                req_ms[tag].append((time.perf_counter() - t0) * 1e3)
        peak = refs[b].abs().max().item()
        for tag in paths:
            wav = wavs[tag, b]
            check(tuple(wav.shape) == tuple(refs[b].shape) and bool(torch.isfinite(wav).all()),
                  f"fp32 serve{tag} B={b}: {tuple(wav.shape)} or non-finite")
            err = (wav - refs[b]).abs().max().item()
            ms = float(np.median(req_ms[tag]))
            out["ms"].setdefault(tag, {})[b] = ms
            out["err"] = max(out["err"], err)
            rtf = b * FRAMES * hop / h["sampling_rate"] / (ms / 1e3)
            print(f"serve fp32{tag} B={b}: {ms:.3f} ms/request (median of {len(req_ms[tag])}), "
                  f"{rtf:.1f}x real time, launches per request {out['per_request'][tag][str(b)]}; "
                  f"vs fp32 Generator max_abs_err {err:.3e} (tol {FP32_TOL * peak:.3e}, "
                  f"peak {peak:.4f})")
            check(err <= FP32_TOL * peak, f"fp32 serve{tag} B={b}: {err} > {FP32_TOL} * {peak}")
    return out


def synthetic_audio(batch: int, length: int, sr: int, seed: int) -> np.ndarray:
    """Seeded sine mixtures plus noise, peak 0.95: (batch, length) float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / sr
    out = np.zeros((batch, length))
    for b in range(batch):
        for _ in range(4):
            out[b] += rng.uniform(0.1, 0.5) * np.sin(2 * np.pi * rng.uniform(80, 4000) * t
                                                      + rng.uniform(0, 2 * np.pi))
        out[b] += 0.02 * rng.standard_normal(length)
    return (0.95 * out / np.abs(out).max(axis=1, keepdims=True)).astype(np.float32)


def stack_of(d, dtype):
    """One MSD scale's layers 1-6 + conv_post as (specs, kernels, fp32 biases)."""
    from hifigan_tpu_torch.ops import conv_stack as cs

    specs = [cs.LayerSpec(ch, k, s, g, p, p, 0.1) for ch, k, s, g, p in d.specs[1:]]
    specs.append(cs.LayerSpec(1, 3, 1, 1, 1, 1, 1.0))
    layers = [c.kernel_nwc(False, dtype) for c in [*d.convs[1:], d.conv_post]]
    return (specs, [k.detach().contiguous() for k, _ in layers],
            [b.detach().float().contiguous() for _, b in layers])


def stack_cost(specs, x: torch.Tensor) -> tuple[int, int, int, int]:
    """(FLOP of one pass, fwd bytes, dx bytes, dW bytes) over input x: each
    pass's inputs read once and outputs written once; dx and dW do the
    forward's multiply-adds again."""
    from hifigan_tpu_torch.ops.conv_stack import out_len

    n, t, c = x.shape
    esize = x.element_size()
    flop, act, wts = 0, 0, 0
    for sp in specs:
        t_out = out_len(t, sp)
        flop += 2 * n * t_out * sp.c_out * sp.kernel * (c // sp.groups)
        act += n * t_out * sp.c_out * esize
        wts += sp.kernel * (c // sp.groups) * sp.c_out * esize + sp.c_out * 4
        t, c = t_out, sp.c_out
    x_bytes = x.numel() * esize
    # fwd: x, W, b -> ys; dx: dys, ys, W -> dx; dW: x, ys, dys -> dW, db
    return flop, x_bytes + wts + act, 2 * act + wts + x_bytes, x_bytes + 2 * act + wts


def plan_text(shape, dtype, passes) -> str:
    """How the conv core runs each pass of one conv: SIMT lanes, or the
    tensor-core tile, dW's channel group and splits, shared memory."""
    from hifigan_tpu_torch.ops.conv_stack import plan_conv

    parts = []
    for p in passes:
        pl = plan_conv(shape, dtype, p)
        if pl["body"] == "simt":
            parts.append(f"{p} simt x{pl['lanes']}")
        else:
            extra = f" kc {pl['kc']} splits {pl['splits']}" if p == "dw" else ""
            parts.append(f"{p} mma {pl['bm']}x{pl['bn']}{extra} {pl['smem']} B")
    return ", ".join(parts)


def stack_shapes(specs, x: torch.Tensor) -> list:
    """The conv core's view of each layer of a stack over input x."""
    from hifigan_tpu_torch.ops.conv_stack import ConvShape, out_len

    n, t, c = x.shape
    shapes = []
    for sp in specs:
        t_out = out_len(t, sp)
        shapes.append(ConvShape(n, t, c, t_out, sp.c_out, sp.kernel, sp.stride, 1, sp.groups,
                                sp.pad_l))
        t, c = t_out, sp.c_out
    return shapes


def cudnn_chain(xc: torch.Tensor, specs, ws, bs):
    """The stack conv by conv in cuDNN, (N, C, T) layout: a yardstick only."""
    h, outs = xc, []
    for sp, w, b in zip(specs, ws, bs):
        if sp.pad_l != sp.pad_r:  # a zone layer's rows: padded on the right to its last row
            h = F.conv1d(F.pad(h, (sp.pad_l, sp.pad_r)), w, b, stride=sp.stride, groups=sp.groups)
        else:
            h = F.conv1d(h, w, b, stride=sp.stride, padding=sp.pad_l, groups=sp.groups)
        if sp.slope != 1.0:
            h = F.leaky_relu(h, sp.slope)
        outs.append(h)
    return outs


def hold_stack(cs, x0, ks, bs, specs, tag: str, tol_rel: float, gen, errs: dict,
               library: bool = True):
    """One stack's kernels against their plain versions over input x0: every
    layer's output, and dx, dW, db for a loss on every feature map, on the
    logits only, and with ``weight_grads=False`` (each backward pair over
    the kernel's own saved outputs; two backward runs give the same bits).
    A layer with a lane mask must store exact zeros at its masked lanes.
    Returns the cotangents drawn (for the timing)."""
    dtype = x0.dtype
    dev = x0.device

    def held(what, got, want, kind):
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{tag} {what}: {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{tag} {what}: non-finite")
        check(err <= tol_rel * peak, f"{tag} {what}: error {err} > {tol_rel} * {peak}")
        errs[dtype][kind] = max(errs[dtype][kind], err)
        return err, peak

    x = x0.clone().requires_grad_()
    kk = [k.clone().requires_grad_() for k in ks]
    bk = [b.clone().requires_grad_() for b in bs]
    ys = cs.fused_conv_stack(x, kk, bk, specs)
    torch.cuda.synchronize()
    with torch.no_grad():
        plain = cs.fused_conv_stack_reference(x0, ks, bs, specs)
    fwd_err = max(held(f"y{l}", yk, yp, "fwd")[0] for l, (yk, yp) in enumerate(zip(ys, plain)))
    for l, (yk, sp) in enumerate(zip(ys, specs)):
        mask = cs.lane_mask(sp, yk.shape[1], dev)
        if mask is not None:
            check(bool((yk.detach()[:, mask == 0] == 0).all()),
                  f"{tag} y{l}: a masked fold-padding lane is not zero")
    lib_text = ""
    if library:
        with torch.no_grad():
            lib = cudnn_chain(x0.transpose(1, 2).contiguous(), specs,
                              [k.permute(2, 1, 0) for k in ks], [b.to(dtype) for b in bs])
        lib_err = max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                      for a, b in zip(lib, plain))
        lib_text = f" (cudnn chain {lib_err:.3e})"
    dys = [(torch.randn(yk.shape, device=dev, generator=gen) * 0.01).to(dtype) for yk in ys]
    saved = [yk.detach() for yk in ys]
    for case, live, wg in (("every fmap", range(len(ys)), True),
                           ("logits only", [len(ys) - 1], True),
                           ("weight_grads=False", range(len(ys)), False)):
        cot = [dys[l] if l in live else None for l in range(len(ys))]
        ys_c = ys if wg else cs.fused_conv_stack(x, kk, bk, specs, weight_grads=False)
        outs = [ys_c[l] for l in live]
        got = torch.autograd.grad(outs, [x, *kk, *bk], [cot[l] for l in live], retain_graph=True)
        torch.cuda.synchronize()
        if wg:  # a second backward gives the same bits: no float atomics
            again = torch.autograd.grad(outs, [x, *kk, *bk], [cot[l] for l in live],
                                        retain_graph=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{tag} {case}: two backward runs differ")
        dx, dks, dbs = cs.fused_conv_stack_backward_reference(x0, ks, saved, cot, specs,
                                                              weight_grads=wg)
        held(f"{case} dx", got[0], dx, "bwd_dx")
        if wg:
            for l, (gk, gb) in enumerate(zip(got[1:1 + len(ks)], got[1 + len(ks):])):
                if dks[l] is not None:
                    held(f"{case} dW{l}", gk, dks[l], "bwd_dw")
                    held(f"{case} db{l}", gb, dbs[l], "bwd_dw")
        else:
            check(all(not g.any() for g in got[1:]), f"{tag}: weight_grads=False gave dW != 0")
    print(f"{tag}: fwd max_abs_err {fwd_err:.3e}{lib_text}; dx/dW/db held for every fmap, "
          f"logits only, weight_grads=False; two backward runs bit-identical")
    return dys


def stack_phase(msd, dev) -> dict:
    """Phase 5: the conv-stack kernels against their plain versions."""
    from hifigan_tpu_torch.ops import conv_stack as cs
    from hifigan_tpu_torch.ops.conv import avg_pool1d, conv1d, leaky_relu

    wav = torch.from_numpy(synthetic_audio(max(STACK_BATCHES), SEGMENT, 22050, SEED + 2)).to(dev)
    errs = {torch.float32: {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0},
            torch.bfloat16: {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}}
    per_scale = []  # fp32 N=16 timings and costs, one dict per scale
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for dtype in (torch.float32, torch.bfloat16):
        tol_rel = FP32_TOL if dtype == torch.float32 else BF16_REL_TOL
        y = wav
        for scale, d in enumerate(msd.discriminators):
            if scale:
                y = avg_pool1d(y[..., None], 4, 2, padding=2)[..., 0]
            specs, ks, bs = stack_of(d, dtype)
            for n in STACK_BATCHES:
                with torch.no_grad():
                    k0, b0 = d.convs[0].kernel_nwc(dtype=dtype)
                    x0 = leaky_relu(conv1d(y[:n, :, None].to(dtype), k0, b0,
                                           padding=d.convs[0].padding)).contiguous()
                tag = f"conv stack scale {scale} T={x0.shape[1]} N={n} {str(dtype)[6:]}"
                for l, shape in enumerate(stack_shapes(specs, x0)):
                    print(f"{tag} layer {l + 1} plan: "
                          f"{plan_text(shape, dtype, ('fwd', 'dx', 'dw'))}")
                dys = hold_stack(cs, x0, ks, bs, specs, tag, tol_rel, gen, errs)
                if n == max(STACK_BATCHES):
                    per_scale.append(time_stack(cs, x0, ks, bs, specs, dys, dtype, scale))
                del dys
    return {"errs": errs, "per_scale": per_scale}


def zone_phase(msd, dev) -> dict:
    """Phase 5, the zone form: the V1 zone chain (layers 2-5, banded grouped
    layers on the time-folded layout) through the conv-stack kernels against
    their plain versions at the three scales (scales 1 and 2 end each layer
    on a partial row, whose fold-padding lanes the lane mask zeroes), layer
    1's output folded as input, N=2 and N=16, fp32 (TF32 off) within
    FP32_TOL and bf16 within BF16_REL_TOL; times at N=16 beside the same
    layers' std form and cuDNN's grouped chain. The chain's tables come from
    the model's own ``DiscriminatorS.zone_chain``."""
    from hifigan_tpu_torch.ops import conv_stack as cs
    from hifigan_tpu_torch.ops.conv import avg_pool1d, conv1d, leaky_relu

    wav = torch.from_numpy(synthetic_audio(max(STACK_BATCHES), SEGMENT, 22050, SEED + 2)).to(dev)
    errs = {torch.float32: {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0},
            torch.bfloat16: {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}}
    per_scale, geoms = [], set()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for dtype in (torch.float32, torch.bfloat16):
        tol_rel = FP32_TOL if dtype == torch.float32 else BF16_REL_TOL
        y = wav
        for scale, d in enumerate(msd.discriminators):
            if scale:
                y = avg_pool1d(y[..., None], 4, 2, padding=2)[..., 0]
            specs, ks, bs = stack_of(d, dtype)
            for n in STACK_BATCHES:
                with torch.no_grad():
                    k0, b0 = d.convs[0].kernel_nwc(dtype=dtype)
                    x0 = leaky_relu(conv1d(y[:n, :, None].to(dtype), k0, b0,
                                           padding=d.convs[0].padding)).contiguous()
                    (x1,) = cs.fused_conv_stack_reference(x0, ks[:1], bs[:1], specs[:1])
                    ((g, idx),) = [(g, idx) for g, idx in d.runs(True) if g]
                    zks, zbs, zspecs, f_entry, _, _ = d.zone_chain(
                        list(zip(ks, bs)), idx, x1.shape[1])
                    zks, zbs = ([v.contiguous() for v in vs] for vs in (zks, zbs))
                    xz = cs.fold_group_zones(x1, g, f_entry)
                sspecs, sks, sbs = ([v[i] for i in idx] for v in (specs, ks, bs))
                geoms.update(cs.layer_key("fwd", c, sp)[1:] for c, sp in
                             zip([xz.shape[2]] + [sp.c_out for sp in zspecs[:-1]], zspecs))
                partial = [f"{sp.lane_valid}/{sp.lane_period}" if sp.lane_period else "full"
                           for sp in zspecs]
                tag = (f"zone chain scale {scale} T={x1.shape[1]} rows={xz.shape[1]} N={n} "
                       f"{str(dtype)[6:]}")
                for l, shape in enumerate(stack_shapes(zspecs, xz)):
                    print(f"{tag} layer {l + 2} (kk {zspecs[l].kernel}, stride "
                          f"{zspecs[l].stride}, last row {partial[l]}) plan: "
                          f"{plan_text(shape, dtype, ('fwd', 'dx', 'dw'))}")
                dys = hold_stack(cs, xz, zks, zbs, zspecs, tag, tol_rel, gen, errs,
                                 library=False)
                if n == max(STACK_BATCHES):
                    row = time_stack(cs, xz, zks, zbs, zspecs, dys, dtype, scale, "zone chain")
                    x1c = x1.contiguous()
                    sdys = [(torch.randn((n, t_out, sp.c_out), device=dev, generator=gen)
                             * 0.01).to(dtype) for sp, t_out in
                            zip(sspecs, _out_lens(x1c.shape[1], sspecs))]
                    std = time_stack(cs, x1c, sks, sbs, sspecs, sdys, dtype, scale,
                                     "std form of the zone layers")
                    row["std"] = {k: std[k] for k in ("flop", "bytes", "ms", "plain_ms",
                                                      "library_ms", "bound_ms")}
                    row["banded_over_grouped"] = row["flop"] / std["flop"]
                    print(f"zone chain scale {scale} {str(dtype)[6:]}: banded MACs "
                          f"{row['banded_over_grouped']:.3f}x the grouped layers'; per layer "
                          + ", ".join(f"{a / b:.3f}x" for a, b in zip(
                              _layer_flops(zspecs, xz), _layer_flops(sspecs, x1c)))
                          + "; bound (the grouped layers' work) fwd/dx/dW+db "
                          + " / ".join(f"{std['bound_ms'][k]:.4f}" for k in std["bound_ms"])
                          + " ms, the banded tables' "
                          + " / ".join(f"{row['bound_ms'][k]:.4f}" for k in row["bound_ms"])
                          + " ms")
                    per_scale.append(row)
                del dys
    return {"errs": errs, "per_scale": per_scale, "geoms": geoms}


def _out_lens(t: int, specs) -> list:
    from hifigan_tpu_torch.ops.conv_stack import out_len

    lens = []
    for sp in specs:
        t = out_len(t, sp)
        lens.append(t)
    return lens


def _layer_flops(specs, x: torch.Tensor) -> list:
    n, t, c = x.shape
    out = []
    for sp, t_out in zip(specs, _out_lens(t, specs)):
        out.append(2 * n * t_out * sp.c_out * sp.kernel * (c // sp.groups))
        c = sp.c_out
    return out


def dw_work(cs, x0, ks, bs, specs, dys) -> list:
    """Each layer's weight-gradient work as the kernels' backward meets it:
    (input, output, map cotangent, fp32 upstream, kernel, spec), the
    upstream from the kernels' own dx over the kernels' forward."""
    with torch.no_grad():
        ys = cs.fused_conv_stack(x0, ks, bs, specs)
    work, up = [], None
    for l in range(len(specs) - 1, -1, -1):
        x_in = x0 if l == 0 else ys[l - 1]
        work.append((x_in, ys[l], dys[l], up, ks[l], specs[l]))
        _, _, dz = cs._layer_dw(*work[-1])
        up = cs._layer_dx(x_in, ys[l], dys[l], up, ks[l], specs[l], dz) if l else None
    return work


def cudnn_dw_work(work, dtype) -> list:
    """:func:`dw_work` in cuDNN's layout: (cotangent at the activation's
    output, output, input padded as :func:`cudnn_chain` pads it, weight, spec)."""
    out = []
    for x_in, y, dy, up, k, sp in work:
        g = dy.float() + up if up is not None else dy
        xc = x_in.transpose(1, 2).contiguous()
        if sp.pad_l != sp.pad_r:
            xc = F.pad(xc, (sp.pad_l, sp.pad_r))
        out.append((g.to(dtype).transpose(1, 2).contiguous(), y.transpose(1, 2).contiguous(), xc,
                    k.permute(2, 1, 0).contiguous(), sp))
    return out


def cudnn_dw(g, y, xc, w, sp) -> tuple:
    """One layer's dW and db in cuDNN from the cotangent at its activation."""
    dz = g if sp.slope == 1.0 else torch.ops.aten.leaky_relu_backward(g, y, sp.slope, True)
    pad = 0 if sp.pad_l != sp.pad_r else sp.pad_l
    _, dw, db = torch.ops.aten.convolution_backward(dz, xc, w, [w.shape[0]], [sp.stride], [pad],
                                                    [1], False, [0], sp.groups,
                                                    [False, True, True])
    return dw, db


def time_stack(cs, x0, ks, bs, specs, dys, dtype, scale, what: str = "conv stack") -> dict:
    """CUDA-event times of one pass of kernel, plain version and cuDNN chain
    (mean of 10 after a warm-up: 3 moved the kernel's time by up to 32%
    between two runs on one card). dx: a backward that needs the input's
    gradient alone; dW+db: each layer's weight-gradient work alone, on the
    inputs the backward hands it (:func:`dw_work`)."""
    reps = 10
    x = x0.clone().requires_grad_()
    with torch.no_grad():
        k_fwd = time_ms(lambda: cs.fused_conv_stack(x0, ks, bs, specs), reps)
        p_fwd = time_ms(lambda: cs.fused_conv_stack_reference(x0, ks, bs, specs), reps)
    ys_dx = cs.fused_conv_stack(x, ks, bs, specs)
    k_dx = time_ms(lambda: torch.autograd.grad(ys_dx, [x], dys, retain_graph=True), reps)
    saved = [y.detach() for y in ys_dx]
    p_dx = time_ms(lambda: cs.fused_conv_stack_backward_reference(
        x0, ks, saved, dys, specs, weight_grads=False), reps)
    work = dw_work(cs, x0, ks, bs, specs, dys)
    k_dw = time_ms(lambda: [cs._layer_dw(*w) for w in work], reps)
    p_dw = time_ms(lambda: [cs.reference_dw(x_in, cs.reference_dz(y, dy, up, sp), k, sp)
                            for x_in, y, dy, up, k, sp in work], reps)
    xc = x0.transpose(1, 2).contiguous().requires_grad_()
    ws = [k.permute(2, 1, 0).contiguous() for k in ks]
    lb = [b.to(dtype) for b in bs]
    dys_c = [d.transpose(1, 2).contiguous() for d in dys]
    with torch.no_grad():
        l_fwd = time_ms(lambda: cudnn_chain(xc, specs, ws, lb), reps)
    outs_dx = cudnn_chain(xc, specs, ws, lb)
    l_dx = time_ms(lambda: torch.autograd.grad(outs_dx, [xc], dys_c, retain_graph=True), reps)
    work_c = cudnn_dw_work(work, dtype)
    with torch.no_grad():
        l_dw = time_ms(lambda: [cudnn_dw(*w) for w in work_c], reps)
    del work, work_c
    flop, b_fwd, b_dx, b_dw = stack_cost(specs, x0)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else FP32_MMA_FLOPS
    row = {"scale": scale, "T": x0.shape[1], "flop": flop, "bytes": {"fwd": b_fwd, "bwd_dx": b_dx,
                                                                      "bwd_dw": b_dw},
           "ms": {"fwd": k_fwd, "bwd_dx": k_dx, "bwd_dw": k_dw},
           "plain_ms": {"fwd": p_fwd, "bwd_dx": p_dx, "bwd_dw": p_dw},
           "library_ms": {"fwd": l_fwd, "bwd_dx": l_dx, "bwd_dw": l_dw}}
    for kind in ("fwd", "bwd_dx", "bwd_dw"):
        bound = max(flop / peak, row["bytes"][kind] / H100_BYTES_PER_S) * 1e3
        row.setdefault("bound_ms", {})[kind] = bound
        print(f"{what} scale {scale} T={x0.shape[1]} N={x0.shape[0]} {str(dtype)[6:]} {kind}: "
              f"kernel {row['ms'][kind]:.3f} ms plain {row['plain_ms'][kind]:.3f} ms "
              f"cudnn {row['library_ms'][kind]:.3f} ms bound {row['bound_ms'][kind]:.4f} ms "
              f"({flop / 1e9:.1f} GFLOP, {row['bytes'][kind] / 1e6:.1f} MB; "
              f"{flop / max(row['ms'][kind], 1e-6) / 1e9:.2f} TFLOP/s)")
    row["dtype"] = str(dtype)[6:]
    return row


# Passes of each conv-stack entry point in one V1 train step, per MSD scale:
# the D update runs real and fake forward and backward with weight grads;
# the G update runs both forward again and only the fake one backward, for
# dx alone (the real one gets no gradient, the weights are frozen).
PASSES_PER_STEP = {"fwd": 4, "bwd_dx": 3, "bwd_dw": 2}


def msd_passes(layer: int) -> dict:
    """Passes of MSD conv ``layer`` through the two ``msd_conv1d_lrelu``
    kernels in one V1 train step with ``msd_conv_impl='pallas'``, counted
    from the step's structure: per scale the D update traverses real and
    fake, the G update both again (4 forward). dx: the D update's inputs
    (the waveform and the detached fake) need no gradient, so conv_0 skips
    its dx there; in the G update the weights are frozen, so the real
    traversal has no backward at all and the fake one runs every conv's dx
    (3 dx, 1 for conv_0)."""
    return {"fwd": 4, "bwd_dx": 3 if layer else 1}


def msd_launches_per_step(n_scales: int, n_convs: int = 8) -> dict:
    """Launches of the two kernels in one V1 train step (:func:`msd_passes`
    over the 8 convs of each scale: 96 forward and 66 dx at 3 scales)."""
    return {k: n_scales * sum(msd_passes(layer)[k] for layer in range(n_convs))
            for k in ("fwd", "bwd_dx")}


def pool_reading(dev) -> None:
    """The port's average pool against the CPU on the card, forward and input
    gradient, at the MSD's waveform pool and a DSL pool on a per-layer conv
    kernel's (contiguous) output; beside it F.avg_pool1d on the same
    channels-last view, which the port does not call."""
    from hifigan_tpu_torch.ops.conv import avg_pool1d

    gen = torch.Generator().manual_seed(SEED + 70)
    for n, t, c, k, s, p in ((16, 8192, 1, 4, 2, 2), (6, 14560, 12, 31, 1, 15)):
        x = torch.randn((n, t, c), generator=gen)
        xc, xd, xf = (x.clone().requires_grad_(), x.to(dev).requires_grad_(),
                      x.to(dev).transpose(1, 2).requires_grad_())
        want = avg_pool1d(xc, k, s, padding=p)
        dy = torch.randn(want.shape, generator=gen)
        (gw,) = torch.autograd.grad(want, xc, dy)
        got = avg_pool1d(xd, k, s, padding=p)
        (gg,) = torch.autograd.grad(got, xd, dy.to(dev))
        (gf,) = torch.autograd.grad(F.avg_pool1d(xf, k, s, p), xf, dy.to(dev).transpose(1, 2))
        err = max((got.cpu() - want).abs().max().item(), (gg.cpu() - gw).abs().max().item())
        f_err = (gf.transpose(1, 2).cpu() - gw).abs().max().item()
        print(f"avg pool ({n}, {t}, {c}) k{k} s{s} p{p}: the port's forward and input gradient "
              f"on the card vs the CPU max_abs_err {err:.3e}; F.avg_pool1d's input gradient on "
              f"the channels-last view {f_err:.3e} (gradient peak {gw.abs().max().item():.3e})")
        check(err <= 1e-6, f"avg pool ({n}, {t}, {c}): {err} on the card vs the CPU")


V1_GROUPS = ("generator", "mpd", "msd")


def v1_snapshot(state) -> dict:
    """Each V1 group's parameters and Adam first moments, cloned to the
    CPU. After step 1 a first moment is (1 - b1) x the group's gradient."""
    out = {}
    for g in V1_GROUPS:
        opt = state.opt_g if g == "generator" else state.opt_d
        ps = list(getattr(state, g).parameters())
        out[g] = ([p.detach().cpu().clone() for p in ps],
                  [opt.state[p]["exp_avg"].detach().cpu().clone() for p in ps])
    return out


class jittered_torch_convs:
    """Within the block every ``F.conv1d``, ``F.conv2d`` and
    ``F.conv_transpose1d`` output (the V1 models' convs) is multiplied by
    (1 + delta * N(0, 1)), seeded: float-order noise of relative size delta."""

    NAMES = ("conv1d", "conv2d", "conv_transpose1d")

    def __init__(self, delta: float, seed: int):
        self.delta, self.seed = delta, seed

    def __enter__(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.real = {n: getattr(F, n) for n in self.NAMES}

        def jittered(real):
            def conv(*args, **kwargs):
                y = real(*args, **kwargs)
                return y * (1 + self.delta * torch.randn(y.shape, generator=gen).to(y.device))
            return conv

        for n, real in self.real.items():
            setattr(F, n, jittered(real))
        return self

    def __exit__(self, *exc):
        for n, real in self.real.items():
            setattr(F, n, real)


def v1_step_reference(h, msd_impl: str = "xla", jitter: bool = True) -> dict:
    """The CPU side of phases 6 and 11's step-1 hold, computed once: one
    ``make_train_step`` step of V1 at HOLD_BATCH x segment_size on the CPU
    with ``msd_conv_impl=msd_impl`` (``'xla'``; phase 6c: the zoned form's
    plain version) from the seeded state, and with ``jitter`` the same step
    with every conv output jittered by JITTER (the floor: CPU rounding
    noise, which phase 6c reads from phase 6's). The config's other keys
    (``disc_fused``) hold as given."""
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.train.vocoder import create_train_state, make_train_step

    hx = AttrDict(h, msd_conv_impl=msd_impl, batch_size=HOLD_BATCH)
    batch = {"audio": synthetic_audio(HOLD_BATCH, h["segment_size"], h["sampling_rate"],
                                      SEED + 30)}
    step_fn = make_train_step(hx)
    t0 = time.perf_counter()
    state = create_train_state(hx, seed=SEED, device="cpu")
    start = {g: copy.deepcopy(getattr(state, g).state_dict()) for g in V1_GROUPS}
    names = {g: [f"{g}.{n}" for n, _ in getattr(state, g).named_parameters()] for g in V1_GROUPS}
    before = {g: [p.detach().clone() for p in getattr(state, g).parameters()] for g in V1_GROUPS}
    state, metrics = step_fn(state, batch)
    want = v1_snapshot(state)
    floor = None
    if jitter:
        state = create_train_state(hx, seed=SEED, device="cpu")
        for g in V1_GROUPS:
            getattr(state, g).load_state_dict(start[g])
        with jittered_torch_convs(JITTER, SEED + 31):
            state, _ = step_fn(state, batch)
        floor = v1_snapshot(state)
    metrics = {k: v.item() for k, v in metrics.items()}
    print(f"V1 step-1 reference on the CPU (B={HOLD_BATCH} x {h['segment_size']}, "
          f"msd_conv_impl={msd_impl!r}, disc_fused {bool(h.get('disc_fused', False))}, "
          f"{torch.get_num_threads()} threads){' and its jittered floor' if jitter else ''} in "
          f"{time.perf_counter() - t0:.3f} s; metrics {json.dumps(metrics)}")
    return {"start": start, "batch": batch, "names": names, "before": before, "want": want,
            "floor": floor, "lrs": {g: h["learning_rate"] for g in V1_GROUPS}}


def hold_step1(h, dev, ref: dict, step_fn, what: str, cpu_what: str,
               floor: dict | None = None) -> tuple[dict, dict]:
    """Step 1 at HOLD_BATCH from the seeded state on the card against the
    CPU step ``ref`` (:func:`v1_step_reference`): the gradients (Adam first
    moments) leaf by leaf within STEP_GRAD_TOL and the updated parameters
    group by group within STEP_UPDATE_TOL, printed beside the CPU step's own
    floor (``floor``, an earlier reading, where ``ref`` has none). Returns
    (the reading, the floor)."""
    from hifigan_tpu_torch.train.vocoder import create_train_state

    hold = create_train_state(h, seed=SEED, device=dev)
    for g in V1_GROUPS:
        getattr(hold, g).load_state_dict(ref["start"][g])
    hold, _ = step_fn(hold, ref["batch"])
    got = v1_snapshot(hold)
    del hold
    upd = held_update(ref["names"], ref["lrs"], ref["before"], got, ref["want"])
    whose = "phase 6's step"
    if ref["floor"] is not None:
        floor = held_update(ref["names"], ref["lrs"], ref["before"], ref["floor"], ref["want"])
        whose = "the CPU"
    del got
    print(update_line(f"V1 step 1 at B={HOLD_BATCH}, {what} on the card vs {cpu_what} on the "
                      "CPU", upd))
    print(update_line(f"V1 step 1 on the CPU with its conv outputs jittered by {JITTER:g} vs "
                      f"{whose} (the noise floor)", floor))
    n_leaves = sum(len(v) for v in ref["names"].values())
    check(upd["leaves"] == n_leaves, f"{upd['leaves']} leaves held of {n_leaves} parameters")
    check(upd["grad_rel"] <= STEP_GRAD_TOL,
          f"V1 step 1 gradients, {what} on the card vs the CPU: {upd['grad_leaf']} "
          f"{upd['grad_rel']} > {STEP_GRAD_TOL}")
    check(upd["update_rel"] <= STEP_UPDATE_TOL,
          f"V1 step 1 parameters, {what} on the card vs the CPU: {upd['update_group']} "
          f"{upd['update_rel']} > {STEP_UPDATE_TOL}")
    torch.cuda.empty_cache()
    return upd, floor


def train_phase(h, dev, ref: dict, msd_impl: str = "auto") -> dict:
    """Phases 6 and 11: V1 train steps at full size through
    ``make_train_step`` with ``msd_conv_impl`` ``'auto'`` (the conv-stack
    kernels) or ``'pallas'`` (the per-layer conv kernels), after step 1 at
    HOLD_BATCH held against the CPU step ``ref`` (:func:`v1_step_reference`)."""
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.ops import conv_stack as cs
    from hifigan_tpu_torch.ops import msd_conv
    from hifigan_tpu_torch.train.vocoder import create_train_state, make_train_step

    h = AttrDict(h, msd_conv_impl=msd_impl)
    n_scales = h.get("msd_num_scales", 3)
    if msd_impl == "pallas":
        ops, what = msd_conv, "per-layer conv"
        per_step = msd_launches_per_step(n_scales)
    else:
        ops, what = cs, "conv-stack"
        layers = 7  # MSD layers 1-6 + conv_post, one launch each per pass
        per_step = {k: v * n_scales * layers for k, v in PASSES_PER_STEP.items()}
    step_fn = make_train_step(h)
    upd, floor = hold_step1(h, dev, ref, step_fn, f"msd_conv_impl={msd_impl!r}",
                            "msd_conv_impl='xla'")
    batches = [{"audio": synthetic_audio(h["batch_size"], h["segment_size"], h["sampling_rate"],
                                         SEED + 10 + i)} for i in range(TRAIN_STEPS)]
    state = create_train_state(h, seed=SEED, device=dev)
    xla = create_train_state(AttrDict(h, msd_conv_impl="xla"), seed=SEED, device=dev)
    for name in ("generator", "mpd", "msd"):
        getattr(xla, name).load_state_dict(getattr(state, name).state_dict())
    _, ref_metrics = step_fn(xla, batches[0])
    ref_metrics = {k: v.item() for k, v in ref_metrics.items()}
    del xla
    torch.cuda.empty_cache()

    before = {name: [p.detach().clone() for p in getattr(state, name).parameters()]
              for name in ("generator", "mpd", "msd")}
    u0 = {k: v.clone() for k, v in state.spectral_msd.items() if v.numel() > 1}
    step_ms, launches_per_step, history = [], [], []
    ops.reset_launches()
    for i, batch in enumerate(batches):
        counts = ops.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches_per_step.append({k: v - counts[k] for k, v in ops.launches().items()})
        history.append({k: v.item() for k, v in metrics.items()})
    launches = ops.launches()
    for i, (m, n) in enumerate(zip(history, launches_per_step)):
        check(all(np.isfinite(v) for v in m.values()), f"step {i + 1}: non-finite metrics {m}")
        check(n == per_step, f"step {i + 1}: {what} launches {n}, derived {per_step}")
    for name, params in before.items():
        after = getattr(state, name).parameters()
        moved = sum(not torch.equal(a, b) for a, b in zip(params, after))
        check(moved == len(params), f"{name}: {len(params) - moved} parameters did not move")
    check(any(not torch.equal(u, state.spectral_msd[k]) for k, u in u0.items()),
          "scale 0's spectral u did not move")
    rel = {k: abs(history[0][k] - v) / abs(v) for k, v in ref_metrics.items()}
    print(f"train step 1, msd_conv_impl={msd_impl!r} ({what} kernels): "
          f"{json.dumps(history[0])}")
    print(f"train step 1, msd_conv_impl='xla': {json.dumps(ref_metrics)}")
    print(f"train step 1 relative difference: {json.dumps(rel)} (limit {TRAIN_REL_TOL})")
    check(max(rel.values()) <= TRAIN_REL_TOL, f"step 1 {msd_impl} vs xla: {rel}")
    ms = float(np.median(step_ms[2:]))
    print(f"train V1 msd_conv_impl={msd_impl!r} B={h['batch_size']}x{h['segment_size']} fp32 "
          f"(TF32 off): step ms {[round(t, 3) for t in step_ms]}, median of steps "
          f"3-{TRAIN_STEPS}: {ms:.3f} ms; {what} launches per step {per_step}; metrics step "
          f"{TRAIN_STEPS}: {json.dumps(history[-1])}")
    return {"step_ms": ms, "launches": launches, "per_step": per_step, "rel": rel,
            "update": upd, "update_floor": floor}


def train_bf16_phase(h, dev) -> dict:
    """Phase 6b: TRAIN_STEPS V1 train steps at full size in bench.py's
    training precision (``disc_compute_dtype`` and ``gen_compute_dtype``
    'bfloat16', bench.py:169-174; parameters, losses and optimizer fp32)
    through the conv-stack kernels, the counts set to 0 just before and
    read just after (and per step): finite metrics, every parameter group
    moves, the launches per step equal the derived count; prints ms per
    step."""
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.ops import conv_stack as cs
    from hifigan_tpu_torch.train.vocoder import create_train_state, make_train_step

    h = AttrDict(h, msd_conv_impl="auto", disc_compute_dtype="bfloat16",
                 gen_compute_dtype="bfloat16")
    per_step = {k: v * h.get("msd_num_scales", 3) * 7 for k, v in PASSES_PER_STEP.items()}
    step_fn = make_train_step(h)
    batches = [{"audio": synthetic_audio(h["batch_size"], h["segment_size"], h["sampling_rate"],
                                         SEED + 10 + i)} for i in range(TRAIN_STEPS)]
    state = create_train_state(h, seed=SEED, device=dev)
    before = {g: [p.detach().clone() for p in getattr(state, g).parameters()] for g in V1_GROUPS}
    step_ms, launches_per_step, history = [], [], []
    cs.reset_launches()
    for batch in batches:
        counts = cs.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches_per_step.append({k: v - counts[k] for k, v in cs.launches().items()})
        history.append({k: v.item() for k, v in metrics.items()})
    launches = cs.launches()
    for i, (m, n) in enumerate(zip(history, launches_per_step)):
        check(all(np.isfinite(v) for v in m.values()), f"bf16 step {i + 1}: non-finite {m}")
        check(n == per_step, f"bf16 step {i + 1}: conv-stack launches {n}, derived {per_step}")
    for g, params in before.items():
        moved = sum(not torch.equal(a, b) for a, b in zip(params, getattr(state, g).parameters()))
        check(moved == len(params), f"bf16 {g}: {len(params) - moved} parameters did not move")
    ms = float(np.median(step_ms[2:]))
    print(f"train V1 bf16 (disc_compute_dtype, gen_compute_dtype 'bfloat16') "
          f"B={h['batch_size']}x{h['segment_size']}: step ms {[round(t, 3) for t in step_ms]}, "
          f"median of steps 3-{TRAIN_STEPS}: {ms:.3f} ms; conv-stack launches per step "
          f"{per_step}; metrics step 1 {json.dumps(history[0])}, step {TRAIN_STEPS} "
          f"{json.dumps(history[-1])}")
    return {"step_ms": ms, "launches": launches, "per_step": per_step}


def b2_passes(fused: bool) -> dict:
    """Passes of each conv-stack layer in one V1 train step, per MSD scale.
    Unfused: PASSES_PER_STEP. With ``disc_fused`` the D update traverses the
    2B rows once, forward and backward with weight gradients (the stack's
    input needs dx for conv_0's weights), and the G update once more, its
    backward dx alone (the weights frozen; the real half's maps enter the
    feature loss through the same call): 2 forward, 2 dx, 1 dW."""
    return {"fwd": 2, "bwd_dx": 2, "bwd_dw": 1} if fused else dict(PASSES_PER_STEP)


def b2_launches_per_step(msd, zoned: bool, fused: bool, zone_only: bool = False) -> dict:
    """Launches of the conv-stack kernels in one V1 train step, from the
    step's structure: every layer of each scale's runs (``DiscriminatorS.
    runs``; with ``zone_only`` only the zone chains') times its passes."""
    layers = sum(len(idx) for d in msd.discriminators for g, idx in d.runs(zoned)
                 if g or not zone_only)
    return {k: v * layers for k, v in b2_passes(fused).items()}


def zone_launches(geoms: set) -> dict:
    """The conv-stack launches counted so far at the zone layers' geometries."""
    from hifigan_tpu_torch.ops import conv_stack as cs

    out = {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
    for (kind, *geom), n in cs.LAUNCHES_BY_LAYER.items():
        if tuple(geom) in geoms:
            out[kind] += n
    return out


def msd_feature_losses(h, state_a, state_b, batch: dict) -> tuple[float, float]:
    """The MSD's feature loss of two states with one set of weights on the
    first step's inputs (the generator's output for the batch): the divisor
    of a zone map counts its fold-padding lanes."""
    from hifigan_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
    from hifigan_tpu_torch.models.losses import feature_loss

    with torch.no_grad():
        y = torch.as_tensor(batch["audio"], device=state_a.device)
        y_hat = state_a.generator(log_mel_spectrogram(y, MelConfig.from_hparams(h)))[:, 0, :]
        out = []
        for st in (state_a, state_b):
            _, _, fr, fg = st.msd(y, y_hat)
            out.append(feature_loss(fr, fg).item())
    return out[0], out[1]


V1_FORMS = (("fused_zoned", {"msd_conv_impl": "fused_zoned"}, "fused_zoned"),
            ("disc_fused", {"disc_fused": True}, "xla"))


def v1_forms_phase(h, dev, geoms: set, floor: dict) -> dict:
    """Phase 6c: V1 train steps at full size under the two discriminator
    forms phase 6 does not take: ``msd_conv_impl='fused_zoned'`` (the zone
    chains through the conv-stack kernels) and ``disc_fused: true`` (real
    and fake as one 2B batch). For each: step 1 at HOLD_BATCH against the
    same config's step on the CPU (:func:`hold_step1`; the zoned form's CPU
    step takes the plain stack, the fused form's 'xla'; printed beside
    phase 6's noise floor ``floor``); then TRAIN_STEPS
    steps at B=16 x 8192 in turns with phase 6's 'fused_stack' step from the
    same weights, the counts set to 0 just before and read around each of
    the form's steps: finite metrics, every group and scale 0's spectral u
    moving, the conv-stack launches (and the zone layers' alone) against the
    derived count; prints ms per step of both and, for the zoned form, step
    1's MSD feature loss beside the std form's."""
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.ops import conv_stack as cs
    from hifigan_tpu_torch.train.vocoder import create_train_state, make_train_step

    out = {}
    h_std = AttrDict(h, msd_conv_impl="auto")
    std_fn = make_train_step(h_std)
    for form, over, cpu_impl in V1_FORMS:
        hf = AttrDict({**h, "msd_conv_impl": "auto", **over})
        ref = v1_step_reference(hf, msd_impl=cpu_impl, jitter=False)
        step_fn = make_train_step(hf)
        upd, _ = hold_step1(hf, dev, ref, step_fn, form, f"{form} (msd_conv_impl={cpu_impl!r})",
                            floor)
        del ref
        batches = [{"audio": synthetic_audio(h["batch_size"], h["segment_size"],
                                             h["sampling_rate"], SEED + 10 + i)}
                   for i in range(TRAIN_STEPS)]
        state = create_train_state(hf, seed=SEED, device=dev)
        std = create_train_state(h_std, seed=SEED, device=dev)
        zoned = hf["msd_conv_impl"] == "fused_zoned"
        fused = bool(hf.get("disc_fused", False))
        per_step = b2_launches_per_step(state.msd, zoned, fused)
        zone_per_step = b2_launches_per_step(state.msd, zoned, fused, zone_only=True)
        fl = msd_feature_losses(h, state, std, batches[0]) if zoned else None
        before = {g: [p.detach().clone() for p in getattr(state, g).parameters()]
                  for g in V1_GROUPS}
        u0 = {k: v.clone() for k, v in state.spectral_msd.items() if v.numel() > 1}
        step_ms, std_ms, history, launches_per_step, zone_per = [], [], [], [], []
        launches = {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
        zone_total = dict(launches)
        cs.reset_launches()
        for batch in batches:  # the form's step, then the std step, in turns
            counts, zcounts = cs.launches(), zone_launches(geoms)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n = {k: v - counts[k] for k, v in cs.launches().items()}
            zn = {k: v - zcounts[k] for k, v in zone_launches(geoms).items()}
            launches_per_step.append(n)
            zone_per.append(zn)
            for k in launches:
                launches[k] += n[k]
                zone_total[k] += zn[k]
            history.append({k: v.item() for k, v in metrics.items()})
            t0 = time.perf_counter()
            std, _ = std_fn(std, batch)
            torch.cuda.synchronize()
            std_ms.append((time.perf_counter() - t0) * 1e3)
        for i, (m, n, zn) in enumerate(zip(history, launches_per_step, zone_per)):
            check(all(np.isfinite(v) for v in m.values()), f"{form} step {i + 1}: non-finite {m}")
            check(n == per_step, f"{form} step {i + 1}: conv-stack launches {n}, derived "
                                 f"{per_step}")
            check(zn == zone_per_step, f"{form} step {i + 1}: zone-layer launches {zn}, derived "
                                       f"{zone_per_step}")
        for g, params in before.items():
            moved = sum(not torch.equal(a, b) for a, b in
                        zip(params, getattr(state, g).parameters()))
            check(moved == len(params), f"{form} {g}: {len(params) - moved} parameters did not "
                                        "move")
        check(any(not torch.equal(u, state.spectral_msd[k]) for k, u in u0.items()),
              f"{form}: scale 0's spectral u did not move")
        ms, ms_std = float(np.median(step_ms[2:])), float(np.median(std_ms[2:]))
        print(f"train V1 {form} B={h['batch_size']}x{h['segment_size']} fp32 (TF32 off): step ms "
              f"{[round(t, 3) for t in step_ms]}, median of steps 3-{TRAIN_STEPS}: {ms:.3f} ms; in "
              f"turns with 'fused_stack' {[round(t, 3) for t in std_ms]}, median {ms_std:.3f} ms "
              f"({ms / ms_std:.3f}x); conv-stack launches per step {per_step}, zone layers "
              f"{zone_per_step}; metrics step 1 {json.dumps(history[0])}, step {TRAIN_STEPS} "
              f"{json.dumps(history[-1])}")
        if fl is not None:
            print(f"train V1 {form} step 1's MSD feature loss {fl[0]:.6f} against 'fused_stack' "
                  f"{fl[1]:.6f} from the same weights and inputs ({fl[0] / fl[1]:.6f}x): the "
                  "zone maps' means count their zeroed fold-padding lanes (scales 1 and 2)")
            check(0.95 * fl[1] < fl[0] < fl[1], f"{form}: feature loss {fl[0]} against {fl[1]}")
        out[form] = {"step_ms": ms, "std_step_ms": ms_std, "launches": launches,
                     "per_step": per_step, "zone_launches": zone_total,
                     "zone_per_step": zone_per_step, "update": upd, "update_floor": floor,
                     "feature_loss": fl}
        del state, std
        torch.cuda.empty_cache()
    return out


def zone_entries(zone: dict, forms: dict) -> list:
    """The B2 zone form's rows of the kernels line: per V1 train step with
    ``msd_conv_impl='fused_zoned'`` (fp32, PASSES_PER_STEP passes of the
    chain at each scale), from phase 5's per-pass times at N=16."""
    rows = [r for r in zone["per_scale"] if r["dtype"] == "float32"]
    rows_bf = [r for r in zone["per_scale"] if r["dtype"] == "bfloat16"]
    run = forms["fused_zoned"]
    entries = []

    def bound(rs, kind, peak, form=None):
        """(ms, by) over the passes of one step: the grouped layers' work
        (the std form's MACs and bytes), or with form=None the banded tables'."""
        n = PASSES_PER_STEP[kind]
        rs = [r[form] if form else r for r in rs]
        ops = sum(n * r["flop"] for r in rs) / peak * 1e3
        nbytes = sum(n * r["bytes"][kind] for r in rs) / H100_BYTES_PER_S * 1e3
        return max(ops, nbytes), "operations" if ops >= nbytes else "bytes"

    for kind, line in (("fwd", 374), ("bwd_dx", 596), ("bwd_dw", 596)):
        n = PASSES_PER_STEP[kind]
        bound_ms, bound_by = bound(rows, kind, FP32_MMA_FLOPS, "std")
        entry = {
            "name": f"fused_conv_stack.zone.{kind}",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/conv_stack.cu",
            "replaces": f"hifigan_tpu/ops/pallas/conv_stack.py:{line}",
            "launches": run["zone_launches"][kind],
            "launches_per_step": run["zone_per_step"][kind],
            "max_abs_err": zone["errs"][torch.float32][kind],
            "max_abs_err_bf16": zone["errs"][torch.bfloat16][kind],
            "ms": sum(n * r["ms"][kind] for r in rows),
            "plain_ms": sum(n * r["plain_ms"][kind] for r in rows),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_banded_ms": bound(rows, kind, FP32_MMA_FLOPS)[0],
            # the same layers as grouped convs in cuDNN (the function, up to layout)
            "library_ms": sum(n * r["std"]["library_ms"][kind] for r in rows),
            "library_banded_ms": sum(n * r["library_ms"][kind] for r in rows),
            "std_form_ms": sum(n * r["std"]["ms"][kind] for r in rows),
            "banded_over_grouped": [r["banded_over_grouped"] for r in rows],
            "bf16": {**{key: sum(n * r[key][kind] for r in rows_bf)
                        for key in ("ms", "plain_ms")},
                     "bound_ms": bound(rows_bf, kind, H100_BF16_FLOPS, "std")[0],
                     "bound_banded_ms": bound(rows_bf, kind, H100_BF16_FLOPS)[0]},
            "bf16_std_form_ms": sum(n * r["std"]["ms"][kind] for r in rows_bf),
            "bf16_library_ms": sum(n * r["std"]["library_ms"][kind] for r in rows_bf),
            "step_ms_fused_zoned": run["step_ms"],
            "step_ms_fused_stack_in_turns": run["std_step_ms"],
            "step_ms_disc_fused": forms["disc_fused"]["step_ms"],
            "step_ms_fused_stack_in_turns_with_disc_fused": forms["disc_fused"]["std_step_ms"],
            "feature_loss_zoned_vs_std": run["feature_loss"],
            "per": (f"the zone chain (V1 MSD layers 2-5 as banded grouped layers on the "
                    f"time-folded layout, hifigan_tpu/ops/pallas/conv_stack.py:1140 "
                    f"zone_grouped_layer; lane masks :97-114, :267); launches: the zone layers' "
                    f"in the main path's run of {TRAIN_STEPS} V1 steps with "
                    f"msd_conv_impl='fused_zoned'; times and bound: one such step (B=16, 8192 "
                    f"samples, fp32, {PASSES_PER_STEP[kind]} passes of the chain per scale; "
                    "bound_ms from the grouped layers' MACs and bytes, the function's work, "
                    "at the 3xTF32 rate; bound_banded_ms from the banded tables', which do "
                    "banded_over_grouped times the MACs); library_ms: cuDNN's "
                    "grouped chain over the same layers, library_banded_ms: cuDNN on the "
                    "banded layers, std_form_ms: the same layers through the std form; "
                    "max_abs_err: the three scales at N=2 and N=16"),
        }
        entries.append(entry)
    return entries


def cli_train_phase(h) -> None:
    """Phase 7: ``python -m hifigan_tpu_torch.cli.train`` writes and resumes g_*/do_*."""
    from hifigan_tpu_torch.audio import save_wav
    from hifigan_tpu_torch.cli import train as cli_train
    from hifigan_tpu_torch.train.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "wavs").mkdir()
        sr = h["sampling_rate"]
        audio = synthetic_audio(5, sr, sr, SEED + 20)
        for i, wav in enumerate(audio):
            save_wav(str(tmp / "wavs" / f"utt{i}.wav"), wav, sr)
        (tmp / "train.txt").write_text("".join(f"utt{i}|text\n" for i in range(4)))
        (tmp / "valid.txt").write_text("utt4|text\n")
        (tmp / "config.json").write_text(json.dumps(dict(h, batch_size=2)))
        argv = ["--config", str(tmp / "config.json"), "--checkpoint_path", str(tmp / "ckpt"),
                "--input_wavs_dir", str(tmp / "wavs"), "--input_training_file",
                str(tmp / "train.txt"), "--input_validation_file", str(tmp / "valid.txt"),
                "--training_epochs", "1", "--checkpoint_interval", "2",
                "--validation_interval", "2", "--stdout_interval", "1"]
        first = cli_train.main(argv)
        check(first.step == 2, f"cli train ran {first.step} steps, expected 2")
        for name in ("g_00000002", "do_00000002"):
            check((tmp / "ckpt" / name).exists(), f"cli train did not write {name}")
        do = load_checkpoint(str(tmp / "ckpt" / "do_00000002"))
        check(do["steps"] == 2 and set(do) == {"mpd", "msd", "optim_g", "optim_d", "steps",
                                               "epoch"}, f"do_ file keys {sorted(do)}")
        second = cli_train.main(argv)  # resumes at step 2, re-runs epoch 0
        check(second.step == 4 and (tmp / "ckpt" / "do_00000004").exists(),
              f"cli train resume ended at step {second.step}")
        print("cli train wrote g_00000002/do_00000002 and resumed to step 4")


def distill_models(config: dict, dev, member_impl: str = "auto", conv_impl: str = "auto",
                   mesh=None, labels: dict = DISTILL_LABELS):
    """The distillation models of ``config`` with uniform label weights."""
    from hifigan_tpu_torch.distill.model import DistillModels

    weights = {g: {k: {"true": tuple([1.0 / len(v)] * len(v)),
                       "false": tuple([1.0 - 1.0 / len(v)] * len(v))}
                   for k, v in group.items()} for g, group in labels.items()}
    return DistillModels(config, labels, weights, sampling_rate=config["sampling_rate"],
                         member_impl=member_impl, conv_impl=conv_impl, device=dev, mesh=mesh)


def distill_batches(cfg: dict, trainer, models, labels: dict = DISTILL_LABELS) -> list:
    """The seeded distill batches of phases 9, 12, 15 and 18 (DISTILL_STEPS + 1)."""
    bsz, seg_len = trainer.batch_size, trainer.segment_length
    t_emb = seg_len // models.embedding_size
    rng = np.random.default_rng(SEED + 40)
    return [{"audio": synthetic_audio(bsz, seg_len, cfg["sampling_rate"], SEED + 41 + i),
             "time_labels": {g: {k: rng.integers(0, len(v), (bsz, t_emb))
                                 for k, v in group.items()}
                             for g, group in labels.items()}}
            for i in range(DISTILL_STEPS + 1)]


def record_segments(disc, wav: torch.Tensor) -> list:
    """One forward of ``disc``, recording every stream-graph call's arguments."""
    from hifigan_tpu_torch.dsl import fused_member as fm

    rec, real = [], fm.fused_stream_graph

    def spy(seg, inputs, tables, biases, members=1, weight_grads=True, **sharded):
        rec.append((seg, [x.detach() for x in inputs], [t.detach().contiguous() for t in tables],
                    [None if b is None else b.detach().float().contiguous() for b in biases],
                    members))
        return real(seg, inputs, tables, biases, members=members, weight_grads=weight_grads,
                    **sharded)

    fm.fused_stream_graph = spy
    try:
        with torch.no_grad():
            disc(wav)
    finally:
        fm.fused_stream_graph = real
    return rec


def table_work(table: torch.Tensor) -> tuple[float, float]:
    """(operations an output row, entries read) of one edge's table
    (members, K, c_in, c_out), counted from its data, a member's average.
    An output channel whose nonzero entries all share one value (the id,
    neg, pool, repl and avg tables) is a sum: an add per entry, and one
    multiply unless that value is +-1. Any other channel is a multiply-add
    (2 operations) per nonzero entry. Only nonzero entries are read."""
    t = table.detach().float().flatten(1, 2)
    nz = t != 0
    cnt = nz.sum(1)
    hi = torch.where(nz, t, -math.inf).amax(1)
    lo = torch.where(nz, t, math.inf).amin(1)
    ops = torch.where(hi == lo, cnt + (hi.abs() != 1).long(), 2 * cnt)
    return ops.sum().item() / t.shape[0], cnt.sum().item() / t.shape[0]


def segment_cost(seg, tables, biases, batch: int, members: int, esize: int, dw_mask) -> dict:
    """Operations and bytes of each pass of a segment, counted from its
    tables' data (:func:`table_work`). Forward: each edge's table over its
    op's output rows; dx: its transpose, as many; dW: a multiply-add per
    entry of each table in ``dw_mask`` and output row, an add per output of
    a biased op for db. Bytes: every input read once, every output written
    once (fwd: x, tables, biases -> ys; dx: ys, dys, tables -> dxs; dW: x,
    ys, dys -> the masked tables' dW, db)."""
    fwd = tab = dw = 0.0
    for (oi, _e), table, want in zip(seg.edges, tables, dw_mask):
        rows = batch * seg.levels[seg.ops[oi].out].t
        ops, read = table_work(table)
        fwd += rows * ops
        tab += members * read * esize
        if want:
            dw += 2 * rows * table[0].numel()
    n_bias = sum(b.numel() for b in biases if b is not None)
    dw += sum(batch * seg.levels[op.out].size for op, b in zip(seg.ops, biases) if b is not None)
    ins = sum(lvl.size for lvl in seg.levels if lvl.is_input) * batch * esize
    outs = sum(lvl.size for lvl in seg.levels if not lvl.is_input) * batch * esize
    dw_bytes = sum(t.numel() for t, want in zip(tables, dw_mask) if want) * esize + n_bias * 4
    return {"ops": {"fwd": fwd, "bwd_dx": fwd, "bwd_dw": dw},
            "bytes": {"fwd": ins + tab + n_bias * 4 + outs, "bwd_dx": 2 * outs + tab + ins,
                      "bwd_dw": ins + 2 * outs + dw_bytes}}


def segment_bound(cost, kind: str) -> tuple[float, str]:
    """(ms, what bounds it) of pass ``kind`` over a segment's cost, or the
    sum of a list of costs: operations at B3's fp32 SIMT rate or bytes at
    the memory rate, the larger."""
    costs = cost if isinstance(cost, list) else [cost]
    ops_ms = sum(c["ops"][kind] for c in costs) / H100_FP32_FLOPS * 1e3
    bytes_ms = sum(c["bytes"][kind] for c in costs) / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def time_segment(sg, seg, ins, tabs, bs, m, dys, dw_mask) -> dict:
    """CUDA-event times of one pass of kernel and plain version over a
    segment (mean of 5 after a warm-up): the dx launch differentiating every
    input and no weight; the dW launch over the tables of ``dw_mask`` and
    every bias, on the cotangents of a full dx launch (which also sets them
    up: the dW time excludes it)."""
    reps = 5
    n_in, n_tab, n_ops = len(ins), len(tabs), len(seg.ops)
    with torch.no_grad():
        k_fwd = time_ms(lambda: sg.fused_stream_graph(seg, ins, tabs, bs, members=m), reps)
        p_fwd = time_ms(lambda: sg.fused_stream_graph_reference(seg, ins, tabs, bs, m), reps)
        ys = sg.fused_stream_graph(seg, ins, tabs, bs, members=m)
        plan_dx = tuple(sg.backward_plan(seg, [True] * n_in, [False] * n_tab, [False] * n_ops,
                                         [True] * len(ys)))
        full = tuple(sg.backward_plan(seg, [True] * n_in, list(dw_mask),
                                      [b is not None for b in bs], [True] * len(ys)))
        plan_dw = [None if g is None else sg.OpGrad((), g.dw, g.db) for g in full]
        da, _ = sg._dx_cuda(seg, full, ins, ys, dys, tabs, m)
        k_dx = time_ms(lambda: sg._dx_cuda(seg, plan_dx, ins, ys, dys, tabs, m), reps)
        k_dw = time_ms(lambda: sg._dw_cuda(seg, full, ins, ys, da, tabs, m), reps)
        p_dx = time_ms(lambda: sg.fused_stream_graph_backward_reference(
            seg, ins, ys, dys, tabs, m, plan=plan_dx), reps)
        p_dw = time_ms(lambda: sg.fused_stream_graph_backward_reference(
            seg, ins, ys, dys, tabs, m, plan=plan_dw), reps)
    return {"ms": {"fwd": k_fwd, "bwd_dx": k_dx, "bwd_dw": k_dw},
            "plain_ms": {"fwd": p_fwd, "bwd_dx": p_dx, "bwd_dw": p_dw}}


def interp_times(disc_interp, wav: torch.Tensor) -> dict:
    """The interpreter's per-conv cuDNN chain over the whole discriminator:
    forward, dx (frozen weights) and dW (backward with weights minus dx)."""
    reps = 3

    def leaves(out):
        return [out["output"]["mean"]["output"], *out["output"]["mean"]["features"],
                *out["features"]]

    with torch.no_grad():
        fwd = time_ms(lambda: disc_interp(wav), reps)
    x = wav.clone().requires_grad_()
    disc_interp.requires_grad_(False)
    outs = leaves(disc_interp(x))
    cot = [torch.ones_like(o) for o in outs]
    dx = time_ms(lambda: torch.autograd.grad(outs, [x], cot, retain_graph=True), reps)
    disc_interp.requires_grad_(True)
    params = list(disc_interp.parameters())
    outs = leaves(disc_interp(wav))
    full = time_ms(lambda: torch.autograd.grad(outs, params, cot, retain_graph=True), reps)
    return {"fwd": fwd, "bwd_dx": dx, "bwd_dw": full - dx}


def stream_graph_phase(models, dev) -> dict:
    """Phase 8: the stream-graph kernels against their plain versions at
    every segment of a production discriminator member."""
    from hifigan_tpu_torch.ops import stream_graph as sg

    seg_len = models.config["loops"]["train"]["segment_length"]
    wav = torch.from_numpy(synthetic_audio(SG_ELEMENTS, seg_len, models.config["sampling_rate"],
                                           SEED + 30)).to(dev)[:, :, None]
    frozen = models.frozen_discriminator()
    segs = record_segments(frozen, wav)
    check(len(segs) == 10, f"a production member has 10 segments, recorded {len(segs)}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    errs = {dt: {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0} for dt in (torch.float32, torch.bfloat16)}
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tol_rel = FP32_TOL if dtype == torch.float32 else BF16_REL_TOL
        for si, (seg, ins, tabs, bs, m) in enumerate(segs):
            tag = f"segment {si} ({len(seg.ops)} ops) {str(dtype)[6:]}"
            ins_d = [x.to(dtype).contiguous() for x in ins]
            tabs_d = [t.to(dtype).contiguous() for t in tabs]

            def held(what, got, want, kind):
                err = (got.float() - want.float()).abs().max().item()
                peak = want.float().abs().max().item()
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{tag} {what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
                      f"{want.dtype}")
                check(bool(torch.isfinite(got).all()), f"{tag} {what}: non-finite")
                check(err <= tol_rel * peak, f"{tag} {what}: error {err} > {tol_rel} * {peak}")
                errs[dtype][kind] = max(errs[dtype][kind], err)

            with torch.no_grad():
                before = sg.launches()
                ys = sg.fused_stream_graph(seg, ins_d, tabs_d, bs, members=m)
                torch.cuda.synchronize()
                check(one_launch(sg, before, {"fwd": 1, "bwd_dx": 0, "bwd_dw": 0}),
                      f"{tag}: the forward took {sg.launches()} launches since {before}")
                plain = sg.fused_stream_graph_reference(seg, ins_d, tabs_d, bs, m)
            for li, (yk, yp) in enumerate(zip(ys, plain)):
                held(f"level {li}", yk, yp, "fwd")
            dys = [(torch.randn(y.shape, device=dev, generator=gen) * 0.01).to(dtype) for y in ys]
            for case, need_x, wg in (("all", True, True), ("weight_grads=False", True, False),
                                     ("weights only", False, True)):
                xs = [x.clone().requires_grad_(need_x) for x in ins_d]
                tt = [t.clone().requires_grad_() for t in tabs_d]
                bb = [None if b is None else b.clone().requires_grad_() for b in bs]
                outs = sg.fused_stream_graph(seg, xs, tt, bb, members=m, weight_grads=wg)
                wrt = (xs if need_x else []) + tt + [b for b in bb if b is not None]
                before = sg.launches()
                got = list(torch.autograd.grad(outs, wrt, dys, retain_graph=True))
                torch.cuda.synchronize()
                check(one_launch(sg, before, {"fwd": 0, "bwd_dx": 1, "bwd_dw": int(wg)}),
                      f"{tag} {case}: the backward took {sg.launches()} launches since {before}")
                if case == "all":  # the backward again: the same bits, dW and db included
                    again = torch.autograd.grad(outs, wrt, dys)
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"{tag}: two backward runs differ")
                dxs, dws, dbs = sg.fused_stream_graph_backward_reference(
                    seg, ins_d, [o.detach() for o in outs], dys, tabs_d, m,
                    dx_mask=[need_x] * len(xs), dw_mask=[wg] * len(tt),
                    db_mask=[wg and b is not None for b in bs])
                if need_x:
                    for i in range(len(xs)):
                        held(f"{case} dx{i}", got.pop(0), dxs[i], "bwd_dx")
                g_tab, g_bias = got[:len(tt)], got[len(tt):]
                if wg:
                    for i, (gk, rk) in enumerate(zip(g_tab, dws)):
                        if rk is not None:
                            held(f"{case} dW{i}", gk, rk, "bwd_dw")
                    for gb, rb in zip(g_bias, [d for d, b in zip(dbs, bs) if b is not None]):
                        held(f"{case} db", gb, rb, "bwd_dw")
                else:
                    check(all(not g.any() for g in got), f"{tag}: weight_grads=False gave dW != 0")
            if dtype == torch.float32:
                # phase 8 times dW over every table, the mel branch's constants too
                every = [True] * len(tabs_d)
                row = time_segment(sg, seg, ins_d, tabs_d, bs, m, dys, every)
                row["cost"] = c = segment_cost(seg, tabs_d, bs, ins_d[0].shape[0], m, 4, every)
                rows.append(row)
                print(f"stream graph {tag} B={ins_d[0].shape[0]}: "
                      + "; ".join(f"{k} kernel {row['ms'][k]:.3f} ms "
                                  f"plain {row['plain_ms'][k]:.3f} ms "
                                  f"({c['ops'][k] / max(row['ms'][k], 1e-6) / 1e9:.2f} "
                                  "TFLOP/s)" for k in ("fwd", "bwd_dx", "bwd_dw"))
                      + "; GFLOP " + ", ".join(f"{k} {c['ops'][k] / 1e9:.3f}" for k in c["ops"])
                      + "; bound " + ", ".join(f"{k} {segment_bound(c, k)[0]:.4f} ms"
                                               for k in ("fwd", "bwd_dx", "bwd_dw")))
            print(f"stream graph {tag}: every level, and dx/dW/db for all, "
                  f"weight_grads=False, weights only held; one launch a pass; two backward "
                  f"runs bit-identical")
    del frozen
    interp = copy.deepcopy(models.discriminator)
    for mod in interp.modules():
        if hasattr(mod, "member_impl"):
            mod.member_impl, mod.update_spectral = "interpret", False
    lib = interp_times(interp, wav)
    del interp
    print(f"stream graph, the whole discriminator at B={SG_ELEMENTS} x 3 members: kernels "
          + ", ".join(f"{k} {sum(r['ms'][k] for r in rows):.3f} ms" for k in lib)
          + "; the interpreter's cuDNN conv chain "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in lib.items()))
    return {"errs": errs, "rows": rows, "library_ms": lib}


# Per distill step, counted from the step's structure (distill/train.py): a
# production member is one segment per all-in-one block (the before conv and
# head 0 join the first, the after conv the last), each run in one launch
# per pass. Forward: 4 discriminator calls. dx: the frozen copy on generated
# audio and the two live calls, each reaching every segment (every segment
# has a level that needs a cotangent). dW: the two live calls, every segment
# having a conv with weights.
def distill_launches_per_step(n_blocks: int) -> dict:
    return {"fwd": 4 * n_blocks, "bwd_dx": 3 * n_blocks, "bwd_dw": 2 * n_blocks}


def one_launch(sg, before: dict, want: dict) -> bool:
    """The stream-graph launches since ``before`` are ``want``."""
    return {k: v - before[k] for k, v in sg.launches().items()} == want


def conv_op_calls(model, *inputs) -> list:
    """Every ``msd_conv1d_lrelu`` call of one forward of ``model``: (whether x
    needs a gradient, x, kernel, bias, keywords), detached. The op is spied
    on and its plain version run in its place, so nothing is launched."""
    from hifigan_tpu_torch.ops import msd_conv

    rec, real = [], msd_conv.msd_conv1d_lrelu

    def spy(x, kernel, bias, **kw):
        rec.append((x.requires_grad, x.detach(), kernel.detach(),
                    None if bias is None else bias.detach(), kw))
        return msd_conv.msd_conv1d_lrelu_reference(x, kernel, bias, **kw)

    msd_conv.msd_conv1d_lrelu = spy
    try:
        model(*inputs)
    finally:
        msd_conv.msd_conv1d_lrelu = real
    return rec


def kernel_conv_nodes(model) -> int:
    """The conv nodes that one forward of a DSL model sends to
    ``msd_conv1d_lrelu``, counted from its structure alone: every
    ``NormConv1d`` whose stride and dilation its ``conv_impl`` routes to the
    op, and those of ensemble members evaluated one by one (an ensemble that
    the stream-graph kernel takes whole runs none)."""
    from hifigan_tpu_torch.dsl.fused_member import StreamUnsupported, parse_member
    from hifigan_tpu_torch.dsl.normalize import SEQ

    n = sum(model._conv_backend(c.stride, c.dilation) == "kernel" for c in model.convs.values())
    for members in model.ensembles.values():
        cfg = members[0].config
        fused = model._fused() and cfg[0] != SEQ and cfg[1] == "pfmap"
        if fused:
            try:
                parse_member(cfg[2], "m")
            except StreamUnsupported:
                fused = False
        if not fused:
            n += sum(kernel_conv_nodes(m) for m in members)
    return n


def conv_op_counts(model, *inputs) -> tuple[int, int]:
    """(conv-op calls of one forward of ``model``, how many of them read an
    input that needs no gradient), with the model's parameters trainable and
    constant inputs. The calls are counted by a spy and held against the
    count taken from the model's structure, so a conv node that missed the
    op would show."""
    rec = conv_op_calls(model, *inputs)
    nodes = kernel_conv_nodes(model)
    check(len(rec) == nodes, f"{type(model).__name__}: {len(rec)} calls of the per-layer conv op "
                             f"in one forward, {nodes} conv nodes routed to it")
    return len(rec), sum(not r[0] for r in rec)


def distill_msd_launches_per_step(models, segment_length: int) -> dict:
    """Launches of the two ``msd_conv1d_lrelu`` kernels in one distill step
    with ``conv_impl='pallas'``, composed from the step's structure
    (``distill/train.py::compute_losses``) and each model's conv-op calls
    per forward (c) and the calls among them whose input needs no gradient
    when the model's own input needs none (i), from :func:`conv_op_counts`:

    - forward: encoder and decoder twice; per classifier key the keepers 3
      times (once live, twice without grad), the hunters twice (the frozen
      copy and the live one), the sniffers twice (once without grad, once
      live); the discriminator 4 times (its convs outside fused members);
    - dx: the encoder on the waveform (c - i) and on generated audio (c); the
      decoder twice (c); the live keepers (c), the hunters' frozen copy on
      the live embedding (c) and the live hunters and sniffers on detached
      inputs (c - i); the live discriminator twice on constant audio (c - i)
      and its frozen copy on generated audio (c)."""
    dev = models.device
    wav = torch.zeros((1, segment_length, 1), device=dev)
    half = models.embedding_channels // 2
    emb_half = torch.zeros((1, segment_length // models.embedding_size, half), device=dev)
    with torch.no_grad():
        emb = models.encoder(wav)
    counts = {"encoder": conv_op_counts(models.encoder, wav),
              "decoder": conv_op_counts(models.decoder, emb),
              # a copy: a call advances the live discriminator's spectral state
              "discriminator": conv_op_counts(copy.deepcopy(models.discriminator), wav)}
    fwd = 2 * sum(counts[k][0] for k in ("encoder", "decoder")) + 4 * counts["discriminator"][0]
    dx = (2 * counts["encoder"][0] - counts["encoder"][1] + 2 * counts["decoder"][0]
          + 3 * counts["discriminator"][0] - 2 * counts["discriminator"][1])
    for key in models.keepers:
        ck, _ = conv_op_counts(models.keepers[key], emb_half)
        ch, ih = conv_op_counts(models.hunters[key], emb_half)
        with torch.no_grad():
            preds = models.keepers[key](emb_half)["mean"][key]
        cs, is_ = conv_op_counts(models.sniffers[key], preds)
        fwd += 3 * ck + 2 * ch + 2 * cs
        dx += ck + 2 * ch - ih + cs - is_
    return {"fwd": fwd, "bwd_dx": dx}


def optimizer_snapshot(state) -> dict:
    """Each group's parameters and Adam first moments, cloned. After step 1
    a first moment is (1 - b1) x the group's clipped gradient."""
    return {g: ([p.detach().clone() for p in o.params], [m.clone() for m in o.mu])
            for g, o in state.optimizers.items()}


def parameter_names(models) -> dict:
    """id(parameter) -> its name in the distillation models."""
    names = {}
    for key in ("encoder", "decoder", "discriminator", "keepers", "hunters", "sniffers"):
        obj = getattr(models, key)
        subs = obj.items() if isinstance(obj, dict) else [("", obj)]
        for sub, mod in subs:
            for n, p in mod.named_parameters():
                names[id(p)] = ".".join(x for x in (key, sub, n) if x)
    return names


def held_update(names: dict, lrs: dict, before: dict, got: dict, want: dict) -> dict:
    """Step 1's gradients (the Adam first moments) and updated parameters of
    each group against a reference step's: each leaf's gradient
    difference in norm over its gradient's norm (the worst leaf), and each
    group's parameter difference in norm over the reference update's norm
    (the worst group). AdamW's first update is lr * g / (|g| + eps) +
    lr * wd * p per element, about lr * sign(g), so an element whose gradient
    two steps put on either side of zero steps 2 lr apart however close the
    gradients are: a group's update difference is about 2 sqrt(f), f the
    share of such elements. The reading also splits the parameter
    difference into those elements and the rest (in units of lr)."""
    grad_rel, grp_rel = {}, {}
    n = flips = 0
    flip_sq = total_sq = agree_dp = 0.0
    for g, (want_p, want_m) in want.items():
        got_p, got_m = got[g]
        dsq = usq = 0.0
        for name, p0, pg, mg, pw, mw in zip(names[g], before[g], got_p, got_m, want_p, want_m):
            grad_rel[name] = ((mg - mw).double().norm()
                              / mw.double().norm().clamp_min(1e-30)).item()
            dp = (pg - pw).double()
            sq = float((dp * dp).sum())
            dsq, usq = dsq + sq, usq + float(((pw - p0).double() ** 2).sum())
            flip = torch.sign(mg) != torch.sign(mw)
            n += mw.numel()
            flips += int(flip.sum())
            flip_sq, total_sq = flip_sq + float((dp[flip] ** 2).sum()), total_sq + sq
            if bool((~flip).any()):
                agree_dp = max(agree_dp, float(dp[~flip].abs().max()) / lrs[g])
        grp_rel[g] = (dsq / max(usq, 1e-300)) ** 0.5
    wg, wu = max(grad_rel, key=grad_rel.get), max(grp_rel, key=grp_rel.get)
    return {"grad_rel": grad_rel[wg], "grad_leaf": wg, "update_rel": grp_rel[wu],
            "update_group": wu, "elements": n, "sign_flips": flips,
            "flip_share": flip_sq / total_sq if total_sq > 0 else 0.0,
            "agree_max_dp_over_lr": agree_dp, "leaves": len(grad_rel)}


def update_line(what: str, upd: dict) -> str:
    return (f"{what}: gradients (Adam first moments) worst leaf {upd['grad_rel']:.3e} of its "
            f"norm at {upd['grad_leaf']}; parameters worst group {upd['update_rel']:.3e} of its "
            f"update's norm at {upd['update_group']}; of {upd['elements']} elements "
            f"{upd['sign_flips']} have first moments of the other sign and carry "
            f"{100 * upd['flip_share']:.3f}% of the squared parameter difference, elsewhere "
            f"|dp| <= {upd['agree_max_dp_over_lr']:.3e} lr")


class jittered_convs:
    """Within the block every DSL conv node's output is multiplied by
    (1 + delta * N(0, 1)), seeded: float-order noise of relative size delta."""

    def __init__(self, delta: float, seed: int):
        self.delta, self.seed = delta, seed

    def __enter__(self):
        from hifigan_tpu_torch.dsl.module import ConfigurableModule

        real, delta = ConfigurableModule._conv_node, self.delta
        gen = None

        def node(mod, p, x, name):
            nonlocal gen
            y = real(mod, p, x, name)
            if gen is None:
                gen = torch.Generator(device=y.device).manual_seed(self.seed)
            return y * (1 + delta * torch.randn(y.shape, device=y.device, generator=gen))

        self.real, ConfigurableModule._conv_node = real, node
        return self

    def __exit__(self, *exc):
        from hifigan_tpu_torch.dsl.module import ConfigurableModule

        ConfigurableModule._conv_node = self.real


class host_clock:
    """Within the block, the host seconds spent in each function of
    ``spots`` ({key: (module, attribute)}, called through that module's
    name), summed by key into ``self.s``."""

    def __init__(self, spots: dict):
        self.s = {k: 0.0 for k in spots}
        self.spots = spots
        self.real = {k: getattr(mod, name) for k, (mod, name) in self.spots.items()}

    def __enter__(self):
        for k, (mod, name) in self.spots.items():
            def timed(*a, _fn=self.real[k], _k=k, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.s[_k] += time.perf_counter() - t0

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for k, (mod, name) in self.spots.items():
            setattr(mod, name, self.real[k])


def stream_graph_host_clock() -> host_clock:
    """The host time in the stream-graph wrapper as the fused member and
    the stream-fusion pass call it (the forward launch and everything
    before it, each call with the new Segment they build) and in its dx and
    dW launch functions, by pass."""
    from hifigan_tpu_torch.dsl import fused_member as fm
    from hifigan_tpu_torch.ops import stream_graph as sg

    return host_clock({"fwd": (fm, "fused_stream_graph"), "bwd_dx": (sg, "_dx_cuda"),
                       "bwd_dw": (sg, "_dw_cuda")})


def host_ms(fn, reps: int) -> float:
    """Median host time of one call of ``fn`` (returning before the card
    finishes), the card idle at each start."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(out))


def profile_step(step, state, batch, step_ms: float, what: str):
    """One more step under ``torch.profiler``: device busy time, the
    stream-graph and per-layer conv kernels' shares of it, device events and
    the idle share of ``step_ms``, printed with the 15 costliest kernels.
    Returns (state, share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in on_card)
    sg_us = sum(e.time_range.elapsed_us() for e in on_card if "::sg_" in e.name)
    msd_us = sum(e.time_range.elapsed_us() for e in on_card if "::msd_" in e.name)
    share = {"step_device_ms": dev_us / 1e3, "sg_device_ms": sg_us / 1e3,
             "msd_device_ms": msd_us / 1e3, "idle_share": 1 - dev_us / 1e3 / step_ms,
             "device_events": len(on_card)}
    if dev_us > 0:
        print(f"profiled step ({what}): device busy {dev_us / 1e3:.3f} ms, of "
              f"which the stream-graph kernels {sg_us / 1e3:.3f} ms ({100 * sg_us / dev_us:.1f}%) "
              f"and the per-layer conv kernels {msd_us / 1e3:.3f} ms "
              f"({100 * msd_us / dev_us:.1f}%); {len(on_card)} device events; idle "
              f"{100 * share['idle_share']:.1f}% of the median step")
        by_name: dict = {}
        for e in on_card:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
            print(f"  device {us / 1e3:8.3f} ms {n:6d}x  {name[:110]}")
    else:
        print("profiled step: the profiler reported no device time (not measured)")
    return state, share


def flat_losses(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_losses(v, f"{prefix}/{k}"))
        return out
    return {prefix: float(tree)}


def distill_phase(config: dict, dev, conv_impl: str = "auto", stream_impl: str = "auto",
                  keep_state: bool = False) -> dict:
    """Phases 9, 12 and 15: production distillation train steps through the
    port's main path, with the DSL's ``conv_impl`` ``'auto'`` (step 1 held
    against the interpreted members) or ``'pallas'`` (every conv node of the
    generator and classifiers through the per-layer conv kernels; step 1
    held against ``'auto'``), or with ``models.stream_impl`` ``'fused'``
    (the encoder's and decoder's narrow runs through the stream-graph
    kernels; step 1 held against ``'auto'``, and the runs' segments'
    backward against the plain backward). ``keep_state`` returns the state
    (key ``state``)."""
    from hifigan_tpu_torch.distill.train import DistillTrainer
    from hifigan_tpu_torch.ops import msd_conv
    from hifigan_tpu_torch.ops import stream_graph as sg
    from hifigan_tpu_torch.train.checkpoint import distill_state_dicts, load_distill_variables

    cfg = copy.deepcopy(config)
    cfg["learning"]["accumulated_grad_batches"] = 1
    cfg["models"]["stream_impl"] = stream_impl
    what = f"conv_impl={conv_impl!r}" if stream_impl == "auto" else f"stream_impl={stream_impl!r}"
    print(f"distill {what}: configs/distill.json as shipped but "
          "accumulated_grad_batches 1 instead of 100 (an in-memory copy), so each of the "
          f"{DISTILL_STEPS} steps applies an update")
    models = distill_models(cfg, dev, conv_impl=conv_impl)
    trainer = DistillTrainer(models, cfg)
    t0 = time.perf_counter()
    state = trainer.create_state(seed=SEED)
    print(f"distill models built (seeded, CPU) and moved in {time.perf_counter() - t0:.3f} s")
    bsz, seg_len = trainer.batch_size, trainer.segment_length
    batches = distill_batches(cfg, trainer, models)

    # the reference: the same step with the members interpreted (conv_impl
    # 'auto') or with the default conv path ('pallas')
    if stream_impl != "auto":
        ref_name = "stream_impl='auto'"
        interp = distill_models(dict(cfg, models=dict(cfg["models"], stream_impl="auto")), dev)
    elif conv_impl == "auto":
        ref_name = "member_impl='interpret'"
        interp = distill_models(cfg, dev, member_impl="interpret")
    else:
        ref_name = "conv_impl='auto'"
        interp = distill_models(cfg, dev)
    interp.build(seg_len, seed=SEED)
    start = distill_state_dicts(models)
    load_distill_variables(interp, start)
    trainer_i = DistillTrainer(interp, cfg)
    ref_state, ref = trainer_i.make_train_step()(trainer_i.create_state(build=False), batches[0])
    ref = flat_losses(ref)
    ref_after = optimizer_snapshot(ref_state)
    del ref_state
    # the noise floor: the reference step again, from the same start, with
    # every DSL conv output jittered at float-order size
    load_distill_variables(interp, start)
    with jittered_convs(JITTER, SEED + 42):
        jit_state, _ = trainer_i.make_train_step()(trainer_i.create_state(build=False),
                                                   batches[0])
    jit_after = optimizer_snapshot(jit_state)
    del interp, trainer_i, jit_state, start
    torch.cuda.empty_cache()

    n_blocks = len(cfg["models"]["discriminator"]["layers"]) - 2
    per_step = distill_launches_per_step(n_blocks)
    gen_runs = 0
    if stream_impl != "auto":
        # each pass runs every fused run of the two encoder and two decoder calls
        x0 = torch.from_numpy(batches[0]["audio"]).to(dev)[:, :, None]
        enc, dec = generator_runs(models, x0)
        gen_runs = len(enc) + len(dec)
        check(gen_runs == STREAM_RUNS_SHIPPED,
              f"{gen_runs} fused runs at the step's batch, {STREAM_RUNS_SHIPPED} expected")
        per_step = {k: v + 2 * STREAM_RUNS_SHIPPED for k, v in per_step.items()}
        print(f"distill {what}: {len(enc)} + {len(dec)} fused runs an autoencode, so "
              f"{2 * STREAM_RUNS_SHIPPED} more stream-graph launches a step and pass")
    msd_per_step = (distill_msd_launches_per_step(models, seg_len) if conv_impl == "pallas"
                    else {"fwd": 0, "bwd_dx": 0})
    before = {g: [p.detach().clone() for p in opt.params] for g, opt in state.optimizers.items()}
    ids = parameter_names(models)
    leaf_names = {g: [ids[id(p)] for p in opt.params] for g, opt in state.optimizers.items()}
    # the spectral conv (the before conv, 1 -> 1 channel) keeps u (1,), which
    # is +-1 by construction; its power-iteration state that moves is v
    spec0 = {k: v.clone() for k, v in models.discriminator.named_buffers()
             if k.endswith(("weight_u", "weight_v"))}
    n_spec = 2 * cfg["models"]["discriminator"].get("ensemble", 3)  # u and v per member
    check(len(spec0) == n_spec,
          f"the live discriminator has {len(spec0)} spectral vectors, expected {n_spec}")
    step = trainer.make_train_step()
    step_ms, launches_per_step, msd_per_steps, history = [], [], [], []
    sg.reset_launches()
    msd_conv.reset_launches()
    clock = stream_graph_host_clock()
    for i, batch in enumerate(batches[:DISTILL_STEPS]):
        counts, msd_counts = sg.launches(), msd_conv.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i < 2:
            state, losses = step(state, batch)
        else:
            with clock:
                state, losses = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches_per_step.append({k: v - counts[k] for k, v in sg.launches().items()})
        msd_per_steps.append({k: v - msd_counts[k] for k, v in msd_conv.launches().items()})
        history.append(flat_losses(losses))
        if len(history) == 1:
            after_1 = optimizer_snapshot(state)
    launches, msd_launches = sg.launches(), msd_conv.launches()
    for i, (h, n, nm) in enumerate(zip(history, launches_per_step, msd_per_steps)):
        check(all(np.isfinite(v) for v in h.values()), f"distill step {i + 1}: non-finite losses")
        check(n == per_step, f"distill step {i + 1}: stream-graph launches {n}, derived {per_step}")
        check(nm == msd_per_step, f"distill step {i + 1}: per-layer conv launches {nm}, "
                                  f"derived {msd_per_step}")
    for g, params in before.items():
        moved = sum(not torch.equal(a, b) for a, b in zip(params, state.optimizers[g].params))
        check(moved == len(params), f"group {g}: {len(params) - moved} of {len(params)} "
                                    "parameters did not move")
    bufs = dict(models.discriminator.named_buffers())
    for k, v in spec0.items():
        check(bool(torch.isfinite(bufs[k]).all()) and abs(bufs[k].norm().item() - 1) < 1e-4,
              f"{k} is not a unit vector")
        check(k.endswith("weight_u") or not torch.equal(v, bufs[k]), f"{k} did not move")
    print("live discriminator spectral state after the steps: u "
          f"{[bufs[k].tolist() for k in spec0 if k.endswith('weight_u')]}, every v moved")
    rel = {k: abs(history[0][k] - v) / max(abs(v), 1e-30) for k, v in ref.items()}
    worst = max(rel, key=rel.get)
    print(f"distill step 1 total, {what} {history[0]['/total']:.6f}, "
          f"{ref_name} {ref['/total']:.6f}; worst relative difference over {len(rel)} losses "
          f"{rel[worst]:.3e} at {worst} (limit {DISTILL_REL_TOL})")
    check(rel[worst] <= DISTILL_REL_TOL,
          f"distill step 1 {what} vs {ref_name}: {worst} {rel[worst]}")
    upd = held_update(leaf_names, trainer.flat_groups, before, after_1, ref_after)
    floor = held_update(leaf_names, trainer.flat_groups, before, jit_after, ref_after)
    del after_1, ref_after, jit_after
    print(update_line(f"distill step 1, {what} vs {ref_name}", upd))
    print(update_line(f"distill step 1, {ref_name} with its conv outputs jittered by {JITTER:g} "
                      f"vs {ref_name} (the noise floor)", floor))
    check(upd["leaves"] == len(ids), f"{upd['leaves']} leaves held of {len(ids)} parameters")
    check(upd["grad_rel"] <= STEP_GRAD_TOL,
          f"distill step 1 gradients, {what} vs {ref_name}: "
          f"{upd['grad_leaf']} {upd['grad_rel']} > {STEP_GRAD_TOL}")
    check(upd["update_rel"] <= STEP_UPDATE_TOL,
          f"distill step 1 parameters, {what} vs {ref_name}: "
          f"{upd['update_group']} {upd['update_rel']} > {STEP_UPDATE_TOL}")
    ms = float(np.median(step_ms[2:]))
    print(f"distill {what} B={bsz}x{seg_len} fp32 (TF32 off): step ms "
          f"{[round(t, 3) for t in step_ms]}, median of steps 3-{DISTILL_STEPS}: {ms:.3f} ms "
          f"({bsz * seg_len / cfg['sampling_rate'] / ms * 1e3:.2f}x real time); stream-graph "
          f"launches per step {per_step}; per-layer conv launches per step {msd_per_step}; "
          f"total loss by step {[round(h['/total'], 4) for h in history]}")
    host = {k: v * 1e3 / (DISTILL_STEPS - 2) for k, v in clock.s.items()}
    print(f"stream-graph host time a step (steps 3-{DISTILL_STEPS}, the segments built anew "
          "each call): " + ", ".join(f"{k} {v:.3f} ms over {per_step[k]} launches"
                                     for k, v in host.items())
          + f"; {sum(host.values()):.3f} ms of the {ms:.3f} ms step")
    out = {"step_ms": ms, "launches": launches, "per_step": per_step, "rel": rel[worst],
           "sg_host_ms": host, "losses_1": history[0],
           "msd_launches": msd_launches, "msd_per_step": msd_per_step, "update": upd,
           "update_floor": floor, "gen_runs": gen_runs}
    if stream_impl != "auto":
        out["segments"] = hold_generator_backward(models, batches[0])

    state, share = profile_step(step, state, batches[DISTILL_STEPS], ms, what)
    out["share"] = share
    if keep_state:
        out["state"], out["trainer"], out["batches"] = state, trainer, batches
    return out


def conv_cost(x: torch.Tensor, k: int, ci_g: int, y: torch.Tensor) -> dict:
    """FLOP of one pass and the bytes each pass must move: forward x, W, b
    in and y out; dx dy, y, W in and dx out."""
    esize = x.element_size()
    w = k * ci_g * y.shape[2] * esize
    flop = 2 * y.numel() * k * ci_g
    return {"flop": flop, "fwd": x.numel() * esize + w + y.shape[2] * 4 + y.numel() * esize,
            "bwd_dx": 2 * y.numel() * esize + w + x.numel() * esize}


def bound_ms(flop: float, nbytes: float, peak: float) -> tuple[float, str]:
    ops_ms, bytes_ms = flop / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def library_conv(xc, wc, b, kw) -> torch.Tensor:
    """One cuDNN call chain computing the same function, (N, C, T) layout: a yardstick only."""
    pads = kw["padding"] if isinstance(kw["padding"], tuple) else (kw["padding"],) * 2
    z = F.conv1d(F.pad(xc, pads), wc, b, stride=kw["stride"], dilation=kw["dilation"],
                 groups=kw["groups"])
    return F.leaky_relu(z, kw["slope"]) if kw["slope"] != 1.0 else z


def held_conv(msd_conv, tag: str, x, kern, bias, kw, tol_rel: float, gen, errs: dict,
              times: bool = False) -> dict | None:
    """The B5 forward and dx against their plain versions on one call's
    operands (dx over the kernel's own saved output), printing the call's
    plan; with ``times``, the CUDA-event times of kernel, plain version and
    library call."""
    def held(what, got, want, kind):
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{tag} {what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        check(bool(torch.isfinite(got).all()), f"{tag} {what}: non-finite")
        check(err <= tol_rel * peak, f"{tag} {what}: error {err} > {tol_rel} * {peak}")
        errs[kind] = max(errs[kind], err)

    xk = x.clone().requires_grad_()
    with torch.no_grad():
        y = msd_conv.msd_conv1d_lrelu(x, kern, bias, **kw)
        torch.cuda.synchronize()
        held("y", y, msd_conv.msd_conv1d_lrelu_reference(x, kern, bias, **kw), "fwd")
    yk = msd_conv.msd_conv1d_lrelu(xk, kern, bias, **kw)
    dy = (torch.randn(yk.shape, device=x.device, generator=gen) * 0.01).to(x.dtype)
    (dx,) = torch.autograd.grad(yk, [xk], dy, retain_graph=times)
    torch.cuda.synchronize()
    want, _, _ = msd_conv.msd_conv1d_lrelu_backward_reference(x, kern, yk.detach(), dy,
                                                              weight_grads=False, **kw)
    held("dx", dx, want, "bwd_dx")
    g = msd_conv._geom(kw.get("stride", 1), kw.get("padding", 0), kw.get("dilation", 1),
                       kw.get("groups", 1), kw.get("slope", 1.0))
    shape = msd_conv.conv_shape(x.shape, y.shape, kern.shape[0], g)
    print(f"{tag}: forward and dx held; plan {plan_text(shape, x.dtype, ('fwd', 'dx'))}")
    if not times:
        return None
    reps = 10
    saved = yk.detach()
    xc = x.transpose(1, 2).contiguous()
    wc = kern.to(x.dtype).permute(2, 1, 0).contiguous()
    bc = None if bias is None else bias.to(x.dtype)
    with torch.no_grad():
        k_fwd = time_ms(lambda: msd_conv.msd_conv1d_lrelu(x, kern, bias, **kw), reps)
        p_fwd = time_ms(lambda: msd_conv.msd_conv1d_lrelu_reference(x, kern, bias, **kw), reps)
        l_fwd = time_ms(lambda: library_conv(xc, wc, bc, kw), reps)
        p_dx = time_ms(lambda: msd_conv.msd_conv1d_lrelu_backward_reference(
            x, kern, saved, dy, weight_grads=False, **kw), reps)
    k_dx = time_ms(lambda: torch.autograd.grad(yk, [xk], dy, retain_graph=True), reps)
    xl = xc.clone().requires_grad_()
    yl = library_conv(xl, wc, bc, kw)
    dyl = dy.transpose(1, 2).contiguous()
    l_dx = time_ms(lambda: torch.autograd.grad(yl, [xl], dyl, retain_graph=True), reps)
    return {"ms": {"fwd": k_fwd, "bwd_dx": k_dx}, "plain_ms": {"fwd": p_fwd, "bwd_dx": p_dx},
            "library_ms": {"fwd": l_fwd, "bwd_dx": l_dx},
            "cost": conv_cost(x, kern.shape[0], kern.shape[1], y)}


def msd_conv_phase(msd, distill_cfg: dict, dev) -> dict:
    """Phase 10: the per-layer conv kernels against their plain versions at
    every V1 MSD layer (full width, three scales, N=2 and N=16) and at every
    distinct conv-node geometry of ``configs/distill.json`` (its generator
    and classifiers at the step's shapes, and its discriminator's members
    interpreted), fp32 (TF32 off) and bf16."""
    from hifigan_tpu_torch.ops import msd_conv
    from hifigan_tpu_torch.ops.conv import LRELU_SLOPE, avg_pool1d

    errs = {dt: {"fwd": 0.0, "bwd_dx": 0.0} for dt in (torch.float32, torch.bfloat16)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    wav = torch.from_numpy(synthetic_audio(max(STACK_BATCHES), SEGMENT, 22050, SEED + 51)).to(dev)
    rows = []  # fp32, N=16: one per (scale, layer)
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else BF16_REL_TOL
        y = wav
        for scale, d in enumerate(msd.discriminators):
            if scale:
                y = avg_pool1d(y[..., None], 4, 2, padding=2)[..., 0]
            convs = [*d.convs, d.conv_post]
            for n in STACK_BATCHES:
                h = y[:n, :, None].to(dtype).contiguous()
                for li, conv in enumerate(convs):
                    kern, bias = (t.detach() for t in conv.kernel_nwc(False, dtype))
                    kw = dict(stride=conv.stride, padding=conv.padding, dilation=conv.dilation,
                              groups=conv.groups, slope=LRELU_SLOPE if li < 7 else 1.0)
                    tag = f"msd scale {scale} layer {li} T={h.shape[1]} N={n} {str(dtype)[6:]}"
                    timed = dtype == torch.float32 and n == max(STACK_BATCHES)
                    row = held_conv(msd_conv, tag, h, kern, bias, kw, tol, gen, errs[dtype], timed)
                    if row is not None:
                        row.update(scale=scale, layer=li, T=h.shape[1])
                        rows.append(row)
                        print(f"{tag}: kernel fwd {row['ms']['fwd']:.4f} dx {row['ms']['bwd_dx']:.4f} ms, "
                              f"plain fwd {row['plain_ms']['fwd']:.4f} dx {row['plain_ms']['bwd_dx']:.4f} ms, "
                              f"cudnn fwd {row['library_ms']['fwd']:.4f} dx "
                              f"{row['library_ms']['bwd_dx']:.4f} ms, bound "
                              f"{bound_ms(row['cost']['flop'], row['cost']['fwd'], FP32_MMA_FLOPS)[0]:.4f} ms "
                              f"({row['cost']['flop'] / 1e9:.2f} GFLOP; fwd "
                              f"{row['cost']['flop'] / max(row['ms']['fwd'], 1e-6) / 1e9:.2f}, dx "
                              f"{row['cost']['flop'] / max(row['ms']['bwd_dx'], 1e-6) / 1e9:.2f} "
                              "TFLOP/s)")
                    with torch.no_grad():
                        h = msd_conv.msd_conv1d_lrelu(h, kern, bias, **kw)
        print(f"msd conv {str(dtype)[6:]}: every V1 MSD layer at three scales, N={STACK_BATCHES}, "
              f"forward and dx held (max_abs_err {json.dumps(errs[dtype])})")

    # the distillation's conv nodes, recorded at the step's shapes
    models = distill_models(distill_cfg, dev, member_impl="interpret", conv_impl="pallas")
    seg_len = distill_cfg["loops"]["train"]["segment_length"]
    models.build(seg_len, seed=SEED)
    bsz = distill_cfg["loops"]["train"]["batch_size"]
    wav3 = torch.from_numpy(synthetic_audio(bsz, seg_len, distill_cfg["sampling_rate"],
                                            SEED + 52)).to(dev)[:, :, None]
    with torch.no_grad():
        emb = models.encoder(wav3)
    calls = conv_op_calls(models.encoder, wav3) + conv_op_calls(models.decoder, emb)
    for key in models.keepers:
        calls += conv_op_calls(models.keepers[key], emb[key])
        calls += conv_op_calls(models.hunters[key], emb[key])
        with torch.no_grad():
            preds = models.keepers[key](emb[key])["mean"][key]
        calls += conv_op_calls(models.sniffers[key], preds)
    calls += conv_op_calls(models.discriminator, wav3)
    del models
    distinct = {}
    for _, x, kern, bias, kw in calls:
        key = (tuple(x.shape), tuple(kern.shape), bias is None,
               tuple(sorted((k, str(v)) for k, v in kw.items())))
        distinct.setdefault(key, (x, kern, bias, kw))
    geoms = sorted({(k[0][2], k[1][2], k[1][0], kw["stride"], kw["dilation"], kw["groups"],
                     str(kw["padding"])) for k, (_, _, _, kw) in distinct.items()})
    for dtype in (torch.float32, torch.bfloat16):
        tol = FP32_TOL if dtype == torch.float32 else BF16_REL_TOL
        for i, (x, kern, bias, kw) in enumerate(distinct.values()):
            tag = (f"distill conv {tuple(x.shape)} k{tuple(kern.shape)} s{kw['stride']} "
                   f"d{kw['dilation']} g{kw['groups']} p{kw['padding']} {str(dtype)[6:]}")
            held_conv(msd_conv, tag, x.to(dtype).contiguous(), kern.to(dtype), bias, kw, tol, gen,
                      errs[dtype])
    print(f"msd conv: {len(distinct)} distinct distill conv calls ({len(geoms)} geometries "
          f"(c_in, c_out, k, stride, dilation, groups, padding): {geoms}) held in fp32 and bf16; "
          f"max_abs_err {json.dumps({str(k)[6:]: v for k, v in errs.items()})}")
    return {"errs": errs, "rows": rows, "distill_geoms": len(geoms)}


def logmel_cost(batch: int, frames: int, t: int, cfg) -> dict:
    """The operations and bytes one log-mel extraction needs: per frame the
    Hann window, a real FFT of n_fft points (2.5 n log2 n operations, half
    the 5 n log2 n of a complex radix-2 FFT), the power, the filterbank's
    nonzeros (2 each) and the clamp and log; the signal, the window and the
    filterbank's nonzeros read once and the output written once. Beside it,
    the dense-DFT algorithm's own count (the kernel's: the windowed basis as
    an n_fft x 2 n_bins product and the filterbank dense), which bounds that
    algorithm only."""
    import math

    from hifigan_tpu_torch.ops import logmel

    n, n_bins, mels = cfg.n_fft, cfg.n_fft // 2 + 1, cfg.num_mels
    nnz = int(np.count_nonzero(logmel._tables(cfg)[1]))
    per_frame = n + 2.5 * n * math.log2(n) + 3 * n_bins + 2 * nnz + 2 * mels
    dense = 2 * n * 2 * n_bins + 3 * n_bins + 2 * n_bins * mels + 2 * mels
    out = batch * mels * frames
    return {"flop": batch * frames * per_frame, "bytes": 4 * (batch * t + n + nnz + out),
            "dense_flop": batch * frames * dense,
            "dense_bytes": 4 * (batch * t + n * 2 * n_bins + n_bins * mels + out), "nnz": nnz}


def hold_log_mel(name: str, y: torch.Tensor, got: torch.Tensor, cfg, auto) -> dict:
    """The fused log-mel kernel's output ``got`` for ``y`` against its plain
    version (forward within 2e-4 + 1e-4 |plain|; the gradient of a
    sin-weighted sum within FP32_TOL of the plain gradient's peak, or, where
    the plain fp32 forward's own error moves the cotangent further than
    that, no further from the gradient with the float64 forward's cotangent
    than the plain version's plus FP32_TOL of the peak), each error's share
    of its limit and both versions' distance from the same log-mel through a
    float64 rfft; kernel, plain and cuFFT (``method='auto'``) times and the
    bounds."""
    from hifigan_tpu_torch.audio.mel import log_mel_spectrogram
    from hifigan_tpu_torch.audio.stft import hann_window
    from hifigan_tpu_torch.ops import logmel

    with torch.no_grad():
        want = logmel.fused_log_mel_reference(y, cfg)
    check(got.shape == want.shape == (y.shape[0], cfg.num_mels, logmel.num_frames(y.shape[1], cfg)),
          f"log-mel {name}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"log-mel {name}: non-finite")
    diff = (got - want).abs()
    check(bool((diff <= 2e-4 + 1e-4 * want.abs()).all()),
          f"log-mel {name}: max error {diff.max().item()} beyond 2e-4 + 1e-4 |plain|")
    ratio = (diff / (2e-4 + 1e-4 * want.abs())).max().item()
    # the exact answer's stand-in: the same log-mel through a float64 rfft
    with torch.no_grad():
        yp64, _ = logmel._pad_crop(y.double(), cfg)
        window = torch.from_numpy(hann_window(cfg.n_fft, np.float64)).to(y.device)
        spec = torch.fft.rfft(yp64.unfold(-1, cfg.n_fft, cfg.hop_size) * window, dim=-1)
        fb = torch.from_numpy(logmel._tables(cfg)[1]).to(y.device).double()
        exact = torch.log(torch.clamp(spec.abs() ** 2 @ fb, min=logmel.LOG_CLIP)).transpose(1, 2)
    k_exact = (got.double() - exact).abs().max().item()
    p_exact = (want.double() - exact).abs().max().item()
    yk, yp = y.clone().requires_grad_(), y.clone().requires_grad_()
    (gk,) = torch.autograd.grad(torch.sin(logmel.fused_log_mel(yk, cfg)).sum(), yk)
    (gp,) = torch.autograd.grad(torch.sin(logmel.fused_log_mel_reference(yp, cfg)).sum(), yp)
    # the same backward with the exact forward's cotangent: the plain version's own floor
    yx = y.clone().requires_grad_()
    (gx,) = torch.autograd.grad(logmel.fused_log_mel_reference(yx, cfg), yx,
                                torch.cos(exact).float())
    g_err = (gk - gp).abs().max().item()
    gk_exact, gp_exact = (gk - gx).abs().max().item(), (gp - gx).abs().max().item()
    g_tol = FP32_TOL * gp.abs().max().item()
    check(g_err <= g_tol or gk_exact <= g_tol + gp_exact,
          f"log-mel {name}: gradient error {g_err} > {FP32_TOL} * {gp.abs().max().item()}, and "
          f"from the exact forward's gradient {gk_exact} > that + the plain version's {gp_exact}")
    with torch.no_grad():
        k_ms = time_ms(lambda: logmel.fused_log_mel(y, cfg), 10)
        p_ms = time_ms(lambda: logmel.fused_log_mel_reference(y, cfg), 10)
        l_ms = time_ms(lambda: log_mel_spectrogram(y, auto), 10)
    cost = logmel_cost(y.shape[0], got.shape[2], y.shape[1], cfg)
    bnd, by = bound_ms(cost["flop"], cost["bytes"], H100_FP32_FLOPS)
    dense_bnd, dense_by = bound_ms(cost["dense_flop"], cost["dense_bytes"], H100_FP32_FLOPS)
    route, length, block_frames = logmel.plan(cfg)
    how = {"fft": f"FFT route, passes {logmel.fft_passes(length)}, {block_frames} frames a block",
           "bluestein": (f"Bluestein route at {length} points, passes {logmel.fft_passes(length)}, "
                         f"{block_frames} frames a block"),
           "dense": "dense route"}[route]
    print(f"log-mel {name} ({got.shape[2]} frames, n_fft {cfg.n_fft}, hop {cfg.hop_size}, "
          f"{cfg.sampling_rate} Hz, {how}): max_abs_err {diff.max().item():.3e} ({ratio:.3f} of "
          f"its limit at worst; from a float64 rfft: kernel {k_exact:.3e}, plain {p_exact:.3e}), "
          f"gradient "
          f"max_abs_err {g_err:.3e} (peak {gp.abs().max().item():.3e}, "
          f"{g_err / g_tol:.3f} of FP32_TOL of it; from the gradient with the float64 forward's "
          f"cotangent: kernel {gk_exact:.3e}, plain {gp_exact:.3e}); kernel {k_ms:.4f} ms plain "
          f"{p_ms:.4f} ms cuFFT (method='auto') {l_ms:.4f} ms (kernel / cuFFT "
          f"{k_ms / l_ms:.3f}); bound {bnd:.4f} ms ({by}; FFT "
          f"count {cost['flop'] / 1e9:.4f} GFLOP with the filterbank's {cost['nnz']} nonzeros, "
          f"{cost['bytes'] / 1e6:.3f} MB); the dense-DFT algorithm's own bound "
          f"{dense_bnd:.4f} ms ({dense_by}; {cost['dense_flop'] / 1e9:.2f} GFLOP)")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bnd, "bound_by": by,
            "dense_dft_bound_ms": dense_bnd, "route": route, "length": length,
            "frames_a_block": block_frames, "err": diff.max().item(),
            "grad_err": g_err, "grad_err_from_float64": gk_exact,
            "plain_grad_err_from_float64": gp_exact, "err_from_float64": k_exact,
            "plain_err_from_float64": p_exact}


# Phase 13's geometries beside V1's (n_fft = 4 hop, 80 mels): name, n_fft,
# sampling rate (None: the config's), route, frames a block, what it runs
MEL_GEOMETRIES = (
    ("mixed_radix", 1200, None, "fft", 8, "the FFT route's radix-5, 5, 3, 4, 4 passes"),
    ("radix_11", 1100, None, "fft", 8, "the FFT route's radix-11, 5, 5, 4 passes"),
    ("radix_7", 1764, 44100, "fft", 4,
     "the FFT route's radix-7, 7, 3, 3, 4 passes (a 10 ms hop at 44.1 kHz), 4 frames a block"),
    ("bluestein", 1028, None, "bluestein", 4,
     "the Bluestein route (hop 257, a prime) at 2160 points, passes 5, 3, 3, 3, 4, 4, 4 frames "
     "a block"),
    ("two_frames", 4096, None, "fft", 2, "the FFT route's six radix-4 passes, 2 frames a block"),
    ("dense", 6404, None, "dense", 0,
     "the dense-DFT route (hop 1601, a prime: Bluestein's buffers overflow shared memory)"),
)


def logmel_phase(h, dev) -> dict:
    """Phase 13: the fused log-mel kernel through mel extraction
    (``log_mel_spectrogram(y, MelConfig.from_hparams(h, method='pallas'))``)
    at the V1 geometry (the FFT route), with the counts set to 0 just before
    and read just after, each batch held by :func:`hold_log_mel`; then each
    geometry of MEL_GEOMETRIES on 16 x 10 s at its sampling rate, its route
    and frames a block checked against the plan, its launches counted per
    route just around its extraction, held the same way."""
    import dataclasses

    from hifigan_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
    from hifigan_tpu_torch.ops import logmel

    cfg = MelConfig.from_hparams(h, method="pallas")
    auto = MelConfig.from_hparams(h)
    sr = h["sampling_rate"]
    lengths = {"16 x 10 s": 10 * sr, "16 x 8192": SEGMENT, "16 x 8192+113": SEGMENT + 113}
    ys = {name: torch.from_numpy(synthetic_audio(16, t, sr, SEED + 60 + i)).to(dev)
          for i, (name, t) in enumerate(lengths.items())}
    zero = dict.fromkeys(logmel.BODY_LAUNCHES, 0)
    logmel.LAUNCHES = 0
    logmel.BODY_LAUNCHES.update(zero)
    outs = {name: log_mel_spectrogram(y, cfg) for name, y in ys.items()}
    torch.cuda.synchronize()
    launches = logmel.LAUNCHES
    check(launches == len(ys) and logmel.BODY_LAUNCHES == dict(zero, fft=len(ys)),
          f"mel extraction launched the log-mel kernel {launches} times "
          f"({logmel.BODY_LAUNCHES}), expected {len(ys)}, all on the FFT route")
    rows = {name: hold_log_mel(name, y, outs[name], cfg, auto) for name, y in ys.items()}
    route_launches = {}
    for i, (key, n_fft, rate, route, frames, _) in enumerate(MEL_GEOMETRIES):
        geometry = dict(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4,
                        sampling_rate=rate or sr)
        other = dataclasses.replace(cfg, **geometry)
        name = (f"16 x 10 s, n_fft {n_fft}" if rate is None
                else f"16 x 10 s at {rate / 1000:g} kHz, n_fft {n_fft}")
        y = (ys["16 x 10 s"] if rate is None else torch.from_numpy(
            synthetic_audio(16, 10 * rate, rate, SEED + 70 + i)).to(dev))
        check(logmel.supports_fused_log_mel(other), f"{other} should be admitted")
        check(logmel.plan(other).route == route and logmel.plan(other).frames == frames,
              f"{name}: plan {logmel.plan(other)}, expected the {route} route at {frames} frames")
        logmel.BODY_LAUNCHES.update(zero)
        with torch.no_grad():
            got = log_mel_spectrogram(y, other)
        torch.cuda.synchronize()
        took = dict(logmel.BODY_LAUNCHES)
        check(took == dict(zero, **{route: 1}),
              f"{name}: launches per route {took}, expected one on the {route} route")
        route_launches[key] = took[route]
        rows[name] = hold_log_mel(name, y, got, other, dataclasses.replace(auto, **geometry))
        rows[name]["key"] = key
    return {"launches": launches, "route_launches": route_launches,
            "err": max(r["err"] for r in rows.values()),
            "grad_err": max(r["grad_err"] for r in rows.values()), "rows": rows}


def per_layer_and_mel_entries(per_layer: dict, train_b5: dict, distill_b5: dict,
                              mel: dict) -> list:
    """The ``kernels`` line's entries of the per-layer conv and log-mel kernels."""
    kernels = []
    for kind, line in (("fwd", 96), ("bwd_dx", 165)):
        rows = per_layer["rows"]
        n = [msd_passes(r["layer"])[kind] for r in rows]
        flop = sum(c * r["cost"]["flop"] for c, r in zip(n, rows))
        nbytes = sum(c * r["cost"][kind] for c, r in zip(n, rows))
        bnd, by = bound_ms(flop, nbytes, FP32_MMA_FLOPS)
        entry = {
            "name": f"msd_conv1d_lrelu.{kind}",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/msd_conv.cu",
            "replaces": f"hifigan_tpu/ops/pallas/msd_conv.py:{line}",
            "launches": train_b5["launches"][kind] + distill_b5["msd_launches"][kind],
            "launches_per_step": {"v1_train": train_b5["per_step"][kind],
                                  "distill": distill_b5["msd_per_step"][kind]},
            "max_abs_err": per_layer["errs"][torch.float32][kind],
            "max_abs_err_bf16": per_layer["errs"][torch.bfloat16][kind],
        }
        for key in ("ms", "plain_ms", "library_ms"):
            entry[key] = sum(c * r[key][kind] for c, r in zip(n, rows))
        entry.update(bound_ms=bnd, bound_by=by, redesigned=(
            "the conv stack's implicit-GEMM core (csrc/conv_core.cuh) with a dilation: mma.sync "
            "tensor cores, 3xTF32 in fp32 and bf16 mma in bf16, dz formed once before dx; one "
            "input or output channel on the SIMT path"), per=(
            f"launches: the main path's runs of {TRAIN_STEPS} V1 train steps with "
            f"msd_conv_impl='pallas' and {DISTILL_STEPS} distill steps with conv_impl='pallas'; "
            "times and bound: one V1 train step (B=16, 8192 samples, fp32; 4 forward passes of "
            "each MSD conv, 3 dx passes, 1 for conv_0; bound: operations at the 3xTF32 rate), "
            "from CUDA-event times of one pass of "
            "each conv at each scale (library: cuDNN F.conv1d + F.leaky_relu, its autograd dx); "
            "max_abs_err: every V1 MSD layer at N=2 and N=16 and every distinct distill conv "
            "call (function :191)"))
        kernels.append(entry)
    ext = mel["rows"]["16 x 10 s"]
    kernels.append({
        "name": "fused_log_mel",
        "route": "cuda",
        "source": "hifigan_tpu_torch/csrc/logmel.cu",
        "redesigned": ("a mixed-radix (2, 3, 4, 5, 7, 11, 13) Stockham FFT per pair of frames in "
                       "shared memory, Bluestein for any other n_fft, 8, 4 or 2 frames a block "
                       "as shared memory allows, and a sparse filterbank; the dense DFT only "
                       "beyond that budget"),
        "replaces": "hifigan_tpu/ops/pallas/logmel.py:135",
        "launches": mel["launches"],
        "launches_per_step": None,
        "max_abs_err": mel["err"],
        "max_abs_err_bf16": None,
        "ms": ext["ms"], "plain_ms": ext["plain_ms"], "bound_ms": ext["bound_ms"],
        "bound_by": ext["bound_by"], "library_ms": ext["library_ms"],
        "per": ("launches: the main path's mel extraction of three batches (16 x 10 s, "
                "16 x 8192, 16 x 8305 samples at 22,050 Hz), all on the FFT route; times and "
                "bound: the 16 x 10 s batch, fp32 (library: method='auto', torch.fft.rfft; "
                "bound: the work a log-mel needs, a real FFT per frame and the filterbank's "
                "nonzeros, while rows.dense_dft_bound_ms bounds the dense-DFT algorithm only); "
                "max_abs_err: the three batches and every geometry of the rows (fp32 only: the "
                "op takes fp32); its backward is the plain composition"),
        "rows": mel["rows"],
    })
    for key, n_fft, rate, route, frames, what in MEL_GEOMETRIES:
        row = next(r for r in mel["rows"].values() if r.get("key") == key)
        kernels.append({
            "name": f"fused_log_mel.{key}",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/logmel.cu",
            "replaces": "hifigan_tpu/ops/pallas/logmel.py:135",
            "launches": mel["route_launches"][key],
            "launches_per_step": None,
            "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "per": (f"n_fft {n_fft}, hop {n_fft // 4}, 80 mels at {rate or 22050} Hz: {what}; "
                    f"launches: the mel extraction of a 16 x 10 s batch at this geometry, "
                    f"counted on the {route} route; times, bound (the work a log-mel needs) "
                    "and max_abs_err: that batch, fp32 (library: method='auto', "
                    "torch.fft.rfft)"),
        })
    return kernels


def fp32_tail_entries(mrf: dict, pre: dict, serve32: dict, stream: dict, pre_errs: dict) -> list:
    """The ``kernels`` line's entries of the MRF-stage kernel's fp32 body
    and of its upsampling phase in fp32."""
    redesigned = ("3xTF32 on the tensor cores through the conv core (csrc/conv_core.cuh), each "
                  "ring stage's sum promoted with IEEE adds, in the bf16 body's schedule: one "
                  "cooperative launch per stage, conv by conv over the whole sequence")
    r = mrf["per_batch_fp32"][1]
    bnd, by = bound_ms(r["ops"], r["bytes"], FP32_MMA_FLOPS)
    entries = [{
        "name": "fused_tail_stage.fp32",
        "route": "cuda",
        "source": "hifigan_tpu_torch/csrc/resblock_tail.cu",
        "replaces": "hifigan_tpu/ops/pallas/resblock_tail.py:152",
        "launches": serve32["launches"][""],
        "launches_per_request": serve32["per_request"][""],
        "max_abs_err": mrf["errs"][torch.float32],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bnd, "bound_by": by,
        "library_ms": r["library_ms"],
        "per_batch": {str(b): {k: v[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                      for b, v in mrf["per_batch_fp32"].items()},
        "serve_ms": serve32["ms"][""],
        "serve_err": serve32["err"],
        "stream_ms_per_chunk": stream["fp32_ms_per_chunk"],
        "stream_launches": stream["fp32_launches"],
        "redesigned": redesigned,
        "per": ("launches: make_fast_vocoder(dtype=torch.float32)'s run of two requests (B=1 "
                "and B=16); times and bound: one V1 B=1 256-frame request, 4 stage calls, fp32 "
                "(library: the cuDNN conv chain, TF32 off; bound: operations at the 3xTF32 "
                "rate); max_abs_err: every V1 stage at B=1, 4, 16; stream: the fp32 stateful "
                "streamer, ms a chunk and its launches"),
    }]
    r = pre["per_batch_fp32"][1]
    bnd, by = bound_ms(r["ops"], r["bytes"], FP32_MMA_FLOPS)
    entries.append({
        "name": "fused_tail_stage.pre_phase_fp32",
        "route": "cuda",
        "source": "hifigan_tpu_torch/csrc/resblock_tail.cu",
        "replaces": "hifigan_tpu/ops/pallas/resblock_tail.py:124",
        "launches": serve32["launches"][" fold_up"],
        "launches_per_request": serve32["per_request"][" fold_up"],
        "max_abs_err": pre_errs[torch.float32],
        "ms": r["ms"], "ms_without_pre": r["ms_without_pre"], "plain_ms": r["plain_ms"],
        "bound_ms": bnd, "bound_by": by, "library_ms": r["library_ms"],
        "serve_ms": serve32["ms"][" fold_up"],
        "redesigned": redesigned + "; the upsampler split by output phase, one more phase",
        "per": ("launches: make_fast_vocoder(dtype=torch.float32, fold_up=True)'s run of two "
                "requests (B=1 and B=16); times and bound: V1 stages 2 and 3 with the "
                "upsampler folded (pre_pack) at B=1, fp32, ms_without_pre the same kernel on "
                "the upsampled input (library: the cuDNN chain with the transposed convs; "
                "bound: operations at the 3xTF32 rate); max_abs_err: V1 stages 2-3 at B=1, 4, 16 "
                "and a ragged T_in"),
    })
    return entries


# ---------------------------------------------------------------------------
# phases 14-16: the autoencoder's serving path, training through the
# stream-fusion pass, the eval and sniffer steps
# ---------------------------------------------------------------------------

AUTOENCODE_SECONDS = 10  # each served clip, at the config's 16 kHz
AUTOENCODE_CLIPS = 3
AUTOENCODE_REPS = 5  # timed autoencodes of each path, in turn
STREAM_RUNS_SHIPPED = 6  # fused runs an autoencode of configs/distill.json (3 + 3)
PCM_STEP = 1.0 / 32767  # the int16 wav's quantisation step


def generator_runs(models, wav: torch.Tensor) -> tuple[list, list]:
    """The fused runs of one autoencode: (encoder's, decoder's), each
    [(entry value, run, atoms)]."""
    from hifigan_tpu_torch.dsl import stream_fusion as sf

    enc, dec = [], []
    with torch.no_grad():
        emb, _ = sf.eval_stream_fused(models.encoder, models.encoder.config, wav, "m", enc)
        sf.eval_stream_fused(models.decoder, models.decoder.config, emb, "m", dec)
    return enc, dec


def describe_run(run) -> str:
    ops = []
    for op in run.ops:
        kinds = "+".join(f"{k}{p[0] if k in ('pool', 'repl') else ''}" for _s, k, p in op.srcs)
        text = (kinds or "act") + (" +res" if op.res_from is not None else "")
        ops.append(text + (f" ->{op.act}" if op.act != "none" else ""))
    return f"c {run.entry_c}: " + ", ".join(ops) + f" ({run.n_convs} convs)"


def hold_segment(sg, seg, ins, tabs, bs, tag: str, gen, errs: dict, backward: bool) -> list:
    """One segment (members 1, fp32) on the card against its plain version:
    every level; with ``backward``, dx, dW and db for every input, table and
    bias, against the plain backward over the kernel's own outputs. Returns
    the forward's outputs."""

    def held(what, got, want, kind):
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{tag} {what}: {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
        check(err <= FP32_TOL * max(peak, 1e-30),
              f"{tag} {what}: error {err} > {FP32_TOL} * {peak}")
        errs[kind] = max(errs[kind], err)

    with torch.no_grad():
        ys = sg.fused_stream_graph(seg, ins, tabs, bs)
        plain = sg.fused_stream_graph_reference(seg, ins, tabs, bs)
    for li, (yk, yp) in enumerate(zip(ys, plain)):
        held(f"level {li}", yk, yp, "fwd")
    if not backward:
        return ys
    dys = [torch.randn(y.shape, device=y.device, generator=gen) * 0.01 for y in ys]
    xs = [x.clone().requires_grad_() for x in ins]
    tt = [t.clone().requires_grad_(t.requires_grad) for t in tabs]
    bb = [None if b is None else b.clone().requires_grad_() for b in bs]
    outs = sg.fused_stream_graph(seg, xs, tt, bb)
    wrt = xs + [t for t in tt if t.requires_grad] + [b for b in bb if b is not None]
    got = list(torch.autograd.grad(outs, wrt, dys))
    dxs, dws, dbs = sg.fused_stream_graph_backward_reference(
        seg, ins, [o.detach() for o in outs], dys, tabs, 1, dx_mask=[True] * len(xs),
        dw_mask=[t.requires_grad for t in tt], db_mask=[b is not None for b in bs])
    for i in range(len(xs)):
        held(f"dx{i}", got.pop(0), dxs[i], "bwd_dx")
    for i, t in enumerate(tt):
        if t.requires_grad:
            held(f"dW{i}", got.pop(0), dws[i], "bwd_dw")
    for gb, rb in zip(got, [d for d, b in zip(dbs, bs) if b is not None]):
        held("db", gb, rb, "bwd_dw")
    return ys


def generator_segments(models, wav: torch.Tensor, grad: bool) -> list:
    """Every stream-graph call of one encoder + decoder pass (the fused
    runs): (segment, inputs, tables, biases), tables keeping whether they
    take a gradient (conv weights do, constant tables do not)."""
    from hifigan_tpu_torch.dsl import fused_member as fm

    rec, real = [], fm.fused_stream_graph

    def spy(seg, inputs, tables, biases, members=1, weight_grads=True):
        rec.append((seg, [x.detach() for x in inputs],
                    [t.detach().contiguous().requires_grad_(grad and t.requires_grad)
                     for t in tables],
                    [None if b is None else b.detach().float().contiguous() for b in biases]))
        return real(seg, inputs, tables, biases, members=members, weight_grads=weight_grads)

    fm.fused_stream_graph = spy
    try:
        with torch.set_grad_enabled(grad):
            models.decoder(models.encoder(wav))
    finally:
        fm.fused_stream_graph = real
    return rec


def hold_generator_backward(models, batch: dict) -> dict:
    """Phase 15: every fused run's segment of one encoder + decoder pass at
    the step's batch, forward, dx and dW + db on the card against the plain
    versions (fp32), and each pass's kernel and plain times."""
    from hifigan_tpu_torch.ops import stream_graph as sg

    dev = models.device
    wav = torch.from_numpy(batch["audio"]).to(dev)[:, :, None]
    segs = generator_segments(models, wav, grad=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    errs = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    rows = []
    for si, (seg, ins, tabs, bs) in enumerate(segs):
        tag = f"stream-fusion segment {si} ({len(seg.ops)} ops, B={ins[0].shape[0]})"
        ys = hold_segment(sg, seg, ins, tabs, bs, tag, gen, errs, backward=True)
        dys = [torch.randn(y.shape, device=dev, generator=gen) * 0.01 for y in ys]
        # dW as the step runs it: the conv tables only (the constant ones take no grad)
        trained = [t.requires_grad for t in tabs]
        row = time_segment(sg, seg, ins, [t.detach() for t in tabs], bs, 1, dys, trained)
        row["cost"] = segment_cost(seg, tabs, bs, ins[0].shape[0], 1, 4, trained)
        rows.append(row)
    enc, dec = generator_runs(models, wav)
    lib = {k: a + b for (k, a), b in zip(interp_chain_grad_ms(models.encoder, enc, 3).items(),
                                         interp_chain_grad_ms(models.decoder, dec, 3).values())}
    print(f"stream-fusion segments of one encoder + decoder pass at B={wav.shape[0]} x "
          f"{wav.shape[1]}: {len(segs)} held (every level, dx, dW, db within {FP32_TOL} of the "
          f"peak; errors {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}); "
          + "; ".join(f"{k} kernel {sum(r['ms'][k] for r in rows):.3f} ms plain "
                      f"{sum(r['plain_ms'][k] for r in rows):.3f} ms, the interpreter's cuDNN "
                      f"chain {lib[k]:.3f} ms" for k in ("fwd", "bwd_dx", "bwd_dw")))
    return {"errs": errs, "rows": rows, "n": len(segs), "library_ms": lib}


def interp_chain_grad_ms(module, runs: list, reps: int) -> dict:
    """The interpreter's per-node chain over the same runs (cuDNN convs),
    CUDA events: forward, dx (parameters frozen) and dW (the backward with
    the parameters' gradients, minus dx)."""
    xs = [x.detach().clone().requires_grad_() for x, _run, _atoms in runs]

    def outs():
        res = []
        for x, (_x, _run, atoms) in zip(xs, runs):
            val = x
            for cfg, path in atoms:
                val, _ = module._eval(cfg, (val,), path)
            res.append(val)
        return res

    with torch.no_grad():
        fwd = time_ms(outs, reps)
    module.requires_grad_(False)
    ys = outs()
    cot = [torch.ones_like(y) for y in ys]
    dx = time_ms(lambda: torch.autograd.grad(ys, xs, cot, retain_graph=True), reps)
    module.requires_grad_(True)
    ys = outs()
    wrt = xs + list(module.parameters())
    full = time_ms(lambda: torch.autograd.grad(ys, wrt, cot, retain_graph=True, allow_unused=True),
                   reps)
    return {"fwd": fwd, "bwd_dx": dx, "bwd_dw": full - dx}


def interp_chain_ms(module, runs: list, reps: int) -> tuple[float, float]:
    """The interpreter's cuDNN chain over the same runs (each run's atoms
    from its entry value, node by node): (CUDA-event ms, host ms)."""

    def chain():
        for x, _run, atoms in runs:
            val = x
            for cfg, path in atoms:
                val, _ = module._eval(cfg, (val,), path)

    with torch.no_grad():
        return time_ms(chain, reps), host_ms(chain, reps)


def autoencode_phase(config: dict, dev) -> dict:
    """Phase 14: the distillation autoencoder served on the card through its
    CLI from an experiment directory the port writes, with
    ``models.stream_impl`` 'fused' and 'auto'; then in process the runs,
    each new segment against its plain version, launches and times."""
    from hifigan_tpu_torch.audio import load_wav, save_wav
    from hifigan_tpu_torch.cli import infer_autoencoding as cli
    from hifigan_tpu_torch.dsl import fused_member as fm
    from hifigan_tpu_torch.dsl import stream_fusion as sf
    from hifigan_tpu_torch.ops import stream_graph as sg
    from hifigan_tpu_torch.train.checkpoint import dsl_variables_to_jax
    from hifigan_tpu_torch.train.msgpack import msgpack_serialize
    from hifigan_tpu_torch.utils.caching import dump_yaml

    sr = config["sampling_rate"]
    n_samples = AUTOENCODE_SECONDS * sr
    base = distill_models(config, torch.device("cpu"))
    seg = base.embedding_size
    trimmed = (n_samples // seg) * seg
    gen = torch.Generator().manual_seed(SEED + 60)
    probe = torch.zeros((1, seg, 1))
    base.encoder.build(probe, generator=gen)
    with torch.no_grad():
        base.decoder.build(base.encoder(probe), generator=gen)
    variables = {"encoder": dsl_variables_to_jax(base.encoder.state_dict()),
                 "decoder": dsl_variables_to_jax(base.decoder.state_dict())}
    n_params = sum(p.numel() for m in (base.encoder, base.decoder) for p in m.parameters())
    del base
    clips = synthetic_audio(AUTOENCODE_CLIPS, n_samples, sr, SEED + 61)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "wavs").mkdir()
        for i, clip in enumerate(clips):
            save_wav(str(tmp / "wavs" / f"clip{i}.wav"), clip, sr)
        blob = msgpack_serialize({"step": 0, "variables": variables})
        files = {}
        for impl in ("fused", "auto"):
            exp = tmp / f"exp_{impl}"
            (exp / "checkpoints").mkdir(parents=True)
            cfg = copy.deepcopy(config)
            cfg["models"]["stream_impl"] = impl
            (exp / "config.yaml").write_text(dump_yaml(cfg))
            (exp / "checkpoints" / "latest").write_bytes(blob)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "hifigan_tpu_torch.cli.infer_autoencoding",
                 "--experiment_dir", str(exp), "--input_wavs_dir", str(tmp / "wavs"),
                 "--output_dir", str(tmp / f"out_{impl}"), "--device", dev.type],
                cwd=REPO, capture_output=True, text=True, timeout=600,
                env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))  # fp32 in cuDNN too
            check(proc.returncode == 0, f"infer_autoencoding ({impl}) exit {proc.returncode}:\n"
                                        f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            names = sorted(os.listdir(tmp / f"out_{impl}"))
            check(names == [f"clip{i}_autoencoded.wav" for i in range(AUTOENCODE_CLIPS)],
                  f"infer_autoencoding ({impl}) wrote {names}")
            files[impl] = []
            for name in names:
                data, out_sr = load_wav(str(tmp / f"out_{impl}" / name))
                check(out_sr == sr and data.shape == (1, trimmed),
                      f"{impl} {name}: {data.shape} @ {out_sr}, expected (1, {trimmed}) @ {sr}")
                check(bool(np.isfinite(data).all()) and float(np.abs(data).max()) <= 1.0
                      and float(np.abs(data).max()) > 0, f"{impl} {name}: silent or out of range")
                files[impl].append(data)
            said = proc.stdout.strip().splitlines()
            print(f"cli infer_autoencoding stream_impl={impl!r}: {len(names)} wavs of {trimmed} "
                  f"samples @ {sr} Hz in {time.perf_counter() - t0:.3f} s (process included); "
                  f"{said[1] if len(said) > 1 else ''}")
        for i, (a, b) in enumerate(zip(files["fused"], files["auto"])):
            peak = float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            tol = FP32_TOL * peak + PCM_STEP
            print(f"cli clip {i}: fused vs auto max_abs_err {err:.3e} (tol {tol:.3e}: "
                  f"{FP32_TOL} of the peak {peak:.4f} plus one int16 step)")
            check(err <= tol, f"cli clip {i}: fused vs auto {err} > {tol}")
        fused, _ = cli.load_autoencoder(str(tmp / "exp_fused"), dev)
        plain, _ = cli.load_autoencoder(str(tmp / "exp_auto"), dev)
    check(fused.encoder.stream_impl == "fused" and plain.encoder.stream_impl == "auto",
          "the experiment configs' stream_impl did not reach the encoder")

    # the main path's run: every clip autoencoded as the CLI does, counted
    sg.reset_launches()
    outs = [cli.autoencode(fused, clip) for clip in clips]
    torch.cuda.synchronize()
    launches = sg.launches()
    refs = [cli.autoencode(plain, clip) for clip in clips]
    for i, (a, b) in enumerate(zip(outs, refs)):
        err, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
        check(a.shape == (trimmed,) and bool(np.isfinite(a).all()), f"clip {i}: {a.shape}")
        check(err <= FP32_TOL * peak, f"clip {i}: fused vs auto {err} > {FP32_TOL} * {peak}")
        out.setdefault("errs_out", []).append(err)
    x1 = torch.from_numpy(clips[:1, :trimmed]).to(dev)[:, :, None]
    enc, dec = generator_runs(fused, x1)
    derived = len(enc) + len(dec)
    for model, runs in (("encoder", enc), ("decoder", dec)):
        for i, (x, run, _atoms) in enumerate(runs):
            print(f"stream-fusion {model} run {i}: entry {tuple(x.shape)}, {describe_run(run)}")
    check(derived == STREAM_RUNS_SHIPPED,
          f"{derived} fused runs an autoencode, {STREAM_RUNS_SHIPPED} expected")
    want = {"fwd": derived * AUTOENCODE_CLIPS, "bwd_dx": 0, "bwd_dw": 0}
    check(launches == want, f"stream-graph launches over {AUTOENCODE_CLIPS} autoencodes "
                            f"{launches}, derived {want}")
    print(f"autoencode: {AUTOENCODE_CLIPS} clips of {trimmed} samples through cli.autoencode, "
          f"stream-graph launches {launches} ({derived} a clip, derived from the runs); "
          f"encoder + decoder {n_params / 1e6:.3f} M parameters; fused vs auto max_abs_err "
          f"{max(out['errs_out']):.3e}")

    errs = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    gen_d = torch.Generator(device=dev).manual_seed(SEED + 62)
    per_batch = {}
    for b in (1, AUTOENCODE_CLIPS):
        x = torch.from_numpy(clips[:b, :trimmed]).to(dev)[:, :, None]
        segs = generator_segments(fused, x, grad=False)
        check(len(segs) == derived, f"B={b}: {len(segs)} segments, {derived} runs")
        kern = plain_ms = 0.0
        costs = []
        for si, (seg_, ins, tabs, bs) in enumerate(segs):
            hold_segment(sg, seg_, ins, tabs, bs, f"autoencode B={b} segment {si}", gen_d, errs,
                         backward=False)
            with torch.no_grad():
                kern += time_ms(lambda: sg.fused_stream_graph(seg_, ins, tabs, bs), AUTOENCODE_REPS)
                plain_ms += time_ms(lambda: sg.fused_stream_graph_reference(seg_, ins, tabs, bs),
                                    AUTOENCODE_REPS)
            costs.append(segment_cost(seg_, tabs, bs, b, 1, 4, [False] * len(tabs)))
        bound, bound_by = segment_bound(costs, "fwd")
        flop = sum(c["ops"]["fwd"] for c in costs)
        enc_r, dec_r = generator_runs(fused, x)
        chains = [interp_chain_ms(plain.encoder, enc_r, AUTOENCODE_REPS),
                  interp_chain_ms(plain.decoder, dec_r, AUTOENCODE_REPS)]
        lib, lib_host = (sum(c[i] for c in chains) for i in (0, 1))
        times = {"fused": [], "auto": []}
        enqueue = {"fused": [], "auto": []}
        with torch.no_grad():
            for _ in range(AUTOENCODE_REPS):
                for impl, m in (("fused", fused), ("auto", plain)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m.decoder(m.encoder(x))
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    times[impl].append((time.perf_counter() - t0) * 1e3)
                    enqueue[impl].append((t1 - t0) * 1e3)
            # where the fused autoencode's host time goes
            clock = host_clock({"runs": (sf, "run_fused"), "b3": (fm, "fused_stream_graph")})
            with clock:
                for _ in range(AUTOENCODE_REPS):
                    torch.cuda.synchronize()
                    fused.decoder(fused.encoder(x))
            torch.cuda.synchronize()
        ms = {k: float(np.median(v)) for k, v in times.items()}
        host = {k: float(np.median(v)) for k, v in enqueue.items()}
        runs_host, b3_host = (clock.s[k] * 1e3 / AUTOENCODE_REPS for k in ("runs", "b3"))
        audio_s = b * trimmed / sr
        per_batch[b] = {"ms": kern, "plain_ms": plain_ms, "library_ms": lib, "bound_ms": bound,
                        "bound_by": bound_by, "flop": flop, "autoencode_ms": ms,
                        "host_ms": {"autoencode": host, "fused_runs": runs_host,
                                    "fused_b3_wrapper": b3_host, "interpreter_chain": lib_host}}
        print(f"autoencode B={b} x {trimmed}: {ms['fused'] / b:.3f} ms a clip with "
              f"stream_impl='fused' ({audio_s / (ms['fused'] / 1e3):.1f}x real time), "
              f"{ms['auto'] / b:.3f} with 'auto' ({audio_s / (ms['auto'] / 1e3):.1f}x), "
              f"median of {AUTOENCODE_REPS} in turn; the {derived} stream-graph segments: kernel "
              f"{kern:.3f} ms, plain {plain_ms:.3f} ms, the interpreter's cuDNN chain over the "
              f"same runs {lib:.3f} ms, {flop / 1e9:.3f} GFLOP, bound {bound:.4f} ms ({bound_by})")
        print(f"autoencode B={b} host: {host['fused']:.3f} ms to enqueue an autoencode fused, "
              f"{host['auto']:.3f} auto (median of {AUTOENCODE_REPS}, the card idle at the "
              f"start); fused, its {derived} runs {runs_host:.3f} ms of it (the stream-graph "
              f"wrapper and launch {b3_host:.3f}, the rest the lowering, weight norms and "
              f"tables); the interpreter's chain over the same atoms {lib_host:.3f} ms")
    print(f"autoencode segments held against the plain version (every level within "
          f"{FP32_TOL} of the peak): max_abs_err {errs['fwd']:.3e}")
    del fused, plain
    return {"launches": launches["fwd"], "per_autoencode": derived, "errs": errs,
            "per_batch": per_batch, "n_params": n_params}


def eval_sniffer_phase(run: dict, config: dict, dev) -> dict:
    """Phase 16: one validation eval step at (3, 109,200) with stream_impl
    'fused' and again 'auto' on the same state; two sniffer train steps and
    an eval step on the card."""
    from hifigan_tpu_torch.distill.sniffer import (
        LabelBiasSnifferTrainer,
        generate_sniffers_by_example,
    )
    from hifigan_tpu_torch.distill.train import DistillTrainer
    from hifigan_tpu_torch.dsl.parsing import parse_layers

    state = run["state"]
    models = state.models
    cfg = copy.deepcopy(config)
    cfg["models"]["stream_impl"] = "fused"
    trainer = DistillTrainer(models, cfg, loop_type="validation")
    bsz, seg_len = trainer.batch_size, trainer.segment_length
    t_emb = seg_len // models.embedding_size
    rng = np.random.default_rng(SEED + 80)
    batch = {"audio": synthetic_audio(bsz, seg_len, cfg["sampling_rate"], SEED + 81),
             "time_labels": {g: {k: rng.integers(0, len(v), (bsz, t_emb))
                                 for k, v in group.items()} for g, group in DISTILL_LABELS.items()}}
    eval_step = trainer.make_eval_step()
    bufs = {k: v.clone() for k, v in models.discriminator.named_buffers()}
    results = {}
    for impl in ("fused", "auto"):
        models.encoder.stream_impl = models.decoder.stream_impl = impl
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, data = eval_step(state, batch)
        torch.cuda.synchronize()
        results[impl] = (flat_losses(losses), data, (time.perf_counter() - t0) * 1e3)
    models.encoder.stream_impl = models.decoder.stream_impl = "fused"
    live = dict(models.discriminator.named_buffers())
    check(all(torch.equal(v, live[k]) for k, v in bufs.items()),
          "the eval step changed the live discriminator's state")
    (lf, data, ms_f), (la, data_a, ms_a) = results["fused"], results["auto"]
    check(all(np.isfinite(v) for v in lf.values()), "eval step: non-finite losses")
    rel = {k: abs(lf[k] - v) / max(abs(v), 1e-30) for k, v in la.items()}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= DISTILL_REL_TOL, f"eval step fused vs auto: {worst} {rel[worst]}")
    shapes = {"wav": (bsz, seg_len, 1)}
    for k in ("truth", "generated"):
        check(tuple(data["wav"][k].shape) == shapes["wav"], f"eval wav {k}: "
                                                            f"{tuple(data['wav'][k].shape)}")
        check(data["mel"][k].shape == data_a["mel"][k].shape and data["mel"][k].shape[0] == bsz
              and data["mel"][k].shape[1] == cfg["mel"]["num_mels"], f"eval mel {k}")
    leaves = [data["wav"]["generated"], data["mel"]["generated"]]
    for part in ("keep", "sniff", "hunt"):
        check(bool(data["label"][part]), f"eval label {part} is empty")
        for v in data["label"][part].values():
            leaves += list(v.values()) if isinstance(v, dict) else [v]
    check(all(bool(torch.isfinite(v).all()) for v in leaves), "eval step: non-finite data")
    keeps = data["label"]["keep"]
    check(set(keeps) == set(DISTILL_LABELS)
          and all(set(keeps[g]) == set(DISTILL_LABELS[g])
                  and all(tuple(v.shape) == (bsz, t_emb, len(DISTILL_LABELS[g][k]))
                          for k, v in keeps[g].items()) for g in keeps),
          "eval keep tree shapes")
    print(f"eval step B={bsz} x {seg_len}: {ms_f:.3f} ms fused, {ms_a:.3f} ms auto (one call "
          f"each); losses fused vs auto worst relative {rel[worst]:.3e} at {worst} (limit "
          f"{DISTILL_REL_TOL}); wav, mel and label trees finite with their shapes; the live "
          "discriminator's buffers unchanged")

    sniffers = generate_sniffers_by_example(
        DISTILL_LABELS, layers=parse_layers(cfg["models"]["sniffers"]["layers"]))
    st = LabelBiasSnifferTrainer(sniffers["content"], "content")
    s_state = st.create_state(batch["time_labels"]["content"], seed=SEED, device=dev)
    before = [p.detach().clone() for p in s_state.optimizer.params]
    step = st.make_train_step()
    losses = []
    for i in range(2):
        s_state, m = step(s_state, {"time_labels": batch["time_labels"]})
        losses.append(float(m["loss"]))
    ev, preds = st.make_eval_step()(s_state, {"time_labels": batch["time_labels"]})
    check(all(np.isfinite(v) for v in losses) and np.isfinite(float(ev["loss"])),
          f"sniffer losses {losses} {float(ev['loss'])}")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, s_state.optimizer.params))
    check(moved == len(before), f"sniffer: {len(before) - moved} of {len(before)} parameters "
                                "did not move")
    check(set(preds) == {"style"}, f"sniffer predictions {set(preds)}")
    print(f"sniffer (content -> style) on the card: losses {losses}, eval {float(ev['loss']):.6f}; "
          f"all {len(before)} parameters moved")
    return {"eval_ms": ms_f, "eval_auto_ms": ms_a, "rel": rel[worst], "sniffer_losses": losses}



def stream_fusion_entries(auto_enc: dict, distill_sf: dict) -> list:
    """The stream-graph kernels on the stream-fusion route: the forward per
    B=1 autoencode (phase 14), dx and dW + db per encoder + decoder pass of
    a distill step (phase 15)."""
    out = []
    b1 = auto_enc["per_batch"][1]
    rows = distill_sf["segments"]["rows"]
    for kind, line in (("fwd", 388), ("bwd_dx", 600), ("bwd_dw", 600)):
        if kind == "fwd":
            ms, plain, lib = b1["ms"], b1["plain_ms"], b1["library_ms"]
            bound, bound_by = b1["bound_ms"], b1["bound_by"]
            launches, err = auto_enc["launches"], auto_enc["errs"]["fwd"]
            per = (f"launches: the main path's run ({AUTOENCODE_CLIPS} clips of "
                   f"{AUTOENCODE_SECONDS} s autoencoded through cli.autoencode, "
                   f"{auto_enc['per_autoencode']} a clip); times and bound: the "
                   f"{auto_enc['per_autoencode']} segments of one B=1 autoencode, fp32 (library: "
                   "the interpreter's cuDNN chain over the same runs); max_abs_err: every "
                   "segment at B=1 and B=3 (function :786)")
        else:
            ms = sum(r["ms"][kind] for r in rows)
            plain = sum(r["plain_ms"][kind] for r in rows)
            lib = distill_sf["segments"]["library_ms"][kind]
            bound, bound_by = segment_bound([r["cost"] for r in rows], kind)
            launches, err = distill_sf["launches"][kind], distill_sf["segments"]["errs"][kind]
            per = (f"launches: phase 15's run of {DISTILL_STEPS} distill steps with "
                   "stream_impl='fused' (members and runs), launches_per_step: each step's; "
                   f"times and bound: the {len(rows)} run segments of one encoder + decoder "
                   "pass at the step's batch (3 x 43,680), fp32 (library: the interpreter's "
                   "autograd over the same runs, its dW the backward with the parameters "
                   "minus dx); max_abs_err: those segments' dx / dW and db against the plain "
                   "backward over the kernel's outputs")
        out.append({
            "name": f"fused_stream_graph.{kind}.stream_fusion",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/stream_graph.cu",
            "replaces": f"hifigan_tpu/ops/pallas/stream_graph.py:{line}",
            "launches": launches,
            "launches_per_step": distill_sf["per_step"][kind],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": lib,
            "per": per,
        })
    out[0]["per_batch"] = {str(b): r for b, r in auto_enc["per_batch"].items()}
    return out


# ---------------------------------------------------------------------------
# phase 17: distillation training from its entry point on a synthetic corpus
# ---------------------------------------------------------------------------

CORPUS_CLIPS = 16  # clips of CORPUS_SECONDS at 16 kHz: 4 speakers, 2 sexes
CORPUS_SECONDS = 8.0
CORPUS_SPEAKERS = (("spk1", "m"), ("spk2", "f"), ("spk3", "m"), ("spk4", "f"))
MAIN_STEPS = (20, 22)  # distill.main's first run, then its resumed run
# train() in process: step 1 warms up; steps 2-4 each end at the next
# batch's pull, so each of those intervals holds a step and a batch load
TRAIN_IN_PROCESS_STEPS = 5
SNIFFER_STEPS = 4


def write_textgrid(path: Path, duration: float, tiers: dict) -> None:
    """A long-format Praat TextGrid of interval tiers {name: [(lo, hi, text)]}."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0",
             f"xmax = {duration}", "tiers? <exists>", f"size = {len(tiers)}", "item []:"]
    for n, (name, rows) in enumerate(tiers.items(), 1):
        lines += [f"    item [{n}]:", '        class = "IntervalTier"', f'        name = "{name}"',
                  "        xmin = 0", f"        xmax = {duration}",
                  f"        intervals: size = {len(rows)}"]
        for i, (lo, hi, text) in enumerate(rows, 1):
            lines += [f"        intervals [{i}]:", f"            xmin = {lo}",
                      f"            xmax = {hi}", f'            text = "{text}"']
    path.write_text("\n".join(lines))


def write_corpus(root: Path, config: dict, seed: int) -> None:
    """A seeded synthetic corpus under ``root/{data,aug}``: CORPUS_CLIPS clips
    (voiced words between silences) with word and phone TextGrids, train and
    test data configs of the ``tests/test_data_engine.py`` shape, and noise
    and room-impulse assets for every augmentation option of ``config``."""
    from hifigan_tpu_torch.audio import save_wav

    sr = config["sampling_rate"]
    data, aug = root / "data" / "synth", root / "aug"
    for d in ("wavs", "tg", "data_configs/train", "data_configs/test"):
        (data / d).mkdir(parents=True)
    rng = np.random.default_rng(seed)
    n = int(CORPUS_SECONDS * sr)
    t = np.arange(n) / sr
    phones = ("AA", "B", "EH", "K", "IY", "S", "T", "OW")
    for i in range(CORPUS_CLIPS):
        spk, sex = CORPUS_SPEAKERS[i % len(CORPUS_SPEAKERS)]
        f0 = (110.0 if sex == "m" else 200.0) * (1 + 0.1 * rng.random())
        words, phone_rows, at = [(0.0, 0.5, "")], [(0.0, 0.5, "sil")], 0.5
        gate = np.zeros(n)
        while at < CORPUS_SECONDS - 1.0:
            dur = round(float(rng.uniform(0.4, 0.9)), 3)
            words.append((at, at + dur, f"w{int(rng.integers(0, 20))}"))
            cuts = np.linspace(at, at + dur, 4)
            phone_rows += [(round(float(a), 4), round(float(b), 4),
                            phones[int(rng.integers(0, len(phones)))])
                           for a, b in zip(cuts[:-1], cuts[1:])]
            gate[int(at * sr):int((at + dur) * sr)] = 1.0
            gap = round(float(rng.uniform(0.1, 0.3)), 3)
            words.append((at + dur, at + dur + gap, ""))
            phone_rows.append((at + dur, at + dur + gap, "sil"))
            at = round(at + dur + gap, 4)
        words.append((at, CORPUS_SECONDS, ""))
        phone_rows.append((at, CORPUS_SECONDS, "sil"))
        voiced = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3))
        wav = 0.3 * gate * voiced + 0.005 * rng.standard_normal(n)
        name = f"{spk}_u{i:02d}_{sex}"
        save_wav(str(data / "wavs" / f"{name}.wav"), wav.astype(np.float32), sr)
        write_textgrid(data / "tg" / f"{name}.TextGrid", CORPUS_SECONDS,
                       {"words": words, "phones": phone_rows})
    spec = {"name": "synth", "result": "wavs", "config": [{
        "group-name": "wavs",
        "sources": [{"type": "glob", "glob": "**/wavs/*.wav", "label": "path"}],
        "group-labels": {"mic-brand": "blueyeti"},
        "enrichments": [
            {"type": "regex",
             "patterns": {"path": r"(?P<name>(?P<speaker>spk\d)_\w+_(?P<sex>[mf]))\.wav$"}},
            {"type": "files",
             "labels": {"wav": "**/wavs/{name}.wav", "textgrid": "**/tg/{name}.TextGrid"}},
            {"type": "select", "labels": ["wav", "textgrid", "speaker", "sex", "mic-brand"]},
        ]}]}
    (data / "data_configs" / "train" / "synth.json").write_text(json.dumps(spec))
    (data / "data_configs" / "test" / "synth.json").write_text(json.dumps(spec))
    options = config["augmentation"]["options"]
    for kind in options["noise"]:
        d = aug / "libriadapt" / "noise" / "blueyeti" / kind
        d.mkdir(parents=True)
        save_wav(str(d / "n1.wav"), (0.1 * rng.standard_normal(2 * sr)).astype(np.float32), sr)
    for i, room in enumerate(options["rir"]):
        d = aug / "RIRS_NOISES" / "simulated_rirs" / room
        d.mkdir(parents=True)
        m = int(sr * (0.1 + 0.2 * i))
        rir = rng.standard_normal(m) * np.exp(-np.arange(m) / (0.2 * m))
        rir[0] = 1.0
        save_wav(str(d / "r1.wav"), (0.9 * rir / np.abs(rir).max()).astype(np.float32), sr)


def run_module(args: list, what: str, timeout: int = 600) -> str:
    """``python -m ...`` from the checkout; raises on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    tail = "\n".join(proc.stdout.strip().splitlines()[-6:])
    print(f"{what}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; last lines:\n"
          f"{tail}")
    check(proc.returncode == 0, f"{what} failed:\n{proc.stderr[-3000:]}")
    return proc.stdout


def card_environment() -> dict:
    """Which of the engine's optional libraries and host libraries the
    card's machine has. A module is looked up with ``find_spec``, which
    finds it without running it: this process imports none of them."""
    from importlib.util import find_spec

    from hifigan_tpu_torch.data import codecs, native
    from hifigan_tpu_torch.distill.main import summary_writer_class

    imports = {mod: find_spec(mod) is not None
               for mod in ("pandas", "matplotlib", "yaml", "tensorboard", "scipy")}
    imports["SummaryWriter"] = summary_writer_class() is not None
    libs = {"libhost_dsp": native.available(), "gsm0610": native.gsm0610_available(),
            "lame+mpg123": codecs.mp3_available(), "vorbis": codecs.vorbis_available(),
            "libgsm": codecs.libgsm_available()}
    # the path each augmentation takes, as data/augmentation.py chooses it
    paths = {"filters": "libhost_dsp" if libs["libhost_dsp"] else "numpy/scipy",
             "gsm": ("libgsm" if libs["libgsm"] else "gsm0610 (libhost_dsp)"
                     if libs["gsm0610"] else "band limit + mu-law"),
             "mp3": "lame/mpg123" if libs["lame+mpg123"] else "MDCT stand-in",
             "vorbis": "libvorbis" if libs["vorbis"] else "MDCT stand-in"}
    print(f"card imports: {json.dumps(imports)}")
    print(f"card host libraries: {json.dumps(libs)}; augmentation paths: {json.dumps(paths)}")
    return {"imports": imports, "libs": libs, "paths": paths}


def distill_main_phase(config: dict, dev, bare_step_ms: float) -> dict:
    """Phase 17: the distillation trainer's entry point on a seeded corpus."""
    from hifigan_tpu_torch.distill import main as dmain
    from hifigan_tpu_torch.ops import stream_graph as sg
    from hifigan_tpu_torch.train.msgpack import msgpack_restore

    env = card_environment()
    cfg = copy.deepcopy(config)
    cfg["learning"]["accumulated_grad_batches"] = 1
    print("distill.main: configs/distill.json as shipped but accumulated_grad_batches 1 "
          "instead of 100 (a copy written beside the corpus), so the validation and "
          f"continuous-checkpoint interval is 20 steps and {MAIN_STEPS[0]} steps reach it")
    n_blocks = len(cfg["models"]["discriminator"]["layers"]) - 2
    per_step = distill_launches_per_step(n_blocks)
    out = {"env": env}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_corpus(tmp, cfg, SEED + 170)
        print(f"corpus: {CORPUS_CLIPS} clips of {CORPUS_SECONDS} s at {cfg['sampling_rate']} Hz, "
              f"{len(CORPUS_SPEAKERS)} speakers, written in {time.perf_counter() - t0:.2f} s")
        cfg_path = tmp / "distill.json"
        cfg_path.write_text(json.dumps(cfg))
        common = ["--config", str(cfg_path), "--datasets_dir", str(tmp)]
        run_module(["hifigan_tpu_torch.cli.warm_cache", *common, "--iterate", "1"], "warm_cache")
        for loop in cfg["loops"]:
            source = cfg["data"][loop]["dataset"]["source"]
            n = len(list((tmp / "cache" / source / "frame_labels").glob("*.pickle")))
            check(n == CORPUS_CLIPS, f"warm_cache: {n} label pickles for {source}")

        logs = tmp / "logs"
        exp = logs / cfg["experiment"]["name"] / f"version_{cfg['experiment']['version']}"
        main_s = []
        for steps in MAIN_STEPS:
            t0 = time.perf_counter()
            text = run_module(["hifigan_tpu_torch.distill.main", *common, "--logs_base",
                               str(logs), "--max_steps", str(steps), "--device", "cuda"],
                              f"distill.main --max_steps {steps}", timeout=900)
            main_s.append(time.perf_counter() - t0)
            check(f"trained to step {steps}" in text, f"distill.main did not end at {steps}")
            if steps != MAIN_STEPS[0]:
                check(f"at step {MAIN_STEPS[0]}" in text and "Resumed from" in text,
                      f"distill.main --max_steps {steps} did not resume at {MAIN_STEPS[0]}")
        for rel in ("config.yaml", "model_configs/encoder.yaml", "model_configs/decoder.yaml",
                    "model_configs/discriminator.yaml", "checkpoints/latest", "checkpoints/best",
                    "checkpoints/best_score.yaml"):
            check((exp / rel).is_file(), f"distill.main wrote no {rel}")
        best = (exp / "checkpoints" / "best_score.yaml").read_text().strip().splitlines()[0]
        print(f"distill.main wrote {sorted(p.name for p in (exp / 'checkpoints').iterdir())}, "
              f"best_score {best}; runs {[round(s, 1) for s in main_s]} s")

        # the datasets in process, then `latest` restored into DistillModels on the card
        datasets = dmain.build_datasets(cfg, str(tmp))
        _, trainer, loop = dmain.initialize(cfg, datasets, logs_base=str(tmp / "restore"),
                                            device=dev)
        dmain.load_distill_state(str(exp / "checkpoints" / "latest"), loop.state)
        raw = msgpack_restore((exp / "checkpoints" / "latest").read_bytes())
        enc = loop.state.models.encoder
        name, param = next(iter(enc.named_parameters()))
        check(loop.state.step == MAIN_STEPS[0] and int(raw["step"]) == MAIN_STEPS[0],
              f"latest restored at step {loop.state.step}, expected {MAIN_STEPS[0]}")
        check(param.device.type == "cuda" and bool(torch.isfinite(param).all()),
              f"restored encoder {name} on {param.device}")
        print(f"checkpoints/latest restored through msgpack_restore into DistillModels on "
              f"{param.device} at step {loop.state.step}")
        del loop, trainer
        torch.cuda.empty_cache()

        # train() in process: B3's launches per step, ms per step, the data engine's share
        records, pulls, data_s = [], [], []
        orig_step = dmain.DistillTrainer.make_train_step

        def counted(self, mesh=None):
            step = orig_step(self, mesh=mesh)

            def run(state, batch, generator=None):
                before = sg.launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, losses = step(state, batch, generator)
                torch.cuda.synchronize()
                records.append({"ms": (time.perf_counter() - t0) * 1e3,
                                "launches": {k: v - before[k] for k, v in sg.launches().items()},
                                "losses": flat_losses(losses)})
                return state, losses

            return run

        train_ds = datasets["train"]
        orig_batches = train_ds.batches

        def timed_batches(*a, **kw):
            it = orig_batches(*a, **kw)
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                data_s.append(time.perf_counter() - t0)
                if batch is None:
                    return
                pulls.append(time.perf_counter())
                yield batch

        train_ds.batches = timed_batches
        dmain.DistillTrainer.make_train_step = counted
        try:
            sg.reset_launches()
            t0 = time.perf_counter()
            state = dmain.train(cfg, datasets, logs_base=str(tmp / "inproc"),
                                max_steps=TRAIN_IN_PROCESS_STEPS, device=dev)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            launches = sg.launches()
        finally:
            dmain.DistillTrainer.make_train_step = orig_step
            train_ds.batches = orig_batches
        check(state.step == TRAIN_IN_PROCESS_STEPS and len(records) == TRAIN_IN_PROCESS_STEPS,
              f"train() ended at step {state.step} after {len(records)} steps")
        for i, r in enumerate(records):
            check(r["launches"] == per_step,
                  f"train() step {i + 1}: stream-graph launches {r['launches']}, derived "
                  f"{per_step} (distill_launches_per_step)")
            check(all(np.isfinite(v) for v in r["losses"].values()),
                  f"train() step {i + 1}: non-finite losses")
        # only the intervals that end at a batch pull: the last step has no
        # batch load after it, so an interval ending at t_end is shorter
        through = [(b - a) * 1e3 for a, b in zip(pulls, pulls[1:])]
        check(len(through) >= 3, f"train(): {len(pulls)} batch pulls")
        through_ms = float(np.median(through[1:]))
        step_ms = float(np.median([r["ms"] for r in records[1:]]))
        data_ms = float(np.median([s * 1e3 for s in data_s[1:len(records)]]))
        print(f"train() x{TRAIN_IN_PROCESS_STEPS} in process: {t_end - t0:.1f} s; stream-graph "
              f"launches {launches} (per step {[r['launches'] for r in records]}, derived "
              f"{per_step}); ms from one batch pull to the next through train() (a step, its "
              f"callbacks and the next batch's load) {[round(t, 3) for t in through]}, median "
              f"after the first {through_ms:.3f} ms; the step alone {step_ms:.3f} ms and the "
              f"data engine's host time {data_ms:.3f} ms a batch (serial sum "
              f"{step_ms + data_ms:.3f} ms); phase 9's bare step {bare_step_ms:.3f} ms; total "
              f"loss by step {[round(r['losses']['/total'], 4) for r in records]}")
        out.update(launches=launches, per_step=per_step, through_ms=through_ms, step_ms=step_ms,
                   data_ms=data_ms, main_s=main_s)
        del state
        torch.cuda.empty_cache()

        snif_logs = tmp / "sniffer_logs"
        run_module(["hifigan_tpu_torch.cli.train_sniffers", *common, "--logs_base",
                    str(snif_logs), "--max_steps", str(SNIFFER_STEPS), "--device", "cuda"],
                   f"train_sniffers --max_steps {SNIFFER_STEPS}")
        for key in ("content", "style"):
            ck = snif_logs / "sniffers" / key / "default" / "version_1" / "checkpoints"
            check((ck / "best").is_file() and (ck / "best_score.yaml").is_file(),
                  f"train_sniffers wrote no best checkpoint for {key}")
            step = int(msgpack_restore((ck / "best").read_bytes())["step"])
            check(0 < step <= SNIFFER_STEPS, f"{key} sniffer's best at step {step}")
            print(f"train_sniffers {key}: checkpoints {sorted(p.name for p in ck.iterdir())}, "
                  f"best at step {step}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the parallel path (mesh, DP / TP steps, batch-sharded B2 and B3)
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 3  # DP steps of the V1 and distill main paths on the mesh
SHARD_BLOCKS_B2 = (2, 4)  # row blocks of the V1 MSD stack at B=16
SHARD_BLOCKS_B3 = 3  # row blocks of a member's segments at batch 3
DP_METRIC_RTOL = 1e-5  # step 1 on the world-1 mesh vs without it: float order
DP_GRAD_RTOL = 1e-4  # ... its gradients (Adam first moments), of each leaf's norm
DP_FLIP_SHARE = 1e-4  # ... the share of all parameter entries more than 1e-6 apart
MULTI_LOSS_RTOL = 2e-5  # distill step-1 losses on several NCCL ranks vs one rank


def v1_param_diff(before: dict, got: dict) -> dict:
    """Two V1 states after one step, from one start: the worst gradient
    (Adam first moment) difference over its leaf's norm, the largest
    parameter difference, and the share of all parameter entries more than
    1e-6 apart. The gradient clause decides the hold: cuDNN's backward sums
    in no fixed order, and AdamW's first step moves a weight by about
    lr * sign(g), so a gradient within float noise of zero may move it the
    other way, by up to 2 x lr, and the largest parameter difference says
    nothing. The share bounds how many entries may do so."""
    grad, worst, apart, total = 0.0, 0.0, 0, 0
    for name, (p_want, m_want) in before.items():
        p_got, m_got = got[name]
        grad = max(grad, ((m_got - m_want).norm() / m_want.norm().clamp_min(1e-30)).item())
        diff = (p_got - p_want).abs()
        worst = max(worst, diff.max().item())
        apart += int((diff > 1e-6).sum())
        total += diff.numel()
    share = apart / total
    return {"grad_rel": grad, "max": worst, "share": share,
            "ok": grad <= DP_GRAD_RTOL and share <= DP_FLIP_SHARE}


def v1_params(state) -> dict:
    """{name: (parameter, Adam first moment)} of a V1 state, copied."""
    moments = {**state.opt_g.state, **state.opt_d.state}
    return {f"{g}.{k}": (p.detach().clone(), moments[p]["exp_avg"].clone()) for g in V1_GROUPS
            for k, p in getattr(state, g).named_parameters()}


def in_turns(mesh_step, plain_step, state, batches: list, place) -> tuple[float, float]:
    """ms of a step with the mesh and without it on one state, in turns
    (mesh, plain, plain, mesh, mesh, plain): the mean of each's three."""
    ms = {"mesh": [], "plain": []}
    for i, which in enumerate(("mesh", "plain", "plain", "mesh", "mesh", "plain")):
        step = mesh_step if which == "mesh" else plain_step
        batch = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, place(batch) if which == "mesh" else batch)
        torch.cuda.synchronize()
        ms[which].append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(ms["mesh"])), float(np.mean(ms["plain"]))


def v1_mesh_phase(h, dev, mesh, card: str, phase6_ms: float) -> dict:
    """The DP V1 step on the mesh: PARALLEL_STEPS steps at B=16 x 8192,
    fp32, B2's launches per step against the derived counts, step 1 against
    the same step without a mesh."""
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.ops import conv_stack as cs
    from hifigan_tpu_torch.parallel.mesh import shard_batch
    from hifigan_tpu_torch.train.vocoder import create_train_state, make_train_step

    h = AttrDict(h, msd_conv_impl="auto")
    per_step = {k: v * h.get("msd_num_scales", 3) * 7 for k, v in PASSES_PER_STEP.items()}
    batches = [{"audio": synthetic_audio(h["batch_size"], h["segment_size"], h["sampling_rate"],
                                         SEED + 10 + i)} for i in range(PARALLEL_STEPS)]
    ref = create_train_state(h, seed=SEED, device=dev)
    _, ref_metrics = make_train_step(h)(ref, batches[0])
    ref_metrics = {k: v.item() for k, v in ref_metrics.items()}
    ref_after = v1_params(ref)
    del ref
    torch.cuda.empty_cache()
    state = create_train_state(h, seed=SEED, device=dev, mesh=mesh)
    step = make_train_step(h, mesh=mesh)
    step_ms, counts, history = [], [], []
    cs.reset_launches()
    for i, batch in enumerate(batches):
        before = cs.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, shard_batch(batch, mesh))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append({k: v - before[k] for k, v in cs.launches().items()})
        history.append({k: v.item() for k, v in metrics.items()})
        if i == 0:
            diff = v1_param_diff(ref_after, v1_params(state))
    launches = cs.launches()
    del ref_after
    for i, (n, m) in enumerate(zip(counts, history)):
        check(n == per_step, f"DP V1 step {i + 1}: conv-stack launches {n}, derived {per_step}")
        check(all(np.isfinite(v) for v in m.values()), f"DP V1 step {i + 1}: non-finite {m}")
    rel = {k: abs(history[0][k] - v) / max(abs(v), 1e-30) for k, v in ref_metrics.items()}
    print(f"parallel ({card}): DP V1 step 1 on the world-1 mesh vs without a mesh: metrics "
          f"relative difference {json.dumps(rel)} (limit {DP_METRIC_RTOL}); gradients (Adam "
          f"first moments) worst leaf {diff['grad_rel']:.3e} of its norm (limit {DP_GRAD_RTOL}); "
          f"parameters max |diff| {diff['max']:.3e} (not held: AdamW's first step moves an "
          f"entry by about lr x sign(g)), entries more than 1e-6 apart {diff['share']:.2e} of "
          f"all (limit {DP_FLIP_SHARE})")
    check(max(rel.values()) <= DP_METRIC_RTOL, f"DP V1 step 1 metrics vs no mesh: {rel}")
    check(diff["ok"], f"DP V1 step 1 parameters vs no mesh: {diff}")
    ms = float(np.median(step_ms[1:]))
    turns = in_turns(step, make_train_step(h), state, batches, lambda b: shard_batch(b, mesh))
    print(f"parallel ({card}): DP V1 B={h['batch_size']}x{h['segment_size']} fp32 (TF32 off) "
          f"on the mesh: step ms {[round(t, 3) for t in step_ms]}, median of steps "
          f"2-{PARALLEL_STEPS} {ms:.3f} ms (phase 6 without a mesh {phase6_ms:.3f} ms); in turns "
          f"on one state, with the mesh {turns[0]:.3f} ms and without {turns[1]:.3f} ms a step "
          f"(mean of 3 each); conv-stack launches per step {counts[0]}")
    return {"step_ms": ms, "launches": launches, "per_step": per_step, "rel": rel,
            "params": diff, "turns": turns}


def distill_mesh_phase(config: dict, dev, mesh, card: str, phase9: dict) -> dict:
    """The DP distill step on the mesh: PARALLEL_STEPS steps of
    configs/distill.json (accumulated_grad_batches 1), B3's launches per
    step against the derived counts, step 1's losses against phase 9's."""
    from hifigan_tpu_torch.distill.train import DistillTrainer
    from hifigan_tpu_torch.ops import stream_graph as sg
    from hifigan_tpu_torch.parallel.mesh import shard_batch

    cfg = copy.deepcopy(config)
    cfg["learning"]["accumulated_grad_batches"] = 1
    models = distill_models(cfg, dev, mesh=mesh)
    trainer = DistillTrainer(models, cfg)
    state = trainer.create_state(seed=SEED)
    batches = distill_batches(cfg, trainer, models)[:PARALLEL_STEPS]
    per_step = distill_launches_per_step(len(cfg["models"]["discriminator"]["layers"]) - 2)
    step = trainer.make_train_step(mesh=mesh)
    step_ms, counts, history = [], [], []
    sg.reset_launches()
    for batch in batches:
        before = sg.launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = step(state, shard_batch(batch, mesh))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append({k: v - before[k] for k, v in sg.launches().items()})
        history.append(flat_losses(losses))
    launches = sg.launches()
    for i, (n, l) in enumerate(zip(counts, history)):
        check(n == per_step, f"DP distill step {i + 1}: stream-graph launches {n}, "
                             f"derived {per_step}")
        check(all(np.isfinite(v) for v in l.values()), f"DP distill step {i + 1}: non-finite")
    want = phase9["losses_1"]
    rel = {k: abs(history[0][k] - v) / max(abs(v), 1e-7) for k, v in want.items()}
    worst = max(rel, key=rel.get)
    ms = float(np.median(step_ms[1:]))
    turns = in_turns(step, trainer.make_train_step(), state, batches,
                     lambda b: shard_batch(b, mesh))
    print(f"parallel ({card}): DP distill step 1 on the world-1 mesh vs phase 9's step 1 "
          f"(same seed and batch): worst relative difference over {len(rel)} losses "
          f"{rel[worst]:.3e} at {worst} (limit {DP_METRIC_RTOL}, absolute floor 1e-7)")
    check(set(history[0]) == set(want) and rel[worst] <= DP_METRIC_RTOL,
          f"DP distill step 1 vs phase 9: {worst} {rel[worst]}")
    print(f"parallel ({card}): DP distill B={trainer.batch_size}x{trainer.segment_length} fp32 "
          f"(TF32 off) on the mesh: step ms {[round(t, 3) for t in step_ms]}, median of steps "
          f"2-{PARALLEL_STEPS} {ms:.3f} ms (phase 9 without a mesh {phase9['step_ms']:.3f} ms); "
          f"in turns on one state, with the mesh {turns[0]:.3f} ms and without {turns[1]:.3f} "
          f"ms a step (mean of 3 each); stream-graph launches per step {counts[0]}")
    return {"step_ms": ms, "launches": launches, "per_step": per_step, "rel": rel[worst],
            "models": models, "turns": turns}


def b2_shard_phase(dev, card: str) -> dict:
    """B2's batch-sharded split: the V1 MSD stack (scale 0) at B=16 over 2
    and 4 row blocks, each block one launch per pass, held against one
    launch over the whole batch (outputs and dx concatenated, dW and db
    summed); the 2-block split timed block by block."""
    from hifigan_tpu_torch.models import MultiScaleDiscriminator
    from hifigan_tpu_torch.ops import conv_stack as cs
    from hifigan_tpu_torch.ops.conv import conv1d, leaky_relu
    from hifigan_tpu_torch.parallel.mesh import row_block

    msd = MultiScaleDiscriminator(generator=torch.Generator().manual_seed(SEED)).to(dev)
    d = msd.discriminators[0]
    n = max(STACK_BATCHES)
    wav = torch.from_numpy(synthetic_audio(n, SEGMENT, 22050, SEED + 2)).to(dev)
    specs, ks, bs = stack_of(d, torch.float32)
    with torch.no_grad():
        k0, b0 = d.convs[0].kernel_nwc()
        x0 = leaky_relu(conv1d(wav[:, :, None], k0, b0, padding=d.convs[0].padding)).contiguous()
    del msd, d
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)

    def run(x):
        x = x.clone().requires_grad_()
        kk = [k.clone().requires_grad_() for k in ks]
        bk = [b.clone().requires_grad_() for b in bs]
        ys = cs.fused_conv_stack(x, kk, bk, specs)
        return ys, x, kk, bk

    ys, x, kk, bk = run(x0)
    dys = [torch.randn(y.shape, device=dev, generator=gen) * 0.01 for y in ys]
    whole = torch.autograd.grad(ys, [x, *kk, *bk], dys)
    ys = [y.detach() for y in ys]
    errs = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    rels = dict(errs)

    def held(what, got, want, kind, tag):
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"B2 split {tag} {what}: {tuple(got.shape)} or non-finite")
        check(err <= FP32_TOL * peak, f"B2 split {tag} {what}: error {err} > {FP32_TOL} * {peak}")
        errs[kind] = max(errs[kind], err)
        rels[kind] = max(rels[kind], err / max(peak, 1e-30))

    for blocks in SHARD_BLOCKS_B2:
        outs, grads = [], []
        for i in range(blocks):
            rows = row_block(n, blocks, i)
            yi, xi, ki, bi = run(x0[rows])
            grads.append(torch.autograd.grad(yi, [xi, *ki, *bi], [dy[rows] for dy in dys]))
            outs.append([y.detach() for y in yi])
        tag = f"{blocks} blocks of {n // blocks}"
        for l, y in enumerate(ys):
            held(f"y{l}", torch.cat([o[l] for o in outs]), y, "fwd", tag)
        held("dx", torch.cat([g[0] for g in grads]), whole[0], "bwd_dx", tag)
        for j in range(1, len(whole)):
            held(f"dW/db {j - 1}", sum(g[j] for g in grads), whole[j], "bwd_dw", tag)
        print(f"parallel ({card}): B2 split of the V1 MSD stack at B={n} x {SEGMENT} into "
              f"{tag} rows: outputs and dx concatenated, dW and db summed, held against one "
              f"launch over the batch (so far max_abs_err {json.dumps(errs)}, the largest of "
              f"each tensor's error over its peak {json.dumps(rels)}, limit {FP32_TOL})")
    del whole, ys, x, kk, bk, grads, outs
    blocks = SHARD_BLOCKS_B2[0]
    xbs = [x0[row_block(n, blocks, i)].contiguous() for i in range(blocks)]
    dybs = [[dy[row_block(n, blocks, i)].contiguous() for dy in dys] for i in range(blocks)]
    out = {"errs": errs, "rel": rels, "blocks": blocks, "batch": n,
           **time_stack_blocks(cs, xbs, ks, bs, specs, dybs)}
    out["whole_ms"] = time_stack_blocks(cs, [x0], ks, bs, specs, [dys])["ms"]
    flop, nbytes = 0, {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}
    for xb in xbs:
        f, *b = stack_cost(specs, xb)
        flop += f
        for k, v in zip(nbytes, b):
            nbytes[k] += v
    out["bound_ms"] = {k: max(flop / FP32_MMA_FLOPS, v / H100_BYTES_PER_S) * 1e3
                       for k, v in nbytes.items()}
    out["bound_by"] = {k: "operations" if flop / FP32_MMA_FLOPS >= v / H100_BYTES_PER_S
                       else "bytes" for k, v in nbytes.items()}
    print(f"parallel ({card}): B2 split into {blocks} blocks, the blocks' passes in turn "
          "(mean of 20 after a warm-up): " + "; ".join(
              f"{k} kernel {out['ms'][k]:.3f} ms (one launch over the batch "
              f"{out['whole_ms'][k]:.3f} ms) plain {out['plain_ms'][k]:.3f} ms cudnn "
              f"{out['library_ms'][k]:.3f} ms bound {out['bound_ms'][k]:.4f} ms"
              for k in nbytes))
    return out


def time_stack_blocks(cs, xbs, ks, bs, specs, dybs) -> dict:
    """CUDA-event times of one pass over every row block in turn (B2's split):
    kernel, plain version and cuDNN chain; dW is the full backward less
    the dx-only backward, both over all blocks."""
    reps = 20
    xs = [x.clone().requires_grad_() for x in xbs]
    kk = [[k.clone().requires_grad_() for k in ks] for _ in xbs]
    bk = [[b.clone().requires_grad_() for b in bs] for _ in xbs]
    ys = [cs.fused_conv_stack(x, k, b, specs) for x, k, b in zip(xs, kk, bk)]
    ys_dx = [cs.fused_conv_stack(x, ks, bs, specs) for x in xs]
    saved = [[y.detach() for y in yb] for yb in ys]
    with torch.no_grad():
        k_fwd = time_ms(lambda: [cs.fused_conv_stack(x, ks, bs, specs) for x in xbs], reps)
        p_fwd = time_ms(lambda: [cs.fused_conv_stack_reference(x, ks, bs, specs) for x in xbs],
                        reps)
    k_bwd = time_ms(lambda: [torch.autograd.grad(y, [x, *k, *b], d, retain_graph=True)
                             for y, x, k, b, d in zip(ys, xs, kk, bk, dybs)], reps)
    k_dx = time_ms(lambda: [torch.autograd.grad(y, [x], d, retain_graph=True)
                            for y, x, d in zip(ys_dx, xs, dybs)], reps)
    p_bwd = time_ms(lambda: [cs.fused_conv_stack_backward_reference(x, ks, sv, d, specs)
                             for x, sv, d in zip(xbs, saved, dybs)], reps)
    p_dx = time_ms(lambda: [cs.fused_conv_stack_backward_reference(x, ks, sv, d, specs,
                                                                   weight_grads=False)
                            for x, sv, d in zip(xbs, saved, dybs)], reps)
    xcs = [x.transpose(1, 2).contiguous().requires_grad_() for x in xbs]
    ws = [k.permute(2, 1, 0).contiguous().requires_grad_() for k in ks]
    lb = [b.clone().requires_grad_() for b in bs]
    dcs = [[d.transpose(1, 2).contiguous() for d in db] for db in dybs]
    with torch.no_grad():
        l_fwd = time_ms(lambda: [cudnn_chain(xc, specs, ws, lb) for xc in xcs], reps)
    outs = [cudnn_chain(xc, specs, ws, lb) for xc in xcs]
    l_bwd = time_ms(lambda: [torch.autograd.grad(o, [xc, *ws, *lb], d, retain_graph=True)
                             for o, xc, d in zip(outs, xcs, dcs)], reps)
    outs_dx = [cudnn_chain(xc, specs, [w.detach() for w in ws], [b.detach() for b in lb])
               for xc in xcs]
    l_dx = time_ms(lambda: [torch.autograd.grad(o, [xc], d, retain_graph=True)
                            for o, xc, d in zip(outs_dx, xcs, dcs)], reps)
    return {"ms": {"fwd": k_fwd, "bwd_dx": k_dx, "bwd_dw": k_bwd - k_dx},
            "plain_ms": {"fwd": p_fwd, "bwd_dx": p_dx, "bwd_dw": p_bwd - p_dx},
            "library_ms": {"fwd": l_fwd, "bwd_dx": l_dx, "bwd_dw": l_bwd - l_dx}}


def b3_shard_phase(models, dev, card: str) -> dict:
    """B3's batch-sharded split: every segment of a production member at
    batch 3 (x the members), over 3 row blocks of one element each (the
    mesh form's member-major split), held against one launch over the
    batch: the forward, then dx, dW and db over the whole forward's saved
    activations (levels and dx concatenated, dW and db summed); the blocks
    timed one by one."""
    from hifigan_tpu_torch.ops import stream_graph as sg

    seg_len = models.config["loops"]["train"]["segment_length"]
    wav = torch.from_numpy(synthetic_audio(SHARD_BLOCKS_B3, seg_len,
                                           models.config["sampling_rate"], SEED + 61)).to(dev)
    segs = record_segments(models.frozen_discriminator(), wav[:, :, None])
    check(len(segs) == 10, f"a production member has 10 segments, recorded {len(segs)}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 62)
    errs = {"fwd": 0.0, "bwd_dx": 0.0, "bwd_dw": 0.0}
    rels = dict(errs)
    times, costs, whole_t = [], [], []

    def block(t, m, i):
        tm = t.reshape(m, t.shape[0] // m, *t.shape[1:])
        return tm[:, i:i + 1].reshape(m, *t.shape[1:]).contiguous()

    def unblock(parts, m):
        return torch.cat([p.reshape(m, 1, *p.shape[1:]) for p in parts], 1).reshape(
            -1, *parts[0].shape[1:])

    def held(what, got, want, kind, tag):
        err = (got.float() - want.float()).abs().max().item()
        peak = want.float().abs().max().item()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"B3 split {tag} {what}: {tuple(got.shape)} or non-finite")
        check(err <= FP32_TOL * max(peak, 1e-30),
              f"B3 split {tag} {what}: error {err} > {FP32_TOL} * {peak}")
        errs[kind] = max(errs[kind], err)
        rels[kind] = max(rels[kind], err / max(peak, 1e-30))

    for si, (seg, ins, tabs, bs, m) in enumerate(segs):
        tag = f"segment {si}"
        every = [True] * len(tabs)
        with torch.no_grad():
            ys = sg.fused_stream_graph(seg, ins, tabs, bs, members=m)
        dys = [torch.randn(y.shape, device=dev, generator=gen) * 0.01 for y in ys]
        whole_t.append(time_segment(sg, seg, ins, tabs, bs, m, dys, every))
        # both backwards over the same saved activations (the whole batch's):
        # forwards that differ by rounding can put a pre-activation on either
        # side of a leaky ReLU, and the cotangents then differ at the 1e-3 level
        plan = sg._plan(seg, (tuple([True] * len(ins)), tuple(every),
                              tuple(b is not None for b in bs), tuple([True] * len(ys))))
        w_dx, w_dw, w_db = sg._backward_cuda(seg, plan, ins, ys, dys, tabs, m)
        parts = []
        for i in range(SHARD_BLOCKS_B3):
            b_in, b_dy = [block(x, m, i) for x in ins], [block(d, m, i) for d in dys]
            with torch.no_grad():
                b_ys = sg.fused_stream_graph(seg, b_in, tabs, bs, members=m)
            parts.append((b_ys, *sg._backward_cuda(seg, plan, b_in, [block(y, m, i) for y in ys],
                                                   b_dy, tabs, m)))
            times.append(time_segment(sg, seg, b_in, tabs, bs, m, b_dy, every))
            costs.append(segment_cost(seg, tabs, bs, 1, m, 4, every))
        torch.cuda.synchronize()
        for l, y in enumerate(ys):
            held(f"level {l}", unblock([p[0][l] for p in parts], m), y, "fwd", tag)
        for j, w in enumerate(w_dx):
            held(f"dx{j}", unblock([p[1][j] for p in parts], m), w, "bwd_dx", tag)
        for j, w in enumerate(w_dw):
            if w is not None:
                held(f"dW{j}", sum(p[2][j] for p in parts), w, "bwd_dw", tag)
        for j, w in enumerate(w_db):
            if w is not None:
                held(f"db{j}", sum(p[3][j] for p in parts), w, "bwd_dw", tag)
    interp = copy.deepcopy(models.discriminator)
    for mod in interp.modules():
        if hasattr(mod, "member_impl"):
            mod.member_impl, mod.update_spectral, mod.mesh = "interpret", False, None
    lib = interp_times(interp, wav[:, :, None])
    del interp
    out = {"errs": errs, "rel": rels, "library_ms": lib}
    for key in ("ms", "plain_ms"):
        out[key] = {k: sum(t[key][k] for t in times) for k in ("fwd", "bwd_dx", "bwd_dw")}
    out["whole_ms"] = {k: sum(t["ms"][k] for t in whole_t) for k in ("fwd", "bwd_dx", "bwd_dw")}
    out["bound"] = {k: segment_bound(costs, k) for k in ("fwd", "bwd_dx", "bwd_dw")}
    print(f"parallel ({card}): B3 split of the 10 segments of a production member at batch "
          f"{SHARD_BLOCKS_B3} x {seg_len} into {SHARD_BLOCKS_B3} blocks of one element: levels "
          f"and dx concatenated, dW and db summed, held against one launch over the batch "
          f"(max_abs_err {json.dumps(errs)}, the largest of each tensor's error over its peak "
          f"{json.dumps(rels)}, limit {FP32_TOL}); blocks' "
          "kernel ms " + ", ".join(f"{k} {v:.3f}" for k, v in out["ms"].items())
          + "; one launch a segment over the batch " + ", ".join(
              f"{k} {v:.3f}" for k, v in out["whole_ms"].items())
          + "; plain " + ", ".join(f"{k} {v:.3f}" for k, v in out["plain_ms"].items())
          + "; the interpreter's cuDNN chain at batch 3 "
          + ", ".join(f"{k} {v:.3f}" for k, v in lib.items()))
    return out


def _distill_dp_hold_rank(rank: int, n: int, device: str, store: str, out: str, config: dict,
                          labels: dict, want: dict | None) -> None:
    """One rank of the multi-card hold: step 1 of ``config`` (as phase 9:
    accumulated_grad_batches 1, the seeded models and batch) on the mesh
    that distill.main's ``resolve_mesh`` picks for the train batch over n
    ranks; each member steps on its rows, a rank outside the subset only
    waits. Rank 0 then takes the same step alone on the whole batch and
    writes to ``out``: the losses' worst relative difference from that step
    and from ``want`` (phase 9's step 1, when given), the gradient and
    update hold (:func:`held_update`), and whether every member ends with
    the same parameters."""
    import torch.distributed as dist

    from hifigan_tpu_torch.distill.main import resolve_mesh
    from hifigan_tpu_torch.distill.train import DistillTrainer
    from hifigan_tpu_torch.graft_entry import rows_of
    from hifigan_tpu_torch.parallel.mesh import initialize_distributed, shard_batch

    dev = initialize_distributed(device, init_method=f"file://{store}", world_size=n, rank=rank,
                                 local_rank=rank)
    try:
        cfg = copy.deepcopy(config)
        cfg["learning"]["accumulated_grad_batches"] = 1
        mesh = resolve_mesh(cfg, "auto")
        member = mesh.member if mesh is not None else rank == 0
        sums = None
        if member:
            models = distill_models(cfg, dev, mesh=mesh, labels=labels)
            trainer = DistillTrainer(models, cfg)
            state = trainer.create_state(seed=SEED)
            batch = distill_batches(cfg, trainer, models, labels)[0]
            before = {g: [p.detach().clone() for p in o.params]
                      for g, o in state.optimizers.items()}
            mine = batch if mesh is None else rows_of(batch, mesh)
            state, losses = trainer.make_train_step(mesh=mesh)(state, shard_batch(mine, mesh))
            sums = [float(p.detach().double().sum()) for o in state.optimizers.values()
                    for p in o.params]
        every = [None] * n
        dist.all_gather_object(every, sums)
        if rank == 0:
            dp = flat_losses(losses)
            dp_after = optimizer_snapshot(state)
            ids = parameter_names(models)
            leaf_names = {g: [ids[id(p)] for p in o.params] for g, o in state.optimizers.items()}
            lrs = trainer.flat_groups
            del state, models, trainer
            one_models = distill_models(cfg, dev, labels=labels)
            one_trainer = DistillTrainer(one_models, cfg)
            one_state, one = one_trainer.make_train_step()(
                one_trainer.create_state(seed=SEED), shard_batch(batch, None))
            one = flat_losses(one)
            upd = held_update(leaf_names, lrs, before, dp_after, optimizer_snapshot(one_state))
            members = [s for s in every if s is not None]
            Path(out).write_text(json.dumps({
                "mesh": None if mesh is None else mesh.shape["data"],
                "batch": cfg["loops"]["train"]["batch_size"],
                "loss_rel": max(abs(dp[k] - v) / max(abs(v), 1e-7) for k, v in one.items()),
                "phase9_rel": None if want is None else max(
                    abs(dp[k] - v) / max(abs(v), 1e-7) for k, v in want.items()),
                "update": upd, "members": len(members),
                "replicas_equal": all(s == members[0] for s in members)}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def multi_card_phase(n: int, card: str, config: dict, device: str = "cuda",
                     labels: dict = DISTILL_LABELS, want: dict | None = None) -> dict:
    """With n cards: ``dryrun_multichip(n)`` on n NCCL ranks, and step 1 of
    ``config`` (configs/distill.json on the card) on distill.main's mesh for
    n ranks held against one rank's step and against ``want`` (phase 9's
    step-1 losses). With batch 3, 3 or 4 ranks take a 3-rank mesh; 2 ranks
    take none (the JAX policy), and rank 0 then steps alone."""
    from hifigan_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(n, device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "hold.json")
        torch.multiprocessing.start_processes(
            _distill_dp_hold_rank,
            args=(n, device, os.path.join(tmp, "store"), out, config, labels, want), nprocs=n,
            join=True, start_method="spawn")
        hold = json.loads(Path(out).read_text())
    upd = hold["update"]
    mesh = (f"a {hold['mesh']}-rank data mesh" if hold["mesh"] else
            "no mesh (no divisor > 1 of the batch fits; rank 0 steps alone, no collective runs)")
    phase9 = ("not given" if hold["phase9_rel"] is None
              else f"{hold['phase9_rel']:.3e} (limit {MULTI_LOSS_RTOL})")
    print(f"parallel ({card}): distill step 1 at batch {hold['batch']} on {n} ranks, "
          f"resolve_mesh: {mesh}; losses vs one rank's step {hold['loss_rel']:.3e} (limit "
          f"{MULTI_LOSS_RTOL}), vs phase 9's step 1 {phase9}; {hold['members']} members' "
          f"parameters equal: {hold['replicas_equal']}")
    print(update_line(f"parallel ({card}): distill step 1 on {n} ranks vs one rank", upd))
    check(hold["loss_rel"] <= MULTI_LOSS_RTOL and hold["replicas_equal"]
          and (hold["phase9_rel"] is None or hold["phase9_rel"] <= MULTI_LOSS_RTOL),
          f"multi-card hold {hold}")
    check(upd["grad_rel"] <= STEP_GRAD_TOL and upd["update_rel"] <= STEP_UPDATE_TOL,
          f"multi-card hold: gradients {upd['grad_rel']} (limit {STEP_GRAD_TOL}), updates "
          f"{upd['update_rel']} (limit {STEP_UPDATE_TOL})")
    return hold


def debug_reports(h, sd, mel, dev, card: str) -> dict:
    """``utils/debug.compile_report`` on the card: a V1 B=1 request through
    B1 and a V1 train step at B=HOLD_BATCH through B2 (forward and
    backward); each kernel launch is counted through its plain version."""
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
    from hifigan_tpu_torch.train.vocoder import create_train_state, make_train_step
    from hifigan_tpu_torch.utils.debug import compile_report

    fast = make_fast_vocoder(h, sd, dtype=torch.bfloat16)
    serve = compile_report(fast, mel)
    h2 = AttrDict(h, batch_size=HOLD_BATCH)
    state = create_train_state(h2, seed=SEED, device=dev)
    batch = {"audio": synthetic_audio(HOLD_BATCH, h["segment_size"], h["sampling_rate"], SEED + 64)}
    train = compile_report(make_train_step(h2), state, batch)
    for what, rep in (("request", serve), ("train step", train)):
        print(f"parallel ({card}): compile_report of a V1 {what}: {json.dumps(rep)}")
        check(rep["flops"] is not None and rep["flops"] > 0 and rep["bytes_accessed"] > 0
              and rep["memory_analysis"] is not None, f"compile_report of a V1 {what}: {rep}")
    return {"serve": serve, "train": train}


def parallel_phase(h, sd, distill_cfg: dict, dev, card: str, train: dict,
                   distill: dict) -> dict:
    """Phase 18: an NCCL process group of world 1 and its mesh, the port's
    ``entry()``, the DP V1 step and the DP distill step through the mesh
    path, B2's and B3's batch-sharded split held block by block against one
    launch, the sharded generator against the Generator, and with two
    cards or more the multi-rank run."""
    import torch.distributed as dist

    from hifigan_tpu_torch import graft_entry
    from hifigan_tpu_torch.models import Generator
    from hifigan_tpu_torch.parallel.halo import make_sharded_generator
    from hifigan_tpu_torch.parallel.mesh import create_mesh, initialize_distributed

    store = REPO / "build" / "parallel_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    initialize_distributed("cuda", init_method=f"file://{store}", world_size=1, rank=0,
                           local_rank=0)
    try:
        mesh = create_mesh()
        print(f"parallel ({card}): process group backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}; {mesh}. At world 1 every collective and every "
              "cross-rank path (row split and gather, gradient and metric means) is the "
              "identity: this phase runs the mesh wiring and the kernels' mesh forms, and the "
              "gloo ranks of the CPU tests are the evidence for the collectives")
        check(dist.get_backend() == "nccl" and mesh.shape == {"data": 1, "model": 1},
              f"the world-1 NCCL mesh: {dist.get_backend()} {mesh}")
        fn, args = graft_entry.entry()
        wav = fn(*args)
        hop = int(np.prod(h["upsample_rates"]))
        check(tuple(wav.shape) == (1, 1, 32 * hop) and bool(torch.isfinite(wav).all()),
              f"entry() forward {tuple(wav.shape)}")
        print(f"parallel ({card}): graft_entry.entry() forward {tuple(wav.shape)} on "
              f"{wav.device}")
        v1 = v1_mesh_phase(h, dev, mesh, card, train["step_ms"])
        torch.cuda.empty_cache()
        dd = distill_mesh_phase(distill_cfg, dev, mesh, card, distill)
        torch.cuda.empty_cache()
        b2 = b2_shard_phase(dev, card)
        torch.cuda.empty_cache()
        b3 = b3_shard_phase(dd.pop("models"), dev, card)
        torch.cuda.empty_cache()
        gen = Generator(h, folded=True)
        gen.load_state_dict(sd)
        gen = gen.to(dev).eval()
        mel = (torch.randn((1, h["num_mels"], FRAMES), generator=torch.Generator().manual_seed(
            SEED + 63)) * 2 - 5).to(dev)
        with torch.no_grad():
            want = gen(mel)
        got = make_sharded_generator(h, mesh, folded=True)(sd, mel)
        err, peak = (got - want).abs().max().item(), want.abs().max().item()
        print(f"parallel ({card}): make_sharded_generator on the world-1 mesh vs the Generator "
              f"(V1, {FRAMES} frames): max_abs_err {err:.3e} (limit {FP32_TOL} x peak {peak:.4f})")
        check(got.shape == want.shape and err <= FP32_TOL * peak, f"sharded generator {err}")
        reports = debug_reports(h, sd, mel, dev, card)
    finally:
        dist.destroy_process_group()
    cards = torch.cuda.device_count()
    multi = None
    if cards >= 2:
        multi = multi_card_phase(min(cards, 4), card, distill_cfg, want=distill["losses_1"])
    else:
        print(f"parallel ({card}): the multi-rank run (dryrun_multichip and the DP distill hold "
              f"on NCCL ranks) was not made: this machine has {cards} card")
    return {"v1": v1, "distill": dd, "b2": b2, "b3": b3, "multi": multi, "reports": reports}


def parallel_entries(par: dict) -> list:
    """The kernels line's rows of B2's and B3's batch-sharded forms."""
    rows = []
    b2, b3 = par["b2"], par["b3"]
    for kind in ("fwd", "bwd_dx", "bwd_dw"):
        rows.append({
            "name": f"fused_conv_stack.mesh.{kind}",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/conv_stack.cu",
            "replaces": "hifigan_tpu/ops/pallas/conv_stack.py:1035",
            "launches": par["v1"]["launches"][kind],
            "launches_per_step": par["v1"]["per_step"][kind],
            "max_abs_err": b2["errs"][kind],
            "max_rel_err": b2["rel"][kind],
            "ms": b2["ms"][kind], "one_launch_ms": b2["whole_ms"][kind],
            "plain_ms": b2["plain_ms"][kind],
            "bound_ms": b2["bound_ms"][kind], "bound_by": b2["bound_by"][kind],
            "library_ms": b2["library_ms"][kind],
            "per": (f"launches: the DP V1 main path's run of {PARALLEL_STEPS} steps on the "
                    f"world-1 NCCL mesh; max_abs_err: the V1 MSD stack (scale 0) at "
                    f"B={b2['batch']} split into 2 and 4 row blocks vs one launch (outputs and "
                    f"dx concatenated, dW and db summed); times and bound: the {b2['blocks']} "
                    "blocks' passes in turn (one_launch_ms: one launch over the batch; library: "
                    "cuDNN's conv chain, plain: the PyTorch reference, each over the same "
                    "blocks)"),
        })
    for kind in ("fwd", "bwd_dx", "bwd_dw"):
        bound, by = b3["bound"][kind]
        rows.append({
            "name": f"fused_stream_graph.mesh.{kind}",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/stream_graph.cu",
            "replaces": "hifigan_tpu/ops/pallas/stream_graph.py:836",
            "launches": par["distill"]["launches"][kind],
            "launches_per_step": par["distill"]["per_step"][kind],
            "max_abs_err": b3["errs"][kind],
            "max_rel_err": b3["rel"][kind],
            "ms": b3["ms"][kind], "one_launch_ms": b3["whole_ms"][kind],
            "plain_ms": b3["plain_ms"][kind],
            "bound_ms": bound, "bound_by": by,
            "library_ms": b3["library_ms"][kind],
            "per": (f"launches: the DP distill main path's run of {PARALLEL_STEPS} steps on the "
                    "world-1 NCCL mesh; max_abs_err, times and bound: the 10 segments of a "
                    f"production member at batch {SHARD_BLOCKS_B3} split into "
                    f"{SHARD_BLOCKS_B3} row blocks, each block one launch a pass, summed "
                    "(one_launch_ms: one launch a segment over the batch; library: the "
                    "interpreter's cuDNN chain over the discriminator at batch "
                    f"{SHARD_BLOCKS_B3}; dW over every table)"),
        })
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "hifigan_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the hifigan_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hifigan_tpu_torch.cli import infer
    from hifigan_tpu_torch.config import get_config
    from hifigan_tpu_torch.models import Generator, MultiScaleDiscriminator, fold_weight_norm
    from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
    from hifigan_tpu_torch.ops import _build
    from hifigan_tpu_torch.ops import resblock_tail as tail

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.3f} s "
          f"(nvcc per source: {json.dumps({k: round(v, 3) for k, v in _build.BUILD_SECONDS.items()})})")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    lap_at = [t_start]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - lap_at[0]:.1f} s wall")
        lap_at[0] = now

    lap("1 (card, build)")
    h = get_config("v1")
    hop = int(np.prod(h["upsample_rates"]))
    gen_w = Generator(h, generator=torch.Generator().manual_seed(SEED))
    state_wn = gen_w.state_dict()
    sd = fold_weight_norm(state_wn)
    n_stages = len(h["upsample_rates"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. kernel vs plain version, every V1 stage at full width (and V2's in bf16)
    mel_gen = torch.Generator().manual_seed(SEED + 1)
    mel_in = (torch.randn((max(BATCHES), h["num_mels"], FRAMES), generator=mel_gen) * 2 - 5).to(dev)
    mrf = mrf_phase(h, sd, mel_in, dev, "V1", (torch.float32, torch.bfloat16), BATCHES)
    errs, request = mrf["errs"], mrf["request"]
    h2 = get_config("v2")
    sd2 = fold_weight_norm(Generator(h2, generator=torch.Generator().manual_seed(SEED)).state_dict())
    v2 = mrf_phase(h2, sd2, mel_in[:1], dev, "V2", (torch.bfloat16,), (1,))
    errs[torch.bfloat16] = max(errs[torch.bfloat16], v2["errs"][torch.bfloat16])
    for b in BATCHES:
        for dt, r in (("bf16", mrf["per_batch"][b]), ("fp32", mrf["per_batch_fp32"][b])):
            print(f"B1 {dt} per V1 request at B={b}: kernel {r['ms']:.4f} ms over the "
                  f"{n_stages} stages, cudnn chain {r['library_ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    # ... and with the upsampler folded in (pre_pack) at the stages fold_up folds
    pre = pre_phase(h, sd, mel_in, dev, "V1", (torch.float32, torch.bfloat16), PRE_BATCHES)
    pre_v2 = pre_phase(h2, sd2, mel_in, dev, "V2", (torch.bfloat16,), PRE_BATCHES)
    pre_errs = {dt: max(pre["errs"].get(dt, 0.0), pre_v2["errs"].get(dt, 0.0))
                for dt in (torch.float32, torch.bfloat16)}
    for b in PRE_BATCHES:
        r = pre["per_batch"][b]
        print(f"B1 bf16 with pre_pack per V1 request at B={b} (the folded stages): kernel "
              f"{r['ms']:.4f} ms, without the upsampling phase {r['ms_without_pre']:.4f} ms, "
              f"cudnn chain (with the transposed convs) {r['library_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")

    lap("2 (B1 against its plain version)")

    # 3. serve requests through the port's main path, then with fold_up=True
    torch.cuda.empty_cache()
    fast = make_fast_vocoder(h, sd, dtype=torch.bfloat16)
    folded = make_fast_vocoder(h, sd, dtype=torch.bfloat16, fold_up=True)
    plain = Generator(h, folded=True)
    plain.load_state_dict(sd)
    plain = plain.to(dev).eval()
    serve, serve_fold_up = {}, {}
    mels = {b: (torch.randn((b, h["num_mels"], FRAMES), generator=mel_gen) * 2 - 5)
            for b in (1, 16)}
    outs, per_request = {}, {}
    tail.LAUNCHES = 0
    for b, m in mels.items():
        before = tail.LAUNCHES
        outs[b] = fast(m)
        per_request[str(b)] = tail.LAUNCHES - before
    torch.cuda.synchronize()
    launches = tail.LAUNCHES
    check(all(n == n_stages for n in per_request.values()),
          f"launches per request {per_request}, expected {n_stages} each")
    outs_fold, per_request_fold = {}, {}
    tail.LAUNCHES = 0
    for b, m in mels.items():
        before = tail.LAUNCHES
        outs_fold[b] = folded(m)
        per_request_fold[str(b)] = tail.LAUNCHES - before
    torch.cuda.synchronize()
    launches_fold_up = tail.LAUNCHES
    check(all(n == n_stages for n in per_request_fold.values()),
          f"fold_up launches per request {per_request_fold}, expected {n_stages} each")
    refs = {}
    for b, m in mels.items():
        with torch.no_grad():
            ref = refs[b] = plain(m.to(dev))
        ref_peak = ref.abs().max().item()
        check(ref_peak > 0, f"served B={b}: the fp32 Generator's waveform is silent")
        for tag, wav in (("", outs[b]), (" fold_up", outs_fold[b])):
            check(tuple(wav.shape) == (b, 1, FRAMES * hop), f"served{tag} shape {tuple(wav.shape)}")
            check(bool(torch.isfinite(wav).all()), f"served{tag} waveform has non-finite samples")
            check(wav.abs().max().item() <= 1.0, f"served{tag} waveform leaves [-1, 1]")
        req_ms = {"": [], " fold_up": []}
        for _ in range(SERVE_REPS[b]):  # the two paths in turn
            for tag, fn in (("", fast), (" fold_up", folded)):
                t0 = time.perf_counter()
                fn(m)
                torch.cuda.synchronize()
                req_ms[tag].append((time.perf_counter() - t0) * 1e3)
        for tag, wav in (("", outs[b]), (" fold_up", outs_fold[b])):
            diff = (wav - ref).abs()
            max_err, mean_err = diff.max().item(), diff.mean().item()
            ms = float(np.median(req_ms[tag]))
            rtf = b * FRAMES * hop / h["sampling_rate"] / (ms / 1e3)
            (serve_fold_up if tag else serve)[b] = ms
            extra = (f"; vs the unfolded path max_abs_err "
                     f"{(wav - outs[b]).abs().max().item():.3e}" if tag else "")
            print(f"serve{tag} B={b}: {ms:.3f} ms/request (median of {len(req_ms[tag])}), "
                  f"{rtf:.1f}x real time, launches per request "
                  f"{(per_request_fold if tag else per_request)[str(b)]}; vs fp32 Generator "
                  f"max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} (tol "
                  f"{SERVE_REL_TOL * ref_peak:.3e}, peak {ref_peak:.4f}){extra}")
            check(max_err <= SERVE_REL_TOL * ref_peak, f"served{tag} B={b} vs fp32 Generator: "
                                                       f"max {max_err} > {SERVE_REL_TOL} * {ref_peak}")
    del folded
    # ... and the fp32 body: the same requests in fp32, unfolded and with fold_up
    serve32 = serve_fp32_phase(h, sd, mels, refs, dev)

    lap("3 (serving)")

    # 3b. both streamers through the kernel at 32-frame chunks
    stream = stream_phase(h, sd, fast, plain, dev, mel_gen)
    del fast, plain
    torch.cuda.empty_cache()
    lap("3b (streamers)")

    # 4. the CLI end to end
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "wavs").mkdir()
        (tmp / "ckpt").mkdir()
        sr = h["sampling_rate"]
        tone = (0.5 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)).astype(np.float32)
        from hifigan_tpu_torch.audio import load_wav, save_wav

        save_wav(str(tmp / "wavs" / "tone.wav"), tone, sr)
        (tmp / "ckpt" / "config.json").write_text(json.dumps(h))
        torch.save({"generator": state_wn}, tmp / "ckpt" / "g_00000000")
        chunk = ["--streaming_chunk", str(STREAM_CHUNK)]
        for n, flags in enumerate((["--fast"], ["--fast", *chunk],
                                   ["--fast", *chunk, "--streaming_state"])):
            written = infer.inference(infer.build_parser().parse_args([
                "--input_wavs_dir", str(tmp / "wavs"), "--output_dir", str(tmp / f"out{n}"),
                "--checkpoint_file", str(tmp / "ckpt" / "g_00000000"), *flags]), h)
            check(len(written) == 1, f"cli {flags} wrote {written}")
            data, out_sr = load_wav(written[0])
            frames = sr // h["hop_size"]  # reflect pad (n_fft - hop) / 2 a side
            check(out_sr == sr and data.shape == (1, frames * hop),
                  f"cli {flags} wav {data.shape} @ {out_sr}")
            check(bool(np.isfinite(data).all()) and float(np.abs(data).max()) > 0,
                  f"cli {flags} wav silent")
            print(f"cli {' '.join(flags)} wrote {os.path.basename(written[0])}: "
                  f"{data.shape[1]} samples @ {out_sr} Hz")
        # the end-to-end CLI on a mel, vocoded in halo windows
        (tmp / "mels").mkdir()
        e2e_frames = 3 * STREAM_CHUNK + 7
        np.save(tmp / "mels" / "utt.npy", (torch.randn((h["num_mels"], e2e_frames),
                                                       generator=mel_gen) * 2 - 5).numpy())
        run_module(["hifigan_tpu_torch.cli.infer_e2e", "--input_mels_dir", str(tmp / "mels"),
                    "--output_dir", str(tmp / "e2e"), "--checkpoint_file",
                    str(tmp / "ckpt" / "g_00000000"), "--streaming_chunk", str(STREAM_CHUNK)],
                   f"cli.infer_e2e --streaming_chunk {STREAM_CHUNK}")
        data, out_sr = load_wav(str(tmp / "e2e" / "utt_generated_e2e.wav"))
        check(out_sr == sr and data.shape == (1, e2e_frames * hop),
              f"infer_e2e --streaming_chunk wav {data.shape} @ {out_sr}")
        check(bool(np.isfinite(data).all()) and float(np.abs(data).max()) > 0,
              "infer_e2e --streaming_chunk wav silent")
        print(f"cli.infer_e2e --streaming_chunk {STREAM_CHUNK} wrote {data.shape[1]} samples "
              f"({e2e_frames} frames x {hop})")
    lap("4 (inference CLIs)")

    # 5. the conv-stack kernels against their plain versions, every V1 MSD scale
    torch.cuda.empty_cache()
    msd = MultiScaleDiscriminator(generator=torch.Generator().manual_seed(SEED)).to(dev)
    stack = stack_phase(msd, dev)
    # ... and the zone form: the V1 zone chain at the three scales
    zone = zone_phase(msd, dev)
    del msd
    torch.cuda.empty_cache()
    lap("5 (B2 against its plain version)")

    # 6. V1 train steps through the port's main training path (its pools
    # held against the CPU first)
    pool_reading(dev)
    v1_ref = v1_step_reference(h)
    train = train_phase(h, dev, v1_ref)
    torch.cuda.empty_cache()
    # ... and in bench.py's bf16 training precision
    train_bf16 = train_bf16_phase(h, dev)
    torch.cuda.empty_cache()
    # ... and under the two other discriminator forms, in turns with phase 6's
    forms = v1_forms_phase(h, dev, zone["geoms"], train["update_floor"])
    lap("6 (V1 training)")

    # 7. the training CLI end to end
    cli_train_phase(h)
    lap("7 (training CLI)")

    # 8. the stream-graph kernels against their plain versions, every segment of a member
    distill_cfg = json.loads((REPO / "configs" / "distill.json").read_text())
    models = distill_models(distill_cfg, dev)
    models.build(distill_cfg["loops"]["train"]["segment_length"], seed=SEED)
    graph = stream_graph_phase(models, dev)
    del models
    torch.cuda.empty_cache()
    lap("8 (B3 against its plain version)")

    # 9. production distillation train steps through the port's main path
    distill = distill_phase(distill_cfg, dev)
    torch.cuda.empty_cache()
    lap("9 (distillation steps)")

    # 10. the per-layer conv kernels against their plain versions: every V1
    # MSD layer, every distinct distill conv geometry
    msd = MultiScaleDiscriminator(generator=torch.Generator().manual_seed(SEED)).to(dev)
    per_layer = msd_conv_phase(msd, distill_cfg, dev)
    del msd
    torch.cuda.empty_cache()
    lap("10 (B5 against its plain version)")

    # 11. V1 train steps with msd_conv_impl='pallas'
    train_b5 = train_phase(h, dev, v1_ref, msd_impl="pallas")
    del v1_ref
    torch.cuda.empty_cache()
    lap("11 (V1 training through B5)")

    # 12. production distillation train steps with conv_impl='pallas'
    distill_b5 = distill_phase(distill_cfg, dev, conv_impl="pallas")
    torch.cuda.empty_cache()
    lap("12 (distillation through B5)")

    # 13. mel extraction through the fused log-mel kernel
    mel = logmel_phase(h, dev)
    torch.cuda.empty_cache()
    lap("13 (B4)")

    # 14. the distillation autoencoder served through its CLI, the encoder's
    # and decoder's narrow runs through the stream-graph kernel
    auto_enc = autoencode_phase(distill_cfg, dev)
    torch.cuda.empty_cache()
    lap("14 (autoencoder CLI)")

    # 15. production distillation train steps with models.stream_impl 'fused'
    distill_sf = distill_phase(distill_cfg, dev, stream_impl="fused", keep_state=True)
    torch.cuda.empty_cache()
    lap("15 (distillation with stream fusion)")

    # 16. the validation eval step and the sniffer trainer
    eval_sn = eval_sniffer_phase(distill_sf, distill_cfg, dev)
    del distill_sf["state"], distill_sf["trainer"]
    torch.cuda.empty_cache()
    lap("16 (eval and sniffer steps)")

    # 17. distillation training from its entry point on a seeded corpus
    dmain = distill_main_phase(distill_cfg, dev, distill["step_ms"])
    lap("17 (distill.main, warm_cache, train_sniffers)")

    # 18. the parallel path: the world-1 NCCL mesh, DP V1 and distill steps
    # through the batch-sharded B2 and B3, their splits held block by block
    par = parallel_phase(h, sd, distill_cfg, dev, card, train, distill)
    torch.cuda.empty_cache()
    lap("18 (parallel)")

    bound_ms = max(request["ops"] / H100_BF16_FLOPS, request["bytes"] / H100_BYTES_PER_S) * 1e3
    kernels = [{
        "name": "fused_tail_stage",
        "route": "cuda",
        "source": "hifigan_tpu_torch/csrc/resblock_tail.cu",
        "replaces": "hifigan_tpu/ops/pallas/resblock_tail.py:152",
        "launches": launches,
        "launches_per_request": per_request,
        "max_abs_err": errs[torch.float32],
        "max_abs_err_bf16": errs[torch.bfloat16],
        "ms": request["ms"],
        "kernel_ms": request["ms"],
        "plain_ms": request["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": ("operations" if request["ops"] / H100_BF16_FLOPS
                     >= request["bytes"] / H100_BYTES_PER_S else "bytes"),
        "library_ms": request["library_ms"],
        "per": ("launches: the main path's run of two requests (B=1 and B=16), "
                "launches_per_request: each; times and bound: one V1 B=1 256-frame request, "
                "4 stage calls, bf16 (per_batch: the same at B=1, 4, 16); max_abs_err: fp32 "
                "(the 3xTF32 body, row fused_tail_stage.fp32), max_abs_err_bf16: every V1 "
                "stage at B=1, 4, 16 and every V2 stage at B=1"),
        "redesigned": ("bf16: mma.sync tensor-core conv core, one cooperative launch per stage "
                       "walking the whole sequence conv by conv (no halo recompute)"),
        "per_batch": {str(b): {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                      for b, r in mrf["per_batch"].items()},
        "fp32_per_batch": {str(b): {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                           for b, r in mrf["per_batch_fp32"].items()},
        "serve_ms": serve,
        "pre_pack": {
            "max_abs_err": pre_errs[torch.float32],
            "max_abs_err_bf16": pre_errs[torch.bfloat16],
            "per_batch": {str(b): {k: r[k] for k in ("ms", "ms_without_pre", "plain_ms",
                                                     "library_ms", "bound_ms")}
                          for b, r in pre["per_batch"].items()},
            "launches_fold_up": launches_fold_up,
            "launches_per_request_fold_up": per_request_fold,
            "serve_fold_up_ms": serve_fold_up,
            "per": ("per_batch: bf16 at V1 stages 2 and 3 (the stages fold_up folds), with the "
                    "upsampling phase (ms), the same kernel on the upsampled input "
                    "(ms_without_pre), the plain version, the cuDNN chain with the transposed "
                    "convs, the bound with the upsampler's work; errors over V1 and V2 stages "
                    "2-3 at B=1, 4, 16 and a ragged T_in; launches_fold_up: the fold_up serving "
                    "path's run of two requests (B=1 and B=16)"),
        },
        "streaming": {
            "delay_samples": stream["delay_samples"],
            "launches": stream["launches"],
            "halo_launches": stream["halo_launches"],
            "fp32_launches": stream["fp32_launches"],
            "ms_per_chunk": stream["ms_per_chunk"],
            "halo_ms_per_chunk": stream["halo_ms_per_chunk"],
            "per": (f"launches: the stateful streamer's run ({STREAM_FRAMES} frames in "
                    f"{STREAM_CHUNK}-frame chunks at B=1 and B=4, bf16), halo_launches: the halo "
                    "streamer's over the same mels, fp32_launches: the fp32 stateful pass"),
        },
    }]
    kernels += fp32_tail_entries(mrf, pre, serve32, stream, pre_errs)
    rows = [r for r in stack["per_scale"] if r["dtype"] == "float32"]
    stack_ms = 0.0
    for kind, line in (("fwd", 374), ("bwd_dx", 596), ("bwd_dw", 596)):
        n = PASSES_PER_STEP[kind]
        ops_ms = sum(n * r["flop"] for r in rows) / FP32_MMA_FLOPS * 1e3
        bytes_ms = sum(n * r["bytes"][kind] for r in rows) / H100_BYTES_PER_S * 1e3
        entry = {
            "name": f"fused_conv_stack.{kind}",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/conv_stack.cu",
            "replaces": f"hifigan_tpu/ops/pallas/conv_stack.py:{line}",
            "launches": train["launches"][kind],
            "launches_per_step": train["per_step"][kind],
            "max_abs_err": stack["errs"][torch.float32][kind],
            "max_abs_err_bf16": stack["errs"][torch.bfloat16][kind],
        }
        for key in ("ms", "plain_ms", "library_ms"):
            entry[key] = sum(n * r[key][kind] for r in rows)
        entry["bound_ms"] = max(ops_ms, bytes_ms)
        entry["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        rows_bf = [r for r in stack["per_scale"] if r["dtype"] == "bfloat16"]
        entry["bf16"] = {key: sum(n * r[key][kind] for r in rows_bf)
                         for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        entry["launches_bf16_train"] = train_bf16["launches"][kind]
        entry["redesigned"] = ("one implicit-GEMM core (csrc/conv_core.cuh) on mma.sync tensor "
                               "cores, 3xTF32 in fp32 and bf16 mma in bf16: input windows staged "
                               "once per tile for all taps, weights through a cp.async ring, dx "
                               "per output phase, dz formed once, dW in a few splits summed in a "
                               "fixed order; conv_post on the SIMT path")
        entry["per"] = (f"launches: the main path's run of {TRAIN_STEPS} V1 train steps; times and "
                        f"bound: one V1 train step (B=16, 8192 samples, fp32, {n} passes per MSD "
                        "scale; bound: operations at the 3xTF32 rate, 3 x FLOP at 495 TFLOP/s), "
                        "from CUDA-event times of one pass at each scale; bf16: the same in "
                        "bf16; launches_bf16_train: the bf16 training run; max_abs_err: "
                        "over the three scales at N=2 and N=16 (function :973)")
        stack_ms += entry["ms"]
        kernels.append(entry)
    kernels += zone_entries(zone, forms)
    sg_ms = 0.0
    for kind, line in (("fwd", 388), ("bwd_dx", 600), ("bwd_dw", 600)):
        rows = graph["rows"]
        bound, bound_by = segment_bound([r["cost"] for r in rows], kind)
        entry = {
            "name": f"fused_stream_graph.{kind}",
            "route": "cuda",
            "source": "hifigan_tpu_torch/csrc/stream_graph.cu",
            "replaces": f"hifigan_tpu/ops/pallas/stream_graph.py:{line}",
            "launches": distill["launches"][kind],
            "launches_per_step": distill["per_step"][kind],
            "max_abs_err": graph["errs"][torch.float32][kind],
            "max_abs_err_bf16": graph["errs"][torch.bfloat16][kind],
            "ms": sum(r["ms"][kind] for r in rows),
            "plain_ms": sum(r["plain_ms"][kind] for r in rows),
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": graph["library_ms"][kind],
            "host_ms": distill["sg_host_ms"][kind] * len(rows) / distill["per_step"][kind],
            "launches_distill_main": dmain["launches"][kind],
            "launches_per_step_distill_main": dmain["per_step"][kind],
            "redesigned": ("one cooperative launch per segment and pass: units of tiles in "
                           "phases between grid barriers, tiles shaped by the op (all of c_out "
                           "a thread up to 4 channels), input windows staged once per tile, dW "
                           "split partials summed in split order in the same launch"),
            "per": (f"launches: the main path's run of {DISTILL_STEPS} distill steps (one per "
                    f"segment and pass); times and bound: one pass over the 10 segments of the "
                    f"3-member discriminator at {SG_ELEMENTS} elements x 43,680 samples, fp32 "
                    "(library: the interpreter's cuDNN conv chain over the same discriminator); "
                    "host_ms: the host time of the wrapper and launch functions for the "
                    "10 launches of a pass in the distill steps, the segments built anew each "
                    "call; launches_distill_main: the in-process distill.main.train() run of "
                    f"{TRAIN_IN_PROCESS_STEPS} steps on the corpus of phase 17 (its sanity "
                    "validation's eval step included); max_abs_err: every "
                    "segment (function :786)"),
        }
        sg_ms += entry["ms"]
        kernels.append(entry)
    kernels += stream_fusion_entries(auto_enc, distill_sf)
    kernels += per_layer_and_mel_entries(per_layer, train_b5, distill_b5, mel)
    kernels += parallel_entries(par)
    b5_ms = sum(e["ms"] for e in kernels if e["name"].startswith("msd_conv1d_lrelu."))
    print(f"V1 train step with msd_conv_impl='pallas' {train_b5['step_ms']:.3f} ms, of which the "
          f"per-layer conv kernels {b5_ms:.3f} ms ({100 * b5_ms / train_b5['step_ms']:.1f}%, "
          f"from per-pass times); distill "
          f"step with conv_impl='pallas' {distill_b5['step_ms']:.3f} ms; "
          f"{per_layer['distill_geoms']} distinct distill conv geometries held")
    print(f"distill step {distill['step_ms']:.3f} ms; one {SG_ELEMENTS}-element discriminator "
          f"traversal's stream-graph passes {sg_ms:.3f} ms; profiled step "
          f"{json.dumps(distill['share'])}")
    print(f"distill step with stream_impl='fused' {distill_sf['step_ms']:.3f} ms (launches per "
          f"step {distill_sf['per_step']}); eval step {eval_sn['eval_ms']:.3f} ms; autoencode "
          f"B=1 {auto_enc['per_batch'][1]['autoencode_ms']['fused']:.3f} ms fused, "
          f"{auto_enc['per_batch'][1]['autoencode_ms']['auto']:.3f} ms auto")
    print(f"distill.main.train() on the phase-17 corpus {dmain['through_ms']:.3f} ms a step "
          f"(the step {dmain['step_ms']:.3f} ms, the data engine {dmain['data_ms']:.3f} ms a "
          f"batch) against phase 9's bare step {distill['step_ms']:.3f} ms")
    zl = forms["fused_zoned"]
    print(f"train step with msd_conv_impl='fused_zoned' {zl['step_ms']:.3f} ms (in turns, "
          f"'fused_stack' {zl['std_step_ms']:.3f} ms); with disc_fused "
          f"{forms['disc_fused']['step_ms']:.3f} ms (in turns, "
          f"{forms['disc_fused']['std_step_ms']:.3f} ms)")
    print(f"train step {train['step_ms']:.3f} ms, of which the conv-stack kernels "
          f"{stack_ms:.3f} ms ({100 * stack_ms / train['step_ms']:.1f}%, from per-pass times); "
          f"bf16 train step {train_bf16['step_ms']:.3f} ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the kernels' build "
          f"{build_s:.1f} s of it")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
