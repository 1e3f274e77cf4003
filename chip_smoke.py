#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``hifigan_tpu_torch/csrc`` (nvcc, sm_90a,
into the git-ignored ``build/kernels``), then:

1. prints the card's name and power limit and the kernels' build time;
2. holds the fused MRF-stage kernel against its plain PyTorch version at
   every V1 stage, full width, at the lengths of a 256-frame request, B=1,
   B=4 and B=16 (the batches whose tiles the main path uses): fp32 with TF32 off within 1e-4, bf16 within BF16_REL_TOL of
   the plain version's peak (see below); prints errors and times;
3. serves V1 mel->wav requests of (1, 80, 256) and (16, 80, 256) through
   ``make_fast_vocoder`` in bf16 with seeded random weights, with the
   launch counts set to 0 just before and read just after (and after each
   request); checks shapes, finiteness, the [-1, 1] range and the error
   against the plain fp32 ``Generator`` within SERVE_REL_TOL of its peak;
   prints ms per request and the real-time factor;
4. runs ``python -m hifigan_tpu_torch.cli.infer --fast`` end to end on a
   synthetic sine wav with a torch ``g_*`` file and ``config.json``;
5. prints one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line last.

Any failed check raises: the script then exits non-zero and prints no ok
line. Without a CUDA device, or without the package beside it, it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
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
H100_BF16_FLOPS, H100_FP32_FLOPS, H100_BYTES_PER_S = 989e12, 67e12, 3.35e12


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


def stage_cost(packed: dict, batch: int, seq: int, esize: int, post: bool) -> tuple[int, int]:
    """(operations, bytes) one stage call must do and move: x and the weights
    read once, the output written once."""
    c = packed["channels"]
    taps = sum(k for k, _, _ in packed["convs"])
    ops = 2 * batch * seq * taps * c * c + (2 * batch * seq * 7 * c if post else 0)
    wbytes = (packed["w"].numel() + packed["bias"].numel() + (7 * c + 1 if post else 0)) * esize
    out_bytes = batch * seq * 4 if post else batch * seq * c * esize
    return ops, batch * seq * c * esize + wbytes + out_bytes


def main() -> int:
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
    from hifigan_tpu_torch.models import Generator, fold_weight_norm
    from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
    from hifigan_tpu_torch.ops import _build
    from hifigan_tpu_torch.ops import conv as ops
    from hifigan_tpu_torch.ops import resblock_tail as tail

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0]
    print(f"card: {card}")
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
    h = get_config("v1")
    hop = int(np.prod(h["upsample_rates"]))
    gen_w = Generator(h, generator=torch.Generator().manual_seed(SEED))
    state_wn = gen_w.state_dict()
    sd = fold_weight_norm(state_wn)
    n_stages = len(h["upsample_rates"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. kernel vs plain version, every V1 stage at full width
    mel_gen = torch.Generator().manual_seed(SEED + 1)
    mel_in = (torch.randn((max(BATCHES), h["num_mels"], FRAMES), generator=mel_gen) * 2 - 5).to(dev)
    stage_inputs = []
    with torch.no_grad():
        x = ops.conv1d(mel_in.transpose(1, 2), sd["conv_pre.weight"].to(dev).permute(2, 1, 0),
                       sd["conv_pre.bias"].to(dev), padding=3)
        for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
            x = ops.conv_transpose1d(ops.leaky_relu(x), sd[f"ups.{i}.weight"].to(dev).permute(2, 0, 1),
                                     sd[f"ups.{i}.bias"].to(dev), stride=u,
                                     padding=(k - u) // 2).contiguous()
            stage_inputs.append(x)
            x = tail.fused_tail_stage_reference(x, tail.pack_generator_tail(h, sd, i, device=dev))

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    request = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops": 0, "bytes": 0}
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.tensor([], dtype=dtype).element_size()
        for i in range(n_stages):
            post = i == n_stages - 1
            packed = tail.pack_generator_tail(h, sd, i, dtype=dtype, device=dev)
            post_pack = tail.prepare_post(sd, dtype=dtype, device=dev) if post else None
            lib_convs = []
            for rb in range(packed["n_rb"]):
                for j in range(packed["convs_per_rb"]):
                    k, d, off = packed["convs"][rb * packed["convs_per_rb"] + j]
                    c = packed["channels"]
                    w = packed["w"][off:off + k * c * c].view(k, c, c).permute(2, 1, 0).contiguous()
                    lib_convs.append((w, packed["bias"][rb * packed["convs_per_rb"] + j], d))
            lib_post = ((post_pack["w"].t()[None].contiguous(), post_pack["bias"])
                        if post else None)
            for batch in BATCHES:
                xs = stage_inputs[i][:batch].to(dtype).contiguous()
                with torch.no_grad():
                    got = tail.fused_tail_stage(xs, packed, post_pack=post_pack)
                    torch.cuda.synchronize()
                    ref = tail.fused_tail_stage_reference(xs, packed, post_pack)
                    xc = xs.transpose(1, 2).contiguous()
                    lib = library_mrf(xc, lib_convs, packed["n_rb"], packed["pair_size"], lib_post)
                check(got.shape == ref.shape and got.dtype == ref.dtype,
                      f"stage {i} {dtype} B={batch}: {tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got).all()), f"stage {i} {dtype} B={batch}: non-finite")
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
                peak_rate = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
                bound = max(ops_n / peak_rate, bytes_n / H100_BYTES_PER_S) * 1e3
                print(f"stage {i} C={packed['channels']} T={xs.shape[1]} B={batch} "
                      f"{str(dtype)[6:]}{' +post' if post else ''}: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}, peak {peak:.3f}, cudnn chain {lib_err:.3e}) "
                      f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms cudnn {l_ms:.4f} ms "
                      f"bound {bound:.4f} ms ({ops_n / k_ms / 1e9:.2f} TFLOP/s)")
                check(err <= tol, f"stage {i} {dtype} B={batch}: error {err} > {tol}")
                errs[dtype] = max(errs[dtype], err)
                if dtype == torch.bfloat16 and batch == 1:
                    request["ms"] += k_ms
                    request["plain_ms"] += p_ms
                    request["library_ms"] += l_ms
                    request["ops"] += ops_n
                    request["bytes"] += bytes_n

    # 3. serve requests through the port's main path
    torch.cuda.empty_cache()
    fast = make_fast_vocoder(h, sd, dtype=torch.bfloat16)
    plain = Generator(h, folded=True)
    plain.load_state_dict(sd)
    plain = plain.to(dev).eval()
    serve = {}
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
    for b, m in mels.items():
        wav = outs[b]
        check(tuple(wav.shape) == (b, 1, FRAMES * hop), f"served shape {tuple(wav.shape)}")
        check(bool(torch.isfinite(wav).all()), "served waveform has non-finite samples")
        check(wav.abs().max().item() <= 1.0, "served waveform leaves [-1, 1]")
        with torch.no_grad():
            ref = plain(m.to(dev))
        diff = (wav - ref).abs()
        max_err, mean_err = diff.max().item(), diff.mean().item()
        ref_peak = ref.abs().max().item()
        check(ref_peak > 0, f"served B={b}: the fp32 Generator's waveform is silent")
        req_ms = []
        for _ in range(5 if b == 1 else 3):
            t0 = time.perf_counter()
            fast(m)
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(req_ms))
        rtf = b * FRAMES * hop / h["sampling_rate"] / (ms / 1e3)
        serve[b] = ms
        print(f"serve B={b}: {ms:.3f} ms/request (median of {len(req_ms)}), "
              f"{rtf:.1f}x real time; vs fp32 Generator max_abs_err {max_err:.3e} "
              f"mean_abs_err {mean_err:.3e} (tol {SERVE_REL_TOL * ref_peak:.3e}, "
              f"peak {ref_peak:.4f})")
        check(max_err <= SERVE_REL_TOL * ref_peak,
              f"served B={b} vs fp32 Generator: max {max_err} > {SERVE_REL_TOL} * {ref_peak}")

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
        written = infer.inference(infer.build_parser().parse_args([
            "--input_wavs_dir", str(tmp / "wavs"), "--output_dir", str(tmp / "out"),
            "--checkpoint_file", str(tmp / "ckpt" / "g_00000000"), "--fast"]), h)
        check(len(written) == 1, f"cli wrote {written}")
        data, out_sr = load_wav(written[0])
        frames = sr // h["hop_size"]  # reflect pad (n_fft - hop) / 2 a side
        check(out_sr == sr and data.shape == (1, frames * hop), f"cli wav {data.shape} @ {out_sr}")
        check(bool(np.isfinite(data).all()) and float(np.abs(data).max()) > 0, "cli wav silent")
        print(f"cli --fast wrote {os.path.basename(written[0])}: {data.shape[1]} samples @ {out_sr} Hz")

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
                "launches_per_request: each; times, errors and bound: one V1 B=1 "
                "256-frame request, 4 stage calls, bf16 (max_abs_err: fp32)"),
        "serve_ms": serve,
    }]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
