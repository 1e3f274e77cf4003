#!/usr/bin/env python3
"""Time the log-mel kernel's FFT body at every frame count a geometry's
buffers allow, on the card.

    python3 tools/logmel_frames_sweep.py [rounds]

For each geometry (n_fft = 4 hop, 80 mels, 16 x 10 s of seeded audio at its
sampling rate) and each frame count of 8, 4 and 2 whose buffers
(``ops/logmel.py::fft_smem_bytes``) fit SMEM_LIMIT, the FFT entry is
launched through ctypes on the signal padded once, its output compared with
that of the count ``plan`` picks, then timed in rounds (each count in turn,
then in reverse; CUDA events over 20 launches). Prints the card's name and
power limit and one JSON line a geometry: ``{"n_fft", "rate", "route",
"length", "plan_frames", "ms", "runs", "max_abs_diff"}`` (``ms`` the median
per frame count, ``runs`` every run).
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hifigan_tpu_torch.audio.mel import MelConfig  # noqa: E402
from hifigan_tpu_torch.ops import logmel  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

REPS = 20
GEOMETRIES = ((1024, 22050), (1200, 22050), (1100, 22050), (1764, 44100), (1028, 22050),
              (1088, 22050), (2068, 22050), (3200, 22050), (4096, 22050))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no reading")
    launch = logmel._kernels()["fft"]
    for n_fft, rate in GEOMETRIES:
        cfg = MelConfig(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4, sampling_rate=rate,
                        method="pallas")
        route, length, plan_frames = logmel.plan(cfg)
        assert route in ("fft", "bluestein"), (n_fft, route)
        counts = [f for f in logmel.FRAME_CHOICES
                  if logmel.fft_smem_bytes(cfg, f, length) <= logmel.SMEM_LIMIT]
        rng = np.random.default_rng(n_fft)
        y = torch.from_numpy((rng.standard_normal((16, 10 * rate)) * 0.3).clip(-1, 1)
                             .astype(np.float32)).to(dev)
        yp, frames = logmel._pad_crop(y, cfg)
        ptrs = [None if t is None else t.data_ptr() for t in logmel._device_tables(cfg, dev)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = {f: torch.empty((16, cfg.num_mels, frames), device=dev) for f in counts}

        def runner(f):
            smem = logmel.fft_smem_bytes(cfg, f, length)

            def run():
                rc = launch(yp.data_ptr(), *ptrs, outs[f].data_ptr(), 16, frames, yp.shape[1],
                            cfg.hop_size, n_fft, length, f, cfg.num_mels, smem, stream)
                if rc != 0:
                    raise RuntimeError(f"launch at {f} frames failed: cudaError {rc}")
            return run

        runs = {f: [] for f in counts}
        with torch.no_grad():
            for f in counts:
                runner(f)()
            diff = {f: (outs[f] - outs[plan_frames]).abs().max().item() for f in counts}
            for _ in range(rounds):
                for f in counts + counts[::-1]:
                    runs[f].append(cs.time_ms(runner(f), REPS))
        print(json.dumps({"n_fft": n_fft, "rate": rate, "route": route, "length": length,
                          "plan_frames": plan_frames,
                          "ms": {f: statistics.median(r) for f, r in runs.items()},
                          "runs": runs, "max_abs_diff": diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
