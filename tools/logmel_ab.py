#!/usr/bin/env python3
"""Time the log-mel kernel of this checkout against another checkout's, in
turns on one card.

    python3 tools/logmel_ab.py OTHER_CSRC [rounds]

``OTHER_CSRC`` is the ``hifigan_tpu_torch/csrc`` directory of the other
checkout (unpack it into a git-ignored directory, e.g. ``git archive
<commit> hifigan_tpu_torch/csrc | tar -x -C build/parent``). Its
``logmel.cu`` must have the FFT entry with 8 frames a block and no
Bluestein tables (``hifigan_logmel_fft(sig, window, twiddle, mel_idx,
fb_vals, out, batch, F, L, hop, n_fft, mels, smem, stream)``). It is built
with ``ops/_build.py``'s nvcc flags into the git-ignored ``build/ab/``.

At the geometries both take on the FFT body with 8 frames a block (n_fft
1024 / hop 256 and 1200 / 300, 80 mels, 16 x 10 s at 22,050 Hz), both
kernels run on the same padded signal and tables: their outputs are
compared, then each round times other, this, this, other (CUDA events, 20
launches each through ctypes on the signal padded once, so the two differ
only in their kernels). Prints the card's name
and power limit and one JSON line per geometry: ``{"n_fft", "this_ms",
"other_ms", "this_runs", "other_runs", "max_abs_diff"}`` (medians, then
every run).
"""

from __future__ import annotations

import ctypes
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
from hifigan_tpu_torch.ops import _build  # noqa: E402
from hifigan_tpu_torch.ops import logmel  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

REPS = 20


def build_other(csrc: Path) -> ctypes.CDLL:
    out = HERE / "build" / "ab" / "liblogmel_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(csrc / "logmel.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the other logmel.cu did not build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hifigan_logmel_fft.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    lib.hifigan_logmel_fft.restype = ci
    return lib


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    other = build_other(Path(sys.argv[1]).resolve())
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no reading")
    rng = np.random.default_rng(1234)
    y = torch.from_numpy((rng.standard_normal((16, 220500)) * 0.3).clip(-1, 1)
                         .astype(np.float32)).to(dev)
    for n_fft in (1024, 1200):
        cfg = MelConfig(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4, method="pallas")
        assert logmel.plan(cfg) == ("fft", n_fft, 8), logmel.plan(cfg)
        window, twiddle, chirp, filt, idx, vals = logmel._device_tables(cfg, dev)
        assert chirp is None and filt is None
        smem = logmel.fft_smem_bytes(cfg, 8, n_fft)
        stream = torch.cuda.current_stream(dev).cuda_stream
        yp, frames = logmel._pad_crop(y, cfg)
        head = (yp.data_ptr(), window.data_ptr(), twiddle.data_ptr())
        tail = (idx.data_ptr(), vals.data_ptr())
        dims = (y.shape[0], frames, yp.shape[1], cfg.hop_size, n_fft)
        outs = {k: torch.empty((y.shape[0], cfg.num_mels, frames), device=dev)
                for k in ("this", "other")}
        this = logmel._kernels()["fft"]

        def run_other():
            rc = other.hifigan_logmel_fft(*head, *tail, outs["other"].data_ptr(), *dims,
                                          cfg.num_mels, smem, stream)
            if rc != 0:
                raise RuntimeError(f"the other kernel's launch failed: cudaError {rc}")

        def run_this():
            rc = this(*head, None, None, *tail, outs["this"].data_ptr(), *dims, n_fft, 8,
                      cfg.num_mels, smem, stream)
            if rc != 0:
                raise RuntimeError(f"this kernel's launch failed: cudaError {rc}")

        with torch.no_grad():
            run_this()
            run_other()
            diff = (outs["this"] - outs["other"]).abs().max().item()
            this_runs, other_runs = [], []
            for _ in range(rounds):
                other_runs.append(cs.time_ms(run_other, REPS))
                this_runs.append(cs.time_ms(run_this, REPS))
                this_runs.append(cs.time_ms(run_this, REPS))
                other_runs.append(cs.time_ms(run_other, REPS))
        print(json.dumps({"n_fft": n_fft, "this_ms": statistics.median(this_runs),
                          "other_ms": statistics.median(other_runs), "this_runs": this_runs,
                          "other_runs": other_runs, "max_abs_diff": diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
