#!/usr/bin/env python3
"""Time the production distillation train step of a checkout, on the card.

    python3 tools/distill_step_time.py [checkout]

Imports ``hifigan_tpu_torch`` from ``checkout`` (default: this repository)
and this repository's ``chip_smoke.py``, so two commits can be compared on
one card in one call: unpack the other one into a git-ignored directory and
run the two in turns (A, B, B, A). Builds ``configs/distill.json`` as
``chip_smoke.py`` phase 9 does (seeded weights, synthetic audio, the label
set of ``bench.py``, gradient accumulation cut to 1), runs 8 steps (fp32,
TF32 off) and one more under ``torch.profiler`` (``chip_smoke.profile_step``),
and prints one line: ``{"checkout", "step_ms", "median_3_8", "busy_ms",
"sg_ms", "events", "idle"}`` (the median of steps 3-8 on the host clock
after a synchronize; device busy time, the stream-graph kernels' share,
device events and the idle share from the profiled step).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hifigan_tpu_torch.distill.train import DistillTrainer  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

STEPS = 8


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = json.loads((ROOT / "configs" / "distill.json").read_text())
    cfg["learning"]["accumulated_grad_batches"] = 1
    models = cs.distill_models(cfg, dev)
    trainer = DistillTrainer(models, cfg)
    state = trainer.create_state(seed=cs.SEED)
    bsz, seg_len = trainer.batch_size, trainer.segment_length
    t_emb = seg_len // models.embedding_size
    rng = np.random.default_rng(cs.SEED + 40)
    batches = [{"audio": cs.synthetic_audio(bsz, seg_len, cfg["sampling_rate"], cs.SEED + 41 + i),
                "time_labels": {g: {k: rng.integers(0, len(v), (bsz, t_emb))
                                    for k, v in group.items()}
                                for g, group in cs.DISTILL_LABELS.items()}}
               for i in range(STEPS + 1)]
    step = trainer.make_train_step()
    ms = []
    for batch in batches[:STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(ms[2:]))
    state, share = cs.profile_step(step, state, batches[STEPS], median, str(ROOT))
    print(json.dumps({"checkout": str(ROOT), "step_ms": [round(x, 3) for x in ms],
                      "median_3_8": median, "busy_ms": share["step_device_ms"],
                      "sg_ms": share["sg_device_ms"], "events": share["device_events"],
                      "idle": share["idle_share"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
