#!/usr/bin/env python3
"""Time the fp32 MRF-stage kernel's two occupancy plans against each other, on the card.

    python3 tools/mrf_f32_sweep.py [out.json]

For every stage of the V1 generator (full width, seeded weights, the
stage's input from a seeded 256-frame mel), at B = 1, 4 and 16, builds the
two plans of ``ops/resblock_tail.py::plan_tail_stage``'s fp32 body: the
kernel compiled for one block an SM with the widest channel chunk that fits
227 KB, and the kernel compiled for two blocks an SM with the widest chunk
that fits half an SM's shared memory. Holds each against the plain version
(1e-4), times both with CUDA events in turns (one, two, two, one, twice),
and prints one line per (stage, batch) with both medians, each plan's
grid, chunk and shared memory, and the plan the planner picks. Writes all
of it as JSON (default ``build/mrf_f32_sweep.json``). The planner's rule
(two blocks an SM where the busiest phase has two tiles for each SM) was
read off this sweep.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("mrf_f32_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hifigan_tpu_torch.config import get_config
    from hifigan_tpu_torch.models import Generator, fold_weight_norm
    from hifigan_tpu_torch.ops import conv as ops
    from hifigan_tpu_torch.ops import resblock_tail as tail

    out_path = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build" / "mrf_f32_sweep.json"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h = get_config("v1")
    sd = fold_weight_norm(Generator(h, generator=torch.Generator().manual_seed(1234)).state_dict())
    mel = (torch.randn((16, h["num_mels"], 256), generator=torch.Generator().manual_seed(1235))
           * 2 - 5).to(dev)
    sms = tail._sm_count(0)
    occ = functools.partial(tail._blocks_per_sm, 0)
    planner = tail.plan_tail_stage

    def plan_for(packed, batch, seq, post, minb):
        """The fp32 plan with the kernel compiled for ``minb`` blocks an SM."""
        base = planner(packed, batch, seq, torch.float32, post, sms, occ)
        limit = tail.SMEM_LIMIT if minb == 1 else tail.SM_SMEM // 2 - 1024
        shapes = tail.f32_convs(packed, batch, seq)
        kc = tail.f32_chunk(shapes, limit)
        if kc is None:
            return None
        smem = tail.f32_smem(shapes, kc)
        grid = min(base["items"], occ(packed["channels"], smem, minb) * sms)
        return dict(base, minb=minb, kc=kc, smem=smem, grid=grid)

    rows = []
    with torch.no_grad():
        x = ops.conv1d(mel.transpose(1, 2), sd["conv_pre.weight"].to(dev).permute(2, 1, 0),
                       sd["conv_pre.bias"].to(dev), padding=3)
        n_stages = len(h["upsample_rates"])
        for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
            up_w = sd[f"ups.{i}.weight"].to(dev).permute(2, 0, 1)
            x = ops.conv_transpose1d(ops.leaky_relu(x), up_w, sd[f"ups.{i}.bias"].to(dev),
                                     stride=u, padding=(k - u) // 2).contiguous()
            packed = tail.pack_generator_tail(h, sd, i, device=dev)
            post = i == n_stages - 1
            post_pack = tail.prepare_post(sd, device=dev) if post else None
            for batch in (1, 4, 16):
                xs = x[:batch].contiguous()
                ref = tail.fused_tail_stage_reference(xs, packed, post_pack)
                chosen = planner(packed, batch, xs.shape[1], torch.float32, post, sms, occ)
                plans = {m: plan_for(packed, batch, xs.shape[1], post, m) for m in (1, 2)}
                times = {m: [] for m in plans if plans[m] is not None}
                try:
                    for order in ((1, 2, 2, 1), (1, 2, 2, 1)):
                        for m in order:
                            if m not in times:
                                continue
                            tail.plan_tail_stage = lambda *a, _p=plans[m], **kw: _p
                            got = tail.fused_tail_stage(xs, packed, post_pack=post_pack)
                            err = (got - ref).abs().max().item()
                            if err > 1e-4:
                                raise RuntimeError(f"stage {i} B={batch} minb {m}: error {err}")
                            times[m].append(time_ms(
                                lambda: tail.fused_tail_stage(xs, packed, post_pack=post_pack),
                                10 if batch == 1 else 3))
                finally:
                    tail.plan_tail_stage = planner
                row = {"stage": i, "batch": batch, "seq": xs.shape[1],
                       "chosen_minb": chosen["minb"], "items": chosen["items"],
                       "plans": {str(m): {k: p[k] for k in ("minb", "kc", "smem", "grid")}
                                 for m, p in plans.items() if p is not None},
                       "ms": {str(m): float(np.median(t)) for m, t in times.items()}}
                rows.append(row)
                print(f"stage {i} B={batch} ({row['items']} items): "
                      + "; ".join(f"{m} block(s) an SM {row['ms'][str(m)]:.4f} ms (grid "
                                  f"{plans[m]['grid']}, chunk {plans[m]['kc']}, smem "
                                  f"{plans[m]['smem']})" for m in times)
                      + f"; the planner picks {chosen['minb']}")
            x = tail.fused_tail_stage_reference(x, packed)
    for batch in (1, 4, 16):
        picked = sum(r["ms"][str(r["chosen_minb"])] for r in rows if r["batch"] == batch)
        one = sum(r["ms"]["1"] for r in rows if r["batch"] == batch)
        print(f"V1 request at B={batch}: the planner's plans {picked:.4f} ms, one block an SM "
              f"everywhere {one:.4f} ms")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
