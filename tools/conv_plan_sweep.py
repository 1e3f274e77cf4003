#!/usr/bin/env python3
"""Time every valid conv-core plan against the planner's choice, on the card.

    python3 tools/conv_plan_sweep.py [out.json]

For every layer of the V1 multi-scale discriminator's conv stack (layers
1-6; conv_post takes the SIMT path), at the three scales of a B=16 x 8192
train step, in fp32 (TF32 off) and bf16, and for each pass (forward, dx
over a formed dz, dW with its dz pass and reduction), times with CUDA
events the plan ``ops/conv_stack.py::plan_conv`` picks and every other
valid plan: tiles 128 x {16, 32, 64} and 64 x {32, 64}, the channel chunk
at its default and half, and for dW the channel group at half, default and
twice, and 1-24 splits. Prints one line per (layer, pass) with the
planner's plan and time and the four fastest candidates, and writes all of
it as JSON (default ``build/conv_plan_sweep.json``). The planner's
rules (``plan_conv``, ``dw_kc``, ``DW_WAVES``) were read off this sweep.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24)


def time_ms(fn, reps: int = 8) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def candidates(cs, g, dtype, pass_: str) -> list[dict]:
    """Every valid plan of one pass, as plan_conv would return it."""
    base = cs.plan_conv(g, dtype, pass_)
    out = []
    if pass_ == "dw":
        rows = g.n * g.t_out
        for bn in (16, 32, 64):
            for kc in (cs.dw_kc(g) * 2, cs.dw_kc(g), cs.dw_kc(g) // 2):
                if (bn > 16 and g.co_g <= bn // 2) or not 8 <= kc <= 128:
                    continue
                dp = cs.dw_plan(g, dtype, bn, kc)
                if dp["smem"] > cs.SMEM_LIMIT:
                    continue
                for sp in SPLITS:
                    if sp > 1 and rows // sp < 4 * dp["bkt"]:
                        continue
                    sr = -(-(-(-rows // sp)) // dp["bkt"]) * dp["bkt"]
                    n_sp = -(-rows // sr)
                    out.append(dict(base, bm=128, bn=bn, kc=kc, smem=dp["smem"], splits=n_sp,
                                    split_rows=sr, scratch=dict(
                                        base["scratch"], partial=n_sp * g.k * g.ci_g * g.c_out)))
    else:
        dx = pass_ == "dx"
        cols = g.ci_g if dx else g.co_g
        kc0 = cs.win_plan(g, dx, dtype, 128, 16)["kc"]
        for bm, bn in ((128, 16), (128, 32), (128, 64), (64, 32), (64, 64)):
            for kc in sorted({kc0, cs._round8(kc0 // 2)}):
                if (bn > 16 and cols <= bn // 2) or not cs.kc_ok(g, dx, dtype, kc):
                    continue
                wp = cs.win_plan(g, dx, dtype, bm, bn, kc)
                if wp["smem"] <= cs.SMEM_LIMIT:
                    out.append(dict(base, bm=bm, bn=bn, kc=kc, smem=wp["smem"]))
    return out


def label(plan: dict) -> str:
    return f"{plan['bm']}x{plan['bn']} kc{plan['kc']} sp{plan['splits']} {plan['smem']}B"


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_plan_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hifigan_tpu_torch.ops import conv_stack as cs

    out_path = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build" / "conv_plan_sweep.json"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    L = cs.LayerSpec
    specs = [L(128, 41, 2, 4, 20, 20, 0.1), L(256, 41, 2, 16, 20, 20, 0.1),
             L(512, 41, 4, 16, 20, 20, 0.1), L(1024, 41, 4, 16, 20, 20, 0.1),
             L(1024, 41, 1, 16, 20, 20, 0.1), L(1024, 5, 1, 1, 2, 2, 0.1)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    planner = cs.plan_conv
    rows = []
    for t in (8192, 4097, 2049):  # the three MSD scales' input lengths
        for dtype in (torch.float32, torch.bfloat16):
            h = (torch.randn((16, t, 128), device="cuda", generator=gen) * 0.5).to(dtype)
            c = 128
            for li, sp in enumerate(specs):
                fan = sp.kernel * (c // sp.groups)
                k = (torch.randn((sp.kernel, c // sp.groups, sp.c_out), device="cuda",
                                 generator=gen) * (1.5 / fan ** 0.5)).to(dtype)
                b = torch.randn((sp.c_out,), device="cuda", generator=gen) * 0.1
                t_out = cs.out_len(h.shape[1], sp)
                y = cs._layer_fwd(h, k, b, sp, t_out)
                dy = (torch.randn(y.shape, device="cuda", generator=gen) * 0.01).to(dtype)
                _, _, dz = cs._layer_dw(h, y, dy, None, k, sp)
                g = cs._shape(h, t_out, sp)
                passes = {"fwd": lambda: cs._layer_fwd(h, k, b, sp, t_out),
                          "dx": lambda: cs._layer_dx(h, y, dy, None, k, sp, dz),
                          "dw": lambda: cs._layer_dw(h, y, dy, None, k, sp)}
                for pass_, fn in passes.items():
                    chosen = planner(g, dtype, pass_)
                    timed = []
                    for plan in candidates(cs, g, dtype, pass_):
                        cs.plan_conv = (lambda gg, dt, pp, sm=cs.SM_COUNT, plan=plan, p=pass_:
                                        plan if pp == p else planner(gg, dt, pp, sm))
                        try:
                            timed.append((time_ms(fn), label(plan)))
                        finally:
                            cs.plan_conv = planner
                    timed.sort()
                    row = {"t": t, "dtype": str(dtype)[6:], "layer": li + 1, "pass": pass_,
                           "planner": label(chosen), "planner_ms": time_ms(fn),
                           "best": [{"ms": ms, "plan": p} for ms, p in timed[:4]]}
                    rows.append(row)
                    print(f"T={t} {row['dtype']} layer {li + 1} {pass_}: planner {row['planner']} "
                          f"{row['planner_ms']:.4f} ms | best "
                          + "; ".join(f"{p} {ms:.4f}" for ms, p in timed[:4]), flush=True)
                h, c = y, sp.c_out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
