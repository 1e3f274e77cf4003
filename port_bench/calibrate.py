"""Readings of a cell's correctness numbers on many seeds, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--program port|control|fault:<name>] [--seconds 2]

For each seed: the cell's set-up, a short window at the cell's own load
(long enough to finish the mix's requests that the check samples; none for
training, whose readings come from its set-up steps), then the check. One
JSON line a seed: the numbers, each beside its current limit. ``control``
puts the reference in the precision below the configuration's in the
program's place; ``fault:<name>`` plants one of :mod:`port_bench.faults`.
The limits in ``limits/<cell>.json`` are set from these readings: above the
largest the port gives, below the smallest the control or a fault gives.
The benchmark's own runs never run this. Needs a CUDA card.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", default="port")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()

    import torch

    from port_bench import faults, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = harness.benchmark()
    entry = harness.cell_entry(bench, args.workload)
    h, mix = harness.config(entry["config"]), harness.mix(entry["traffic"])
    limits = harness.limits(args.workload)
    harness.set_precision(h)
    program, fault = args.program, None
    if program.startswith("fault:"):
        program, fault = "port", program.split(":", 1)[1]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        plant = faults.planted(fault) if fault else contextlib.nullcontext()
        with plant:
            run = harness.Run(args.workload, h, mix, seed, dev, False, program)
            drv = harness.driver_class(mix)(run)
            setup_s = time.perf_counter() - t0
            win = drv.window(args.seconds if mix["driver"] != "train_steps" else 0.0)
        drv.release()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        readings = drv.check(limits)
        line = {"workload": args.workload, "program": args.program, "seed": seed,
                "units": len(win.units), "failed": win.failed, "setup_s": setup_s,
                "check_s": time.perf_counter() - t1,
                "numbers": {r.name: r.value for r in readings},
                "limits": {r.name: r.limit for r in readings},
                "worst": getattr(drv, "worst", None)}
        print(json.dumps(line), flush=True)
        del drv, win
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
