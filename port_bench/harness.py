"""The general runner: one cell, one seed, one window, one result line.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic mix (``traffic/<traffic>.json``, which names its driver,
``traffic/<driver>.py``); the end-to-end and per-layer metrics it reports
are the entries of ``BENCHMARK.json`` that list it (or list no cells); each
per-layer metric is read by ``metrics/<base>.py``, ``<base>`` being the
metric's name up to its first dot; the limits of its correctness numbers
are ``limits/<cell>.json``.

A driver (one class ``Driver`` a driver file) sets the program up and warms
the cell's shapes (``__init__``), runs the measured window (``window``),
frees the program's state (``release``) and compares what the window
produced with the reference (``check``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable

import torch

from port_bench import trace as tracing

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Unit:
    """One timed unit: a request, a batch, one lockstep chunk of all streams,
    or a train step. Times are ``time.perf_counter()`` seconds."""

    start: float  # the harness hands over the input
    end: float  # the output is in host memory (a step: the device has finished it)
    audio_s: float = 0.0  # seconds of audio the unit completed
    host_s: float = 0.0  # host time inside the program's call, before any wait
    work: dict = dataclasses.field(default_factory=dict)  # what the cost readers count


@dataclasses.dataclass
class Window:
    units: list
    t0: float
    t1: float
    attempted: int
    failed: int

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Reading:
    """A number the correctness check compares, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What a driver is given: the cell's configuration and mix, the seed,
    the device, whether the window is traced, and which system runs:
    ``'port'`` (the program), or ``'control'`` (the reference, in the
    precision below the configuration's, in the program's place)."""

    cell: str
    h: dict
    mix: dict
    seed: int
    device: torch.device
    trace: bool = False
    program: str = "port"

    spans: tracing.Spans | None = None

    def span(self, name: str):
        """A host span in the trace (a no-op when the run is not traced)."""
        if self.spans is not None:
            return self.spans(name)
        return contextlib.nullcontext()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end entries, per-layer entries) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]
    return e2e, layer


def config(name: str) -> dict:
    """A configuration's file as the program takes it (hyperparameters at the top level)."""
    return load_json(PKG / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(PKG / "traffic" / f"{name}.json")


def driver_class(mix_: dict):
    return load_module(PKG / "traffic" / f"{mix_['driver']}.py",
                       f"port_bench_driver_{mix_['driver']}").Driver


def reader(metric: str) -> Callable:
    base = metric.split(".", 1)[0]
    return load_module(PKG / "metrics" / f"{base}.py", f"port_bench_metric_{base}").read


def limits(cell: str) -> dict:
    """{number: limit} of a cell's correctness check."""
    data = load_json(PKG / "limits" / f"{cell}.json")
    return {k: float(v["limit"]) for k, v in data["numbers"].items()}


def set_precision(h: dict) -> None:
    """The configuration's TF32 switches, for the program and the reference alike."""
    torch.backends.cuda.matmul.allow_tf32 = bool(h.get("allow_tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(h.get("allow_tf32", False))


def end_to_end(name: str, win: Window, setup_s: float) -> float:
    """The end-to-end metrics, over all the work and all the time of the window."""
    if name == "setup_s":
        return setup_s
    if not win.units:
        raise RuntimeError("the window completed no unit")
    if name == "latency_p95_ms":
        lat = sorted(u.end - u.start for u in win.units)
        return percentile(lat, 95.0) * 1e3
    if name == "audio_s_per_s":
        return sum(u.audio_s for u in win.units) / win.seconds
    if name == "train_step_ms":
        return win.seconds / len(win.units) * 1e3
    raise KeyError(f"unknown end-to-end metric {name!r}")


def percentile(sorted_values: list, q: float) -> float:
    """The q-th percentile, linear between closest ranks (numpy's default)."""
    pos = (len(sorted_values) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (pos - lo)


@dataclasses.dataclass
class Context:
    """What a per-layer reader is given."""

    metric: str
    run: Run
    window: Window
    trace: tracing.TraceData


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, resize: dict | None = None) -> dict:
    """Set up, warm up, measure, check: the result line's object. ``resize``
    ({'h': {...}, 'mix': {...}}) overrides configuration and mix keys, for
    the CPU tests' tiny runs only."""
    bench = benchmark()
    entry = cell_entry(bench, cell)
    e2e, per_layer = metrics_of(bench, cell)
    h = {**config(entry["config"]), **(resize or {}).get("h", {})}
    mix_ = {**mix(entry["traffic"]), **(resize or {}).get("mix", {})}
    run = Run(cell, h, mix_, seed, device, trace)
    set_precision(h)
    if trace:
        run.spans = tracing.Spans()
    drv = driver_class(mix_)(run)
    run.sync()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        activity = "CUDA" if device.type == "cuda" else "CPU"
        prof = torch.profiler.profile(activities=[getattr(torch.profiler.ProfilerActivity,
                                                          activity)])
        prof.start()
    with run.span(tracing.WINDOW_SPAN):
        win = drv.window(seconds)
    td = None
    if prof is not None:
        prof.stop()
        td = tracing.collect(prof, run.spans)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    out_metrics = {}
    if trace:
        for m in per_layer:
            value = reader(m["name"])(Context(m["name"], run, win, td))
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            out_metrics[m["name"]] = {"value": end_to_end(m["name"], win, setup_s),
                                      "unit": m["unit"]}

    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.check(limits(cell))
    correct = bool(readings) and all(r.ok for r in readings) and win.failed == 0

    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
              "metrics": out_metrics, "device": device_info(device, memory_peak, entry["chips"])}
    if td is not None:
        result["device"].update(busy_s=td.busy_s, window_s=td.window_s)
        result["breakdown"] = tracing.breakdown(td)
        path = tracing.write_timeline(td, f"{cell}.{seed}")
        print(f"port_bench: timeline {path}", file=sys.stderr)
    result["checks"] = {r.name: {"value": r.value, "limit": r.limit} for r in readings}
    return result


def device_info(device: torch.device, memory_peak: int, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(memory_peak)}
