"""The traced window: device intervals from ``torch.profiler``, reduced.

A traced run profiles its whole measured window with the profiler's CUDA
activity only (CUPTI on the card): kernels, copies and sets, at little cost
to the host, so that the host-paced cells keep their pace. The host's side
is the harness's own spans (:class:`Spans`: the window, each unit, the call
into the program and the wait for its output), on the wall clock in ns,
the profiler's time base. What the readers get is :class:`TraceData`: the
device intervals clipped to the window, the host spans, the device's busy
time (the union of the device intervals) and the window's length.
:func:`breakdown` gives the costliest device operations and the idle gaps,
each named by the innermost host span at its midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gzip
import json
import os
import re
import tempfile
import time

WINDOW_SPAN = "port_bench.window"
TOP = 10


@dataclasses.dataclass
class TraceData:
    window: tuple[int, int]  # ns, the window span's start and end
    device: list  # (name, start_ns, end_ns), clipped to the window, sorted by start
    host: list  # (name, start_ns, end_ns), sorted by start
    busy_ns: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.device if rx.search(name)) * 1e-9


def _union_ns(intervals: list) -> tuple[int, list]:
    """(covered ns, idle gaps [(start, end)]) of sorted (name, start, end)."""
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for _, s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


class Spans:
    """The harness's host spans of a traced run: (name, start_ns, end_ns)."""

    def __init__(self):
        self.rows: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.rows.append((name, start, time.time_ns()))

    def window(self) -> tuple[int, int]:
        for name, s, e in self.rows:
            if name == WINDOW_SPAN:
                return s, e
        raise RuntimeError(f"no {WINDOW_SPAN!r} span was recorded")


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def collect(prof, spans: Spans) -> TraceData:
    """Reduce a finished ``torch.profiler.profile`` to the window's data."""
    from torch._C._autograd import DeviceType

    w0, w1 = spans.window()
    device = []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        # a host annotation leaves a shadow on the device, under its own name and
        # over the work it enclosed: no work of its own
        if ev.device_type() == DeviceType.CUDA and not _annotation(ev):
            device.append((ev.name(), s, e))
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    if device and not inside:
        raise RuntimeError("no device interval lies in the window: the profiler's clock "
                           f"is not the wall clock (first event {device[0][1]}, window {w0})")
    inside.sort(key=lambda x: x[1])
    host = sorted(spans.rows, key=lambda x: x[1])
    busy, _ = _union_ns(inside)
    return TraceData((w0, w1), inside, host, busy)


def _host_at(host: list, starts: list, t: int) -> str:
    """The innermost host span covering time ``t`` (the latest-starting one)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 5000, -1), -1):
        name, s, e = host[j]
        if e >= t and name != WINDOW_SPAN:
            return name
    return "harness: between units"


def breakdown(td: TraceData) -> dict:
    """The contract's ``breakdown``: the device operations with the most time
    (summed by name) and the idle gaps, summed by what the host was doing."""
    by_op: dict = {}
    for name, s, e in td.device:
        by_op[name] = by_op.get(name, 0) + (e - s)
    _, gaps = _union_ns([("", td.window[0], td.window[0])] + td.device
                        + [("", td.window[1], td.window[1])])
    starts = [s for _, s, _ in td.host]
    by_host: dict = {}
    for s, e in gaps:
        name = _host_at(td.host, starts, (s + e) // 2)
        by_host[name] = by_host.get(name, 0) + (e - s)

    def top(d):
        return [[_short(k), v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."


def write_timeline(td: TraceData, tag: str) -> str:
    """Write the window's device and host intervals, gzipped JSON lines, into
    the run's temporary directory (``TMPDIR``); return the path."""
    path = os.path.join(tempfile.gettempdir(), f"port_bench.{tag}.timeline.jsonl.gz")
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write(json.dumps({"window_ns": td.window, "busy_ns": td.busy_ns}) + "\n")
        for kind, rows in (("device", td.device), ("host", td.host)):
            for name, s, e in rows:
                f.write(json.dumps([kind, name, s, e]) + "\n")
    return path
