"""``idle_share.<kind>``: the share of the traced window, in %, in which no
operation (kernel, copy or set) ran on the device: 1 - the union of the
device intervals over the window's length."""

from __future__ import annotations


def read(ctx) -> float | None:
    td = ctx.trace
    if td.window_s <= 0 or td.busy_s <= 0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
