"""``host_ms.<entry>``: the host's milliseconds inside the program's call,
from the call to its return, before the harness waits for the device; the
mean over the window's units (requests, or steps of all streams). Source:
the harness's host clock around the call into the serving or streaming
entry point (``make_fast_vocoder``'s function, the streamer's ``step``)."""

from __future__ import annotations


def read(ctx) -> float | None:
    units = ctx.window.units
    if not units:
        return None
    return sum(u.host_s for u in units) / len(units) * 1e3
