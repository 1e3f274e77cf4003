"""Per-layer readers, one file per metric base name (the name up to its
first dot): ``read(ctx) -> float | None``. A reader takes what it needs from
the traced window (``ctx.trace``), the window's units (``ctx.window``) and
the cell (``ctx.run``), and returns None where it finds nothing to read; it
never returns 0 for a share of a roofline or of a peak."""
