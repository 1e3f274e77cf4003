"""Praat TextGrid parsing (port of ``hifigan_tpu/data/textgrid.py``: the
long and short TextGrid text formats, parsed natively).

parse_textgrid(dir, pattern) -> {tier_name: {'start', 'end', 'text'}} for
every IntervalTier: a tier is a dict of three column arrays (float64
starts and ends, an object array of texts) where the JAX module gives a
DataFrame of the same columns.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from hifigan_tpu_torch.data.complex_parser import get_path_by_glob


def _parse_long_textgrid(text: str) -> dict[str, list[dict]]:
    tiers: dict[str, list[dict]] = {}
    # split into item [n] blocks
    items = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    for item in items:
        cls = re.search(r'class\s*=\s*"([^"]*)"', item)
        name = re.search(r'name\s*=\s*"([^"]*)"', item)
        if not cls or cls.group(1) != "IntervalTier" or not name:
            continue
        rows = []
        for m in re.finditer(
            r"intervals\s*\[\d+\]\s*:\s*"
            r"xmin\s*=\s*([\d.eE+-]+)\s*"
            r"xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"((?:[^"]|"")*)"',
            item,
        ):
            rows.append(
                {
                    "start": float(m.group(1)),
                    "end": float(m.group(2)),
                    "text": m.group(3).replace('""', '"'),
                }
            )
        tiers[name.group(1)] = rows
    return tiers


def _parse_short_textgrid(text: str) -> dict[str, list[dict]]:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    tiers: dict[str, list[dict]] = {}
    i = 0
    # header: "ooTextFile", "TextGrid", xmin, xmax, <exists>, ntiers
    while i < len(lines) and lines[i] != "<exists>":
        i += 1
    if i >= len(lines):
        return tiers
    i += 2  # skip <exists>, ntiers
    while i < len(lines):
        if lines[i] != '"IntervalTier"':
            # skip a TextTier: name, xmin, xmax, n, then 3n lines
            if lines[i] == '"TextTier"':
                n = int(lines[i + 4])
                i += 5 + 3 * n
                continue
            i += 1
            continue
        name = lines[i + 1].strip('"')
        n = int(lines[i + 4])
        rows = []
        j = i + 5
        for _ in range(n):
            rows.append(
                {
                    "start": float(lines[j]),
                    "end": float(lines[j + 1]),
                    "text": lines[j + 2].strip('"'),
                }
            )
            j += 3
        tiers[name] = rows
        i = j
    return tiers


def tier_columns(rows: list[dict]) -> dict[str, np.ndarray]:
    """Interval rows -> the tier's columns."""
    text = np.empty(len(rows), dtype=object)
    text[:] = [r["text"] for r in rows]
    return {"start": np.array([r["start"] for r in rows], dtype=np.float64),
            "end": np.array([r["end"] for r in rows], dtype=np.float64),
            "text": text}


def parse_textgrid_file(path: str | Path) -> dict[str, dict[str, np.ndarray]]:
    text = Path(path).read_text(encoding="utf-8", errors="replace")
    if re.search(r"item\s*\[\d*\]?\s*:?", text):
        tiers = _parse_long_textgrid(text)
    else:
        tiers = _parse_short_textgrid(text)
    return {name: tier_columns(rows) for name, rows in tiers.items()}


def parse_textgrid(subdir, textgrid_pattern: str) -> dict[str, dict[str, np.ndarray]]:
    """Glob-resolve then parse (reference textgrid_parsing.py:9-15)."""
    return parse_textgrid_file(get_path_by_glob(subdir, textgrid_pattern))
