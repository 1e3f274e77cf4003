"""Declarative dataset-manifest engine (port of
``hifigan_tpu/data/complex_parser.py``).

Data configs declare ``sources`` (csv / glob) plus ``enrichments`` (regex /
files / join / select / rename / retype) that build a table of
per-utterance rows (wav path, textgrid path, speaker, sex, mic-brand, ...).
The JAX engine builds a pandas DataFrame; this one builds a :class:`Table`
of plain Python and numpy columns that gives the same rows, column order
and column types:

- a column is an ``int64``, ``float64`` or ``bool`` array when every value
  is of that kind (pandas' ``infer_objects``), else an object array (str,
  paths, NaN for a missing value); a row's value of a numeric column is a
  numpy scalar, as ``DataFrame.iloc[row]`` gives it;
- ``read_csv`` infers int / float / bool / str per column as pandas'
  reader does (its default NA tokens; ``skipinitialspace``; stripped
  headers);
- ``merge`` is pandas' inner join: left rows in order, each with its right
  matches in right order; clashing names get ``_x``/``_y``;
- ``concat_rows`` stacks tables with the union of their columns (order of
  first appearance), NaN where a table lacks one.
"""

from __future__ import annotations

import csv
import random
import re
from pathlib import Path
from typing import Any

import numpy as np

# pandas.read_csv's default NA tokens and boolean words
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}
_INT_TEXT = re.compile(r"^[-+]?[0-9]+$")


def infer_column(values) -> np.ndarray:
    """A column's array from its values, typed as ``infer_objects`` types it."""
    values = list(values)
    if values and all(isinstance(v, (bool, np.bool_)) for v in values):
        return np.array(values, dtype=bool)
    if values and all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
                      for v in values):
        return np.array(values, dtype=np.int64)
    if values and all(isinstance(v, (int, float, np.integer, np.floating))
                      and not isinstance(v, (bool, np.bool_)) for v in values):
        return np.array(values, dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


class Table:
    """An ordered set of equal-length named columns (see the module doc)."""

    def __init__(self, columns: dict | None = None, n_rows: int | None = None):
        self.columns: dict[str, np.ndarray] = {}
        self.n_rows = n_rows
        for name, values in (columns or {}).items():
            self[name] = values

    def __len__(self) -> int:
        return 0 if self.n_rows is None else self.n_rows

    @property
    def names(self) -> list[str]:
        return list(self.columns)

    def __contains__(self, name) -> bool:
        return name in self.columns

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        return Table({name: self.columns[name] for name in key}, len(self))

    def __setitem__(self, name: str, values) -> None:
        if isinstance(values, (str, bytes, int, float, bool, np.generic, Path)) or values is None:
            values = [values] * len(self)
        col = values if isinstance(values, np.ndarray) and values.dtype != object \
            else infer_column(values)
        if self.n_rows is None:
            self.n_rows = len(col)
        elif len(col) != self.n_rows:
            raise ValueError(f"column {name!r} has {len(col)} rows, the table {self.n_rows}")
        self.columns[name] = col

    def row(self, i: int) -> dict:
        """``{column: value}`` of row ``i`` (``DataFrame.iloc[i].to_dict()``)."""
        return {name: col[i] for name, col in self.columns.items()}

    def rows(self):
        return (self.row(i) for i in range(len(self)))

    def take(self, index) -> "Table":
        index = np.asarray(index, dtype=np.int64)
        return Table({name: infer_column(col[index]) if col.dtype == object else col[index]
                      for name, col in self.columns.items()}, len(index))

    def head(self, n: int) -> "Table":
        return self.take(np.arange(min(n, len(self))))

    def drop(self, rows) -> "Table":
        """The table without rows ``rows`` (positions), renumbered."""
        gone = {int(r) for r in rows}
        return self.take([i for i in range(len(self)) if i not in gone])

    def rename(self, mapping: dict) -> "Table":
        return Table({mapping.get(name, name): col for name, col in self.columns.items()},
                     len(self))

    def astype(self, name: str, cast) -> None:
        self[name] = [cast(v) for v in self.columns[name]]

    def value_counts(self, name: str) -> list[tuple[Any, int]]:
        """``Series.value_counts()``: (value, count) by falling count, ties
        in order of first appearance; values as Python scalars."""
        counts: dict = {}
        for v in self.columns[name].tolist():
            counts[v] = counts.get(v, 0) + 1
        return sorted(counts.items(), key=lambda kv: -kv[1])


def concat_rows(tables: list[Table]) -> Table:
    """``pd.concat(tables, axis=0, ignore_index=True)``."""
    names: list[str] = []
    for t in tables:
        names += [n for n in t.names if n not in names]
    cols = {}
    for name in names:
        values: list = []
        for t in tables:
            values += t.columns[name].tolist() if name in t else [float("nan")] * len(t)
        cols[name] = values
    return Table(cols, sum(len(t) for t in tables))


def merge(left: Table, right: Table, left_on: str, right_on: str) -> Table:
    """``pd.merge(left, right, left_on=..., right_on=...)`` (inner join)."""
    matches: dict = {}
    for j, key in enumerate(right.columns[right_on].tolist()):
        matches.setdefault(key, []).append(j)
    li, ri = [], []
    for i, key in enumerate(left.columns[left_on].tolist()):
        for j in matches.get(key, ()):
            li.append(i)
            ri.append(j)
    lt, rt = left.take(li), right.take(ri)
    same_key = left_on == right_on
    r_names = [n for n in right.names if not (same_key and n == right_on)]
    out = Table(n_rows=len(li))
    for name in left.names:
        clash = name in r_names and not (same_key and name == left_on)
        out[f"{name}_x" if clash else name] = lt.columns[name]
    for name in r_names:
        out[f"{name}_y" if name in left.names else name] = rt.columns[name]
    return out


def read_csv(path, delimiter: str, skiprows: int = 0) -> Table:
    """``pd.read_csv(path, delimiter=..., skiprows=..., skipinitialspace=True,
    index_col=False)`` with the header names stripped."""
    with open(path, newline="", encoding="utf-8") as f:
        lines = f.read().splitlines()[skiprows or 0:]
    records = [r for r in csv.reader(lines, delimiter=delimiter, skipinitialspace=True) if r]
    header = [h.strip() for h in records[0]]
    body = records[1:]
    table = Table(n_rows=len(body))
    for c, name in enumerate(header):
        table[name] = _parse_csv_column([r[c] if c < len(r) else "" for r in body])
    return table


def _parse_csv_column(texts: list[str]) -> list:
    na = [t in _NA for t in texts]
    present = [t.strip() for t, missing in zip(texts, na) if not missing]
    if present and all(_INT_TEXT.match(t) for t in present):
        if not any(na):
            return [int(t) for t in texts]
        return [float("nan") if m else float(int(t)) for t, m in zip(texts, na)]
    if present:
        try:
            return [float("nan") if m else float(t) for t, m in zip(texts, na)]
        except ValueError:
            pass
    if present and all(t in _TRUE or t in _FALSE for t in present):
        return [float("nan") if m else t in _TRUE for t, m in zip(texts, na)]
    return [float("nan") if m else t for t, m in zip(texts, na)]


# ---------------------------------------------------------------------------
# the engine (the JAX module's functions)
# ---------------------------------------------------------------------------


def parse_complex_data(subdir, data_dir, data_config, result_group) -> Table:
    all_labels: dict[str, Table] = {}
    for data_group in data_config:
        group_name = data_group["group-name"]
        all_labels[group_name] = parse_group_sources_labels(subdir, data_dir, data_group)
        for enrichment in data_group.get("enrichments", []):
            parse_enrichment_labels(subdir, data_dir, group_name, enrichment, all_labels)
    return all_labels[result_group]


def parse_enrichment_labels(subdir, data_dir, group_name, enrichment, all_labels) -> None:
    etype = enrichment["type"]
    if etype == "regex":
        parse_regex_labels(group_name, enrichment, all_labels)
    elif etype == "files":
        parse_files_labels(subdir, data_dir, group_name, enrichment, all_labels)
    elif etype == "join":
        parse_join_labels(group_name, enrichment, all_labels)
    elif etype == "select":
        all_labels[group_name] = all_labels[group_name][enrichment["labels"]]
    elif etype == "rename":
        all_labels[group_name] = all_labels[group_name].rename(enrichment["mapping"])
    elif etype == "retype":
        parse_retype_labels(group_name, enrichment, all_labels)
    else:
        raise ValueError(f"Unknown enrichment type - {etype}")


def parse_regex_labels(group_name, enrichment, all_labels) -> None:
    group_labels = all_labels[group_name]
    for label, pattern in enrichment["patterns"].items():
        groups = [_regex_of_value(row, label, pattern) for row in group_labels.rows()]
        names: list[str] = []
        for g in groups:
            names += [n for n in g if n not in names]
        for name in names:
            group_labels[name] = [float("nan") if g.get(name) is None else g[name]
                                  for g in groups]
    all_labels[group_name] = group_labels


def _regex_of_value(row: dict, label, pattern) -> dict:
    match = re.search(resolve_label_references(pattern, row), str(row[label]))
    if match is None:
        raise ValueError(f"regex {pattern!r} did not match {row[label]!r}")
    return match.groupdict()


def parse_files_labels(subdir, data_dir, group_name, enrichment, all_labels) -> None:
    group_labels = all_labels[group_name]
    sample_row = group_labels.row(0)
    for label, pattern in enrichment["labels"].items():
        # fail fast if the pattern resolves to nothing for the first row
        get_path_by_glob(data_dir, resolve_label_references(pattern, sample_row))
        group_labels[label] = [resolve_label_references(pattern, row)
                               for row in group_labels.rows()]
    all_labels[group_name] = group_labels


def parse_retype_labels(group_name, enrichment, all_labels) -> None:
    group_labels = all_labels[group_name]
    casts = {"int": int, "str": str, "float": float}
    for label, new_type in enrichment["mapping"].items():
        if new_type in casts:
            group_labels.astype(label, casts[new_type])
    all_labels[group_name] = group_labels


def parse_join_labels(group_name, enrichment, all_labels) -> None:
    all_labels[group_name] = merge(all_labels[group_name],
                                   all_labels[enrichment["other-group-name"]],
                                   left_on=enrichment["base-label"],
                                   right_on=enrichment["other-label"])


def parse_group_sources_labels(subdir, data_dir, data_group) -> Table:
    group_labels = concat_rows([parse_rows_from_source(subdir, data_dir, source)
                                for source in data_group["sources"]])
    for label, value in data_group.get("group-labels", {}).items():
        group_labels[label] = value
    group_labels["subdir"] = str(subdir)
    return group_labels


def parse_rows_from_source(subdir, data_dir, source) -> Table:
    stype = source["type"]
    if stype == "csv":
        results = parse_rows_from_csv(subdir, data_dir, source)
    elif stype == "glob":
        results = parse_rows_from_glob(subdir, data_dir, source)
    else:
        raise ValueError(f"Unknown source type - {stype}")
    if "size" in source:
        results = results.head(source["size"])
    return results


def parse_rows_from_csv(subdir, data_dir, source) -> Table:
    return read_csv(get_path_by_glob(data_dir, source["path"]), source["delimiter"],
                    source["skiprows"])


def parse_rows_from_glob(subdir, data_dir, source) -> Table:
    files = list(Path(data_dir).glob(source["glob"]))
    return Table({source["label"]: files}, len(files))


def get_path_by_glob(subdir, glob_pattern) -> Path:
    files = list(Path(subdir).glob(str(glob_pattern)))
    if not files:
        raise FileNotFoundError(f"Missing file [{glob_pattern}] in [{subdir}]")
    return min(files, key=lambda x: len(str(x)))


def get_rand_by_glob(subdir, glob_pattern, rng: random.Random | None = None) -> Path:
    files = list(Path(subdir).glob(str(glob_pattern)))
    if not files:
        raise FileNotFoundError(f"Missing file [{glob_pattern}] in [{subdir}]")
    return (rng or random).choice(files)


def resolve_label_references(input_to_resolve: str, labels: dict) -> str:
    for label, value in labels.items():
        input_to_resolve = input_to_resolve.replace("{%s}" % label, str(value))
    return input_to_resolve
