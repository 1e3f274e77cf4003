"""Config caching (port of ``hifigan_tpu/utils/caching.py``) and the YAML it
reads and writes, without PyYAML.

``do_and_cache`` makes generated configs reproducible across runs: the first
run writes the YAML, later runs load it verbatim (``copy_path`` reads another
experiment's copy). The experiment directory's ``config.yaml`` is written
with ``yaml.dump`` on the JAX side, so :func:`load_yaml` reads the subset of
YAML that ``yaml.dump`` writes of a JSON-like config, with PyYAML's (YAML
1.1) resolution of plain scalars:

- block mappings and block sequences (a sequence under a key at the key's
  indentation, ``- - x`` nesting, a mapping inside a sequence item);
- plain and double-quoted scalars on one line, single-quoted ones over one
  or more lines (``yaml.dump`` folds a long one at a space past column 80);
- int (decimal, ``0x``, ``0o``/``0`` octal, ``0b``), float (``1.0e-05``,
  ``.inf``, ``-.inf``, ``.nan``), bool (``true``/``false``/``yes``/``no``/
  ``on``/``off`` in their three cases), null (``null``, ``~``, empty);
- ``{}`` and ``[]``; whole-line comments and blank lines.

- the ``...`` line that ends a document whose value is a plain scalar.

Anything else (anchors, tags, flow collections with items, block scalars,
multi-line plain or double-quoted scalars, timestamps, other document
markers) raises ``ValueError`` with its line number: it is never guessed.
:func:`dump_yaml` writes what ``yaml.dump`` writes for such a config (keys
sorted, two-space indent, a single-quoted string folded as PyYAML folds it,
``...`` after a plain scalar document), except that a tuple is written as a
list.

The pickle pair caches host-side results (the data engine's tables, label
statistics and per-item labels): :func:`do_with_pickle_cache` loads a
pickle or makes and writes it, :func:`create_pickle_cache` only writes a
missing one.
"""

from __future__ import annotations

import math
import pickle
import re
from pathlib import Path
from typing import Any

# PyYAML's implicit resolvers (resolver.py), without the sexagesimal forms
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _fail(line: int, what: str):
    raise ValueError(f"config YAML line {line}: {what} is outside the YAML subset this "
                     "reader takes")


def _resolve_plain(text: str, line: int) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith(".nan"):
            return math.nan
        return float(t)
    if _SEXAGESIMAL.match(text) or _TIMESTAMP.match(text):
        _fail(line, f"the plain scalar {text!r} (a sexagesimal number or a timestamp)")
    if text in ("<<", "="):
        _fail(line, f"the plain scalar {text!r}")
    if text[0] in "[]{}&*!|>%@`#,?'\"" or (text[0] in "-:" and (len(text) == 1 or text[1] == " ")):
        _fail(line, f"the scalar {text!r}")
    if ": " in text or " #" in text or text.endswith(":"):
        _fail(line, f"the plain scalar {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _scalar(text: str, line: int) -> tuple[Any, str]:
    """(value, rest of the line) of the scalar at the start of ``text``."""
    if text.startswith("'"):
        out, i = [], 1
        while True:
            j = text.find("'", i)
            if j < 0:
                _fail(line, "a single-quoted scalar over several lines")
            out.append(text[i:j])
            if text[j + 1:j + 2] == "'":
                out.append("'")
                i = j + 2
                continue
            return "".join(out), text[j + 1:]
    if text.startswith('"'):
        out, i = [], 1
        while i < len(text):
            ch = text[i]
            if ch == '"':
                return "".join(out), text[i + 1:]
            if ch == "\\":
                e = text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                n = {"x": 2, "u": 4, "U": 8}.get(e)
                if n is None or not re.fullmatch(r"[0-9a-fA-F]+", text[i + 2:i + 2 + n] or "-"):
                    _fail(line, f"the escape \\{e}")
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            out.append(ch)
            i += 1
        _fail(line, "a double-quoted scalar over several lines")
    return None, text


def _value(text: str, line: int) -> Any:
    """A whole value on one line: a quoted or plain scalar, {} or []."""
    text = text.strip()
    if text in ("{}", "[]"):
        return {} if text == "{}" else []
    if text[:1] in ("'", '"'):
        val, rest = _scalar(text, line)
        rest = rest.strip()
        if rest and not rest.startswith("#"):
            _fail(line, f"text after a quoted scalar ({rest!r})")
        return val
    if " #" in text:
        text = text[:text.index(" #")].rstrip()
    return _resolve_plain(text, line)


def _value_text(content: str) -> str:
    """The value part of a line: after any ``- `` item dashes and a
    ``key:``."""
    while content.startswith("- "):
        content = content[2:].lstrip(" ")
    m = re.match(r"^(.*?):(?: (.*))?$", content)
    if m is not None and not content.startswith(("'", '"')):
        content = (m.group(2) or "").strip()
    return content


def _inline_plain(content: str) -> bool:
    """Whether a line ends in a plain scalar that a deeper-indented next
    line continues (a root scalar, ``key: value`` or ``- value``)."""
    value = _value_text(content)
    return (bool(value) and value != "-" and value[0] not in "'\"#{[&*!|>"
            and value not in ("{}", "[]"))


def _continues_plain(line: str) -> bool:
    """Whether a deeper-indented line can be the rest of a plain scalar
    (not an item, a key, a comment or a document marker)."""
    return (bool(line) and line != "..." and not _is_item(line) and not line.startswith("#")
            and ": " not in line and not line.endswith(":"))


def _opens_single_quote(content: str) -> bool:
    """Whether a line leaves a single-quoted value open (an odd count of
    quotes from a value that starts with one)."""
    value = _value_text(content)
    return value.startswith("'") and value.count("'") % 2 == 1


class _Lines:
    def __init__(self, text: str):
        self.items = []  # (line number, indent, content)
        raws = text.splitlines()
        k = 0
        while k < len(raws):
            n, raw = k + 1, raws[k]
            k += 1
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                _fail(n, "a tab in the indentation")
            stripped = raw.strip()
            if not stripped or stripped.startswith("#"):
                continue
            if stripped == "..." and not any(r.strip() for r in raws[k:]):
                break
            if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
                _fail(n, "a document marker or directive")
            content = raw.strip(" ").rstrip()
            ind = len(raw) - len(raw.lstrip(" "))
            while (_inline_plain(content) and k < len(raws)
                   and len(raws[k]) - len(raws[k].lstrip(" ")) > ind
                   and _continues_plain(raws[k].strip(" "))):
                # a folded plain scalar: each line break is one space
                content += " " + raws[k].strip(" ")
                k += 1
            while _opens_single_quote(content):
                # a folded single-quoted scalar: a line break is one space,
                # an empty line a newline
                if k >= len(raws):
                    _fail(n, "an unterminated single-quoted scalar")
                nxt = raws[k].strip(" ")
                k += 1
                content += "\n" if not nxt else (" " if not content.endswith("\n") else "") + nxt
            self.items.append((n, ind, content))


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _split_key(content: str, line: int) -> tuple[Any, str] | None:
    """(key, value text) of a mapping entry line, or None if it is not one."""
    if content[:1] in ("'", '"'):
        key, rest = _scalar(content, line)
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    m = re.match(r"^(.*?):(?: (.*))?$", content)
    if m is None or content.startswith(("- ", "? ")):
        return None
    key_text = m.group(1)
    if ": " in key_text or not key_text:
        _fail(line, f"the mapping key {key_text!r}")
    return _value(key_text, line), (m.group(2) or "").strip()


def _node(ls: _Lines, i: int, indent: int) -> tuple[Any, int]:
    n, ind, content = ls.items[i]
    if ind != indent:
        _fail(n, "an indentation")
    if _is_item(content):
        return _sequence(ls, i, indent)
    if _split_key(content, n) is not None:
        return _mapping(ls, i, indent)
    return _value(content, n), i + 1


def _child(ls: _Lines, i: int, indent: int, n: int, allow_same: bool) -> tuple[Any, int]:
    """The block value under an entry with nothing after its colon or dash."""
    if i < len(ls.items):
        _n, ind, content = ls.items[i]
        if ind > indent or (allow_same and ind == indent and _is_item(content)):
            return _node(ls, i, ind)
    return None, i


def _mapping(ls: _Lines, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(ls.items):
        n, ind, content = ls.items[i]
        if ind < indent:
            break
        if ind > indent or _is_item(content):
            _fail(n, "an indentation")
        kv = _split_key(content, n)
        if kv is None:
            _fail(n, f"the line {content!r} inside a mapping")
        key, rest = kv
        if key in out:
            _fail(n, f"the repeated key {key!r}")
        if rest and not rest.startswith("#"):
            out[key] = _value(rest, n)
            i += 1
        else:
            out[key], i = _child(ls, i + 1, indent, n, allow_same=True)
    return out, i


def _sequence(ls: _Lines, i: int, indent: int) -> tuple[list, int]:
    out: list = []
    while i < len(ls.items):
        n, ind, content = ls.items[i]
        if ind < indent or (ind == indent and not _is_item(content)):
            break
        if ind > indent:
            _fail(n, "an indentation")
        if content == "-":
            val, i = _child(ls, i + 1, indent, n, allow_same=False)
        else:
            # "- x": the item is the rest of the line, indented past the dash
            rest = content[1:]
            at = indent + 1 + len(rest) - len(rest.lstrip(" "))
            ls.items[i] = (n, at, rest.lstrip(" "))
            val, i = _node(ls, i, at)
        out.append(val)
    return out, i


def load_yaml(text: str) -> Any:
    """The value of a YAML document in the subset described above."""
    ls = _Lines(text)
    if not ls.items:
        return None
    val, i = _node(ls, 0, ls.items[0][1])
    if i < len(ls.items):
        _fail(ls.items[i][0], "an indentation")
    return val


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _float_text(v: float) -> str:
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _block_plain_allowed(v: str) -> bool:
    """Whether PyYAML's ``analyze_scalar`` lets a string be a plain scalar
    in block context (printable ASCII, no indicator where it would end a
    plain scalar, no leading or trailing space)."""
    if not v or v.startswith(("---", "...")) or v[0] == " " or v[-1] == " ":
        return False
    if not all(" " <= ch <= "~" for ch in v):
        return False
    if v[0] in "#,[]{}&*!|>'\"%@`" or (v[0] in "?:-" and (len(v) == 1 or v[1] == " ")):
        return False
    return ": " not in v and not v.endswith(":") and " #" not in v


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if v is True or v is False:
        return "true" if v else "false"
    if isinstance(v, int):
        return str(int(v))
    if isinstance(v, float):
        return _float_text(float(v))
    if not isinstance(v, str):
        raise TypeError(f"cannot write {type(v).__name__} as YAML")
    if _block_plain_allowed(v):
        try:
            plain_ok = _resolve_plain(v, 0) == v
        except ValueError:
            plain_ok = False
        if plain_ok:
            return v
    if all(" " <= ch <= "~" for ch in v):
        return "'" + v.replace("'", "''") + "'"
    out = []
    for ch in v:
        if ch in ('"', "\\"):
            out.append("\\" + ch)
        elif " " <= ch <= "~":
            out.append(ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ord(ch) <= 0xFF:
            out.append(f"\\x{ord(ch):02X}")
        elif ord(ch) <= 0xFFFF:
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _fold_single(text: str, column: int, indent: int) -> str:
    """``'text'`` as PyYAML's ``write_single_quoted`` writes it with the
    quote at ``column``: a lone space past column 80 (not the first or last
    character) becomes a line break and ``indent`` spaces."""
    out, col = ["'"], column + 1
    spaces, start, end = False, 0, 0
    while end <= len(text):
        ch = text[end] if end < len(text) else None
        if spaces:
            if ch != " ":
                if start + 1 == end and col > 80 and start != 0 and end != len(text):
                    out.append("\n" + " " * indent)
                    col = indent
                else:
                    out.append(text[start:end])
                    col += end - start
                start = end
        elif ch is None or ch == " " or ch == "'":
            if start < end:
                out.append(text[start:end])
                col += end - start
                start = end
        if ch == "'":
            out.append("''")
            col += 2
            start = end + 1
        if ch is not None:
            spaces = ch == " "
        end += 1
    out.append("'")
    return "".join(out)


def _fold_plain(text: str, column: int, indent: int) -> str:
    """A plain scalar as PyYAML's ``write_plain`` writes it from ``column``:
    a lone space past column 80 becomes a line break and ``indent`` spaces."""
    out, col = [], column
    spaces, start, end = False, 0, 0
    while end <= len(text):
        ch = text[end] if end < len(text) else None
        if spaces:
            if ch != " ":
                if start + 1 == end and col > 80:
                    out.append("\n" + " " * indent)
                    col = indent
                else:
                    out.append(text[start:end])
                    col += end - start
                start = end
        elif ch is None or ch == " ":
            out.append(text[start:end])
            col += end - start
            start = end
        if ch is not None:
            spaces = ch == " "
        end += 1
    return "".join(out)


def _scalar_at(v: Any, column: int, indent: int) -> str:
    """A scalar's text written at ``column``, folded onto lines at
    ``indent`` if it is a long string."""
    text = _flat(v)
    if not isinstance(v, str) or "\n" in v:
        return text
    if text.startswith("'"):
        return _fold_single(v, column, indent)
    return text if text.startswith('"') else _fold_plain(v, column, indent)


def _dump(v: Any, indent: int, out: list, lead: str) -> None:
    """Write ``v``; ``lead`` is the text already on its first line ("key:"
    or "- " prefixes), the block starting at ``indent``."""
    pad = " " * indent
    if isinstance(v, dict) and v:
        first = True
        for k in sorted(v, key=lambda k: (str(type(k)), k)):
            key = _scalar_text(k)
            prefix = lead if first else pad
            first = False
            _entry(v[k], indent, out, f"{prefix}{key}:")
    elif isinstance(v, (list, tuple)) and v:
        first = True
        for item in v:
            prefix = lead if first else pad
            first = False
            if isinstance(item, (dict, list, tuple)) and item:
                _dump(item, indent + 2, out, f"{prefix}- ")
            else:
                out.append(f"{prefix}- {_scalar_at(item, len(prefix) + 2, indent + 2)}")
    else:
        out.append(f"{lead}{_scalar_at(v, len(lead), indent + 2)}")


def _flat(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar_text(v)


def _entry(v: Any, indent: int, out: list, head: str) -> None:
    pad = " " * indent
    if isinstance(v, dict) and v:
        out.append(head)
        _dump(v, indent + 2, out, " " * (indent + 2))
    elif isinstance(v, (list, tuple)) and v:
        out.append(head)
        _dump(v, indent, out, pad)
    else:
        out.append(f"{head} {_scalar_at(v, len(head) + 1, indent + 2)}")


def dump_yaml(value: Any) -> str:
    """YAML text of a JSON-like value, as ``yaml.dump`` writes it."""
    out: list = []
    _dump(value, 0, out, "")
    if not isinstance(value, (dict, list, tuple)) and not out[0].startswith(("'", '"')):
        out.append("...")  # PyYAML ends a plain scalar document explicitly
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# caching
# ---------------------------------------------------------------------------


def do_and_cache(func, cache_path, copy_path=None):
    """``func()``, or the YAML at ``copy_path`` (default ``cache_path``) if
    it exists; the result is written to ``cache_path`` either way."""
    read_path = Path(cache_path if copy_path is None else copy_path)
    write_path = Path(cache_path)
    result = load_yaml(read_path.read_text()) if read_path.exists() else func()
    write_path.parent.mkdir(parents=True, exist_ok=True)
    write_path.write_text(dump_yaml(result))
    return result


def do_and_cache_dict(func, cache_format):
    """Per key of ``func()``'s dict: the YAML at ``cache_format.format(key)``
    if it exists, else the value, written there."""
    output = {}
    for key, value in func().items():
        cache_path = Path(cache_format.format(key))
        if cache_path.exists():
            output[key] = load_yaml(cache_path.read_text())
        else:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            output[key] = value
            cache_path.write_text(dump_yaml(value))
    return output


def do_with_pickle_cache(func, pickle_path):
    """The pickle at ``pickle_path`` if it exists, else ``func()``, written there."""
    pickle_path = Path(pickle_path)
    if pickle_path.exists():
        with open(pickle_path, "rb") as f:
            return pickle.load(f)
    pickle_path.parent.mkdir(parents=True, exist_ok=True)
    result = func()
    with open(pickle_path, "wb") as f:
        pickle.dump(result, f)
    return result


def create_pickle_cache(func, pickle_path):
    """Write ``func()`` to ``pickle_path`` unless the file exists."""
    pickle_path = Path(pickle_path)
    if not pickle_path.exists():
        pickle_path.parent.mkdir(parents=True, exist_ok=True)
        with open(pickle_path, "wb") as f:
            pickle.dump(func(), f)
