"""The JAX package's native checkpoint encoding, without ``msgpack`` or
``flax`` (pure Python with ``struct``).

:func:`msgpack_serialize` writes the bytes ``flax.serialization.
msgpack_serialize`` writes for the same tree, and :func:`msgpack_restore`
reads what it writes:

- maps, arrays, str, bin, int, float (float64; float32 is read), bool, nil;
- ext 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
  ext 3, a numpy scalar (an ndarray of shape ()); ext 2, a complex number,
  the msgpack of ``(real, imag)``;
- arrays over ``MAX_CHUNK_SIZE`` bytes stored as flax's chunked-array dicts
  (``{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
  {'0': flat part, ...}}``), split when written and joined when read;
- ``bfloat16`` by name: read as its uint16 bits into a ``torch.bfloat16``
  tensor (numpy has no such dtype without ``ml_dtypes``), written from one.

As flax does (its tree map rebuilds every dict), maps are written with
their keys sorted. Torch tensors are written as ndarrays; tuples as arrays.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # bytes of an array leaf past which it is chunked
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x80 <= v:
        out += b"\xd0" + struct.pack(">b", v)
    elif -0x8000 <= v:
        out += b"\xd1" + struct.pack(">h", v)
    elif -0x80000000 <= v:
        out += b"\xd2" + struct.pack(">i", v)
    elif -0x8000000000000000 <= v:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A str/bin/array/map header: fix form (when ``fix``), then 8/16/32-bit."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of {n} elements or bytes is too large")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
    out.append(code)
    out += data


def _ndarray_bytes(arr) -> bytes:
    """The msgpack of (shape, dtype name, C-order bytes)."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported for serialization of "
                             "ndarrays.")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack(([int(d) for d in shape], name, bytes(raw)), out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif type(obj) in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif type(obj) is complex:
        body = bytearray()
        _pack((obj.real, obj.imag), body)
        _pack_ext(EXT_COMPLEX, bytes(body), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if torch.is_tensor(a) else a.size * a.dtype.itemsize


def _chunk(arr) -> dict:
    """flax's chunked-array dict of an array over MAX_CHUNK_SIZE bytes."""
    itemsize = arr.element_size() if torch.is_tensor(arr) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if torch.is_tensor(flat) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(obj: Any, top: bool = True) -> Any:
    """Sort every dict's keys (as flax's tree map does) and chunk array
    leaves of dicts (and the top) above MAX_CHUNK_SIZE bytes."""
    is_array = isinstance(obj, np.ndarray) or torch.is_tensor(obj)
    if isinstance(obj, dict):
        try:
            keys = sorted(obj)
        except TypeError:
            keys = list(obj)
        out = {}
        for k in keys:
            v = obj[k]
            if (isinstance(v, np.ndarray) or torch.is_tensor(v)) and _nbytes(v) > MAX_CHUNK_SIZE:
                out[k] = _chunk(v)
            else:
                out[k] = _prepare(v, top=False)
        return out
    if type(obj) in (list, tuple):
        return type(obj)(_prepare(v, top=False) for v in obj)
    if top and is_array and _nbytes(obj) > MAX_CHUNK_SIZE:
        return _chunk(obj)
    return obj


def msgpack_serialize(tree: Any) -> bytes:
    """The msgpack bytes of a tree of dicts, lists, Python scalars, numpy
    arrays and scalars and torch tensors, as flax writes them."""
    out = bytearray()
    _pack(_prepare(tree), out)
    return bytes(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (the ndarray payload's own encoding)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(b)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b <= 0xC6:
                return self.take(n)
            if b >= 0xD9 and b <= 0xDB:
                return self._str(n)
            if b in (0xDC, 0xDD):
                return self._array(n)
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not supported")

    def _str(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        body = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(body)
        if code == EXT_NPSCALAR:
            a = _ndarray_from(body)
            return a.reshape(()) if torch.is_tensor(a) else a[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(body).read()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not supported")


def _ndarray_from(body: bytes):
    shape, name, buf = _Reader(body, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if torch.is_tensor(parts[0]):
                return torch.cat(parts).reshape(shape)
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree of ``data`` (flax's msgpack): dicts, lists, Python scalars,
    read-only numpy arrays and scalars, bfloat16 as torch tensors."""
    r = _Reader(bytes(data))
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack data has {len(r.data) - r.pos} bytes after its object")
    return _unchunk(tree)
