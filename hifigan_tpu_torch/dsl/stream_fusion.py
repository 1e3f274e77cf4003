"""Generic stream-fusion pass over DSL configs (PyTorch port of
``hifigan_tpu/dsl/stream_fusion.py``).

The distillation generator's encoder and decoder are chains of narrow
same-width conv blocks (4, 12 and 84 channels over long streams) with
``res`` adds and ``sub_res(pool)`` skips, between ``roll``/``unroll``
reshapes and a wide 1092-channel core. The pass walks a config as a flat
sequence of atoms (nested ``#seq`` nodes flattened, interpreter paths kept)
and, wherever the running value is a (B, T, C) tensor with C <= 384,
greedily takes a maximal *run* of fusable stream ops (conv + lrelu/tanh,
``res`` / ``sub_res``, mean ``pool``, ``repl``, ``avg_ch``, ``sum`` of
branches). A run with two convs or more is lowered to ONE stream-graph
segment (:mod:`hifigan_tpu_torch.ops.stream_graph`: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors), with ``id`` / ``neg`` /
``pool`` / ``repl`` / ``avg`` sources as constant tables. Every other atom
goes through the interpreter (``ConfigurableModule._eval``) at its own path.

The run grammar is the JAX pass's (``_flatten``, ``_RunBuilder.fuse``, the
activation merge with its protected slots, the rollback on a cut). The
JAX pass's lane rule (one shared time fold per run, at most 1024 lanes) is
a TPU layout rule and is not kept: the port's IR is in sample space.
Instead a run is cut where the stream-graph kernels would refuse its
segment (``check_segment``, ``MAX_EDGES``, the backward plan and the three
schedules' caps), decided from the static shapes before anything runs.

Conv sources read ``module.conv_weights(f"{path}_conv", dtype)``: the
parameters the interpreter built, under its names, so enabling the pass
never changes a module's parameters; only the float order differs.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hifigan_tpu_torch.dsl import fused_member
from hifigan_tpu_torch.dsl.normalize import SEQ
from hifigan_tpu_torch.ops import stream_graph as sg

MAX_FUSED_C = 384  # wider levels stay on the interpreter (cuDNN is fine there)
_CACHED = 256  # planned runs a module keeps (by entry shape)


def _dsl_padding(kernel: int, stride: int = 1, dilation: int = 1) -> int:
    return ((kernel - 1) * dilation + 1) // 2


def _conv_out(t: int, k: int, d: int, pad: int) -> int:
    return t + 2 * pad - (k - 1) * d


class _Cut(Exception):
    """Node cannot join a fused run."""


# ---------------------------------------------------------------------------
# run IR (static per entry width)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _RConv:
    chin: int
    chout: int
    k: int
    d: int
    name: str


@dataclasses.dataclass(frozen=True)
class _ROp:
    """One fused op: sum of sources -> optional residual -> activation.

    srcs: tuple of (slot, kind, payload): 'conv' (payload _RConv), 'id' /
    'neg' (+/- identity), 'pool' ((k,): mean pool, stride 1), 'repl' ((n,):
    c -> n*c), 'avg' (c -> 1).
    """

    srcs: tuple
    act: str
    slope: float
    res_from: int | None
    chout: int


@dataclasses.dataclass
class _Run:
    entry_c: int
    ops: list = dataclasses.field(default_factory=list)
    # the finished run's segment by entry length (filled by run_fused)
    segments: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n_convs(self) -> int:
        return sum(1 for op in self.ops for _s, k, _p in op.srcs if k == "conv")


def _flatten(cfg, path: str, out: list) -> None:
    """Nested #seq nodes -> (node_cfg, path) atoms, with the interpreter's paths."""
    if isinstance(cfg, tuple) and cfg and cfg[0] == SEQ:
        for i, sub in enumerate(cfg[1]):
            _flatten(sub, f"{path}_{i}", out)
    else:
        out.append((cfg, path))


class _RunBuilder:
    def __init__(self, entry_c: int):
        self.run = _Run(entry_c=entry_c)
        # slots read besides the linear chain (residual sources, sum-branch
        # entries): an activation must not merge into their producing op
        self._protected: set[int] = set()

    def _emit(self, op: _ROp) -> int:
        self.run.ops.append(op)
        return len(self.run.ops)  # the new slot

    # `c` = current width, `slot` = current SSA slot (0 = run input)
    def fuse(self, cfg, path: str, c: int, slot: int) -> tuple[int, int]:
        if isinstance(cfg, tuple) and cfg and cfg[0] == SEQ:
            for i, sub in enumerate(cfg[1]):
                c, slot = self.fuse(sub, f"{path}_{i}", c, slot)
            return c, slot
        _, name, p, tags = cfg
        if tags:
            raise _Cut("tagged")
        if name == "conv":
            p = list(p)
            chin, chout, k = int(p[0]), int(p[1]), int(p[2])
            s = int(p[3]) if len(p) > 3 else 1
            d = int(p[4]) if len(p) > 4 else 1
            g = int(p[5]) if len(p) > 5 else 1
            if s != 1 or g != 1 or chin != c:
                raise _Cut("conv geometry")
            rc = _RConv(chin, chout, k, d, f"{path}_conv")
            return chout, self._emit(_ROp(((slot, "conv", rc),), "none", 1.0, None, chout))
        if name == "lrelu":
            return self._act(c, slot, "lrelu", float(p))
        if name == "tanh":
            return self._act(c, slot, "tanh", 1.0)
        if name == "pool":
            k, s = (int(v) for v in p)
            if s != 1:
                raise _Cut("strided pool")
            return c, self._emit(_ROp(((slot, "pool", (k,)),), "none", 1.0, None, c))
        if name == "repl":
            n = int(p)
            return n * c, self._emit(_ROp(((slot, "repl", (n,)),), "none", 1.0, None, n * c))
        if name == "avg_ch":
            return 1, self._emit(_ROp(((slot, "avg", ()),), "none", 1.0, None, 1))
        if name in ("res", "sub_res"):
            sub_path = f"{path}_{'res' if name == 'res' else 'sres'}"
            self._protected.add(slot)
            c2, s2 = self.fuse(p, sub_path, c, slot)
            if c2 != c:
                raise _Cut("res width change")
            sgn = "id" if name == "res" else "neg"
            return c, self._emit(_ROp(((s2, sgn, ()),), "none", 1.0, slot, c))
        if name == "sum":
            outs = []
            c_out = None
            self._protected.add(slot)
            for i, sub in enumerate(p):
                ci, si = self.fuse(sub, f"{path}_sum{i}", c, slot)
                if c_out is None:
                    c_out = ci
                elif ci != c_out:
                    raise _Cut("sum width mismatch")
                outs.append(si)
            return c_out, self._emit(_ROp(tuple((si, "id", ()) for si in outs), "none", 1.0,
                                          None, c_out))
        raise _Cut(name)

    def _act(self, c: int, slot: int, act: str, slope: float) -> tuple[int, int]:
        ops = self.run.ops
        if slot == len(ops) and slot > 0 and ops[-1].act == "none" and slot not in self._protected:
            # rebind (never mutate): the rollback's shallow copy keeps the old op
            ops[-1] = dataclasses.replace(ops[-1], act=act, slope=slope)
            return c, slot
        return c, self._emit(_ROp((), act, slope, slot, c))


# ---------------------------------------------------------------------------
# lowering: static segment of a run, and the kernels' admission of it
# ---------------------------------------------------------------------------


def _edge_geometry(kind: str, payload) -> tuple[int, int, int]:
    """(taps, dilation, left padding) of a run source."""
    if kind == "conv":
        return payload.k, payload.d, _dsl_padding(payload.k, 1, payload.d)
    k = payload[0] if kind == "pool" else 1
    return k, 1, _dsl_padding(k, 1, 1)


def lower_run(run: _Run, t0: int) -> list[tuple]:
    """Per op of ``run`` entered at (t0, entry_c): (edges, act, slope,
    residual level, t_out, c_out), each edge (source level, c_in, K,
    dilation, pad, kind, payload); level i is SSA slot i. An op's t_out is
    the least of its edges' conv lengths, an op without edges takes its
    residual's."""
    ts, cs = [t0], [run.entry_c]
    out = []
    for op in run.ops:
        edges, t_out = [], None
        for slot, kind, payload in op.srcs:
            k, d, pad = _edge_geometry(kind, payload)
            edges.append((slot, cs[slot], k, d, pad, kind, payload))
            te = _conv_out(ts[slot], k, d, pad)
            t_out = te if t_out is None else min(t_out, te)
        if not edges:
            t_out = ts[op.res_from]
        out.append((tuple(edges), op.act, op.slope, op.res_from, t_out, op.chout))
        ts.append(t_out)
        cs.append(op.chout)
    return out


def run_segment(run: _Run, t0: int) -> sg.Segment:
    """The stream-graph segment a run lowers to at entry length ``t0``."""
    levels = [sg.Level(t0, run.entry_c, is_input=True)]
    ops = []
    for edges, act, slope, res, t_out, c_out in lower_run(run, t0):
        levels.append(sg.Level(t_out, c_out))
        ops.append(sg.Op(len(levels) - 1, tuple(sg.Edge(src, c_in, k, 1, d, pad)
                                                for src, c_in, k, d, pad, _k, _p in edges),
                         act, float(slope), res))
    return sg.Segment(tuple(levels), tuple(ops))


def _admit(run: _Run, batch: int, t0: int) -> None:
    """Raise _Cut unless the kernels take the run's segment, forward and
    backward (every conv table and bias trained, the input differentiated,
    the last level's cotangent given)."""
    seg = run_segment(run, t0)
    try:
        sg.check_segment(seg)
        sg.forward_schedule(seg, batch)
        convs = [kind == "conv" for op in run.ops for _s, kind, _p in op.srcs]
        has_bias = [any(kind == "conv" for _s, kind, _p in op.srcs) for op in run.ops]
        dy = [False] * (len(seg.ops) - 1) + [True]
        plan = tuple(sg.backward_plan(seg, [True], convs, has_bias, dy))
        sg.dx_schedule(seg, plan, batch)
        sg.dw_schedule(seg, plan, batch, 1)
    except (ValueError, NotImplementedError) as e:
        raise _Cut(f"stream-graph kernels: {e}") from e


def _linearize_run(atoms, c0: int, batch: int, t0: int) -> tuple[_Run, int]:
    """Greedily fuse a maximal run from atoms[0:] that the kernels take;
    returns (run, atoms consumed)."""
    rb = _RunBuilder(c0)
    c, slot = c0, 0
    consumed = 0
    for cfg, path in atoms:
        backup = (list(rb.run.ops), set(rb._protected), c, slot)
        try:
            c, slot = rb.fuse(cfg, path, c, slot)
            if rb.run.ops:
                _admit(rb.run, batch, t0)
        except _Cut:
            rb.run.ops, rb._protected, c, slot = backup
            break
        consumed += 1
    return rb.run, consumed


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _const_table(kind: str, payload: tuple, c: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """(1, K, c, c_out) constant table of an id/neg/pool/repl/avg source,
    rounded to the working dtype (1/k rounded once, as the JAX pass's
    ``_const_kernel`` gives it in that dtype)."""
    eye = torch.eye(c, dtype=torch.float64)
    if kind == "id":
        w = eye[None]
    elif kind == "neg":
        w = -eye[None]
    elif kind == "pool":
        (k,) = payload
        w = (eye / k)[None].expand(k, c, c)
    elif kind == "repl":
        (n,) = payload
        w = eye.repeat(1, n)[None]
    elif kind == "avg":
        w = torch.full((1, c, 1), 1.0 / c, dtype=torch.float64)
    else:
        raise AssertionError(kind)
    return w.to(dtype)[None].contiguous().to(device)


def run_fused(module, run: _Run, x: torch.Tensor) -> torch.Tensor:
    """One fused run on a (B, t, c) tensor: one stream-graph segment, lowered
    once per entry length; its tables and biases are gathered each call."""
    b, t0, c0 = x.shape
    assert c0 == run.entry_c, (c0, run.entry_c)
    seg = run.segments.get(t0)
    if seg is None:
        seg = run.segments[t0] = run_segment(run, t0)
    dt = x.dtype
    tables, biases = [], []
    for op, seg_op in zip(run.ops, seg.ops):
        bias = None
        for (_slot, kind, payload), edge in zip(op.srcs, seg_op.edges):
            if kind == "conv":
                kern, bb = module.conv_weights(payload.name, dt)
                tables.append(kern[None])
                bias = bb[None].float() if bias is None else bias + bb[None].float()
            else:
                tables.append(_const_table(kind, payload, edge.c_in, dt, x.device))
        biases.append(bias)
    return fused_member.fused_stream_graph(seg, [x], tables, biases,
                                           weight_grads=module.weight_grads)[-1]


def _atoms(module, cfg, path: str) -> list:
    key = (id(cfg), path)
    cache = module.__dict__.setdefault("_stream_atoms", {})
    if key not in cache:
        atoms: list = []
        _flatten(cfg, path, atoms)
        cache[key] = atoms
    return cache[key]


def _planned(module, atoms: list, i: int, batch: int, t0: int, c0: int) -> tuple[_Run, int]:
    """The run starting at atom i for an entry (batch, t0, c0), cached on the module."""
    key = (id(atoms), i, batch, t0, c0)
    cache = module.__dict__.setdefault("_stream_runs", {})
    if key not in cache:
        if len(cache) >= _CACHED:
            cache.clear()
        cache[key] = _linearize_run(atoms[i:], c0, batch, t0)
    return cache[key]


def eval_stream_fused(module, cfg, x: torch.Tensor, path: str, record: list | None = None):
    """Evaluate a config with the stream-fusion pass: (value, feats) with
    the interpreter's parameters and semantics; fused runs are reassociated
    only. ``record``, when given, receives (entry value, run, its atoms) per
    fused run."""
    atoms = _atoms(module, cfg, path)
    feats: list = []
    val = x
    i = 0
    while i < len(atoms):
        if torch.is_tensor(val) and val.dim() == 3 and val.shape[-1] <= MAX_FUSED_C:
            b, t, c = val.shape
            run, consumed = _planned(module, atoms, i, b, t, c)
            if run.n_convs >= 2:
                if record is not None:
                    record.append((val, run, atoms[i:i + consumed]))
                val = run_fused(module, run, val)
                i += consumed
                continue
        out, f = module._eval(atoms[i][0], (val,), atoms[i][1])
        feats.extend(f)
        val = out
        i += 1
    return val, feats
