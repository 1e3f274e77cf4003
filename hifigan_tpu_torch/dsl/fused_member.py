"""Fused evaluation of all-in-one discriminator members (PyTorch port of
``hifigan_tpu/dsl/fused_member.py``).

The distillation discriminator (static_configs.get_discriminator_config) is a
homogeneous ensemble of ``pfmap(all_in_one_discriminator)`` members, each
~59 narrow convs (channels 1..720 over ~43,680-sample streams). This module
pattern-matches a member's config subtree (:func:`parse_member`, a copy of
the JAX one) and lowers it onto :mod:`hifigan_tpu_torch.ops.stream_graph`:
one segment per all-in-one block (conv_rech, raw-branch taps, mid conv,
residual conv, the block's pfmap head; segment 0 also the ``before`` conv
and head 0, the last the ``after`` conv), with every member of the ensemble
in the same call over stacked weights.

Mappings, in the stream graph's sample-space IR:

- ``conv_rech``'s conv-then-rechannel is a strided edge whose output level
  the next op reads with ``c_out`` channels: a view, no data movement;
- ``roll`` raw branches are reshapes of the raw waveform fed as input
  levels; the block's concat-then-conv is a sum of per-branch edges;
- ``mel`` raw branches run in the graph when n_fft == hop (the shipped
  geometry): a stride-hop edge with the windowed real-DFT basis as its
  (n_fft, 1, 2*n_bins) table, a ``square`` op, and a 1x1 ``[fb; fb]`` edge
  with ``log1e5``; other geometries feed the interpreter's mel as an input.

Weights are read through the members' own convs (``conv_weights``), under
the interpreter's names, so the parameters are the interpreter's.
:class:`StreamUnsupported` (raised before anything is evaluated) sends a
subtree back to the interpreter.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from hifigan_tpu_torch.audio.mel import mel_filterbank
from hifigan_tpu_torch.audio.stft import _rdft_basis, hann_window
from hifigan_tpu_torch.ops.stream_graph import Edge, Level, Op, Segment, fused_stream_graph

class StreamUnsupported(Exception):
    """Config subtree is not a recognised all-in-one member."""


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# static parse (no parameters created — safe to fall back after)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Conv:
    chin: int
    chout: int
    k: int
    s: int
    d: int
    init: float
    norm: str
    name: str  # flax submodule name suffix-path (interpreter-identical)


@dataclasses.dataclass(frozen=True)
class _Block:
    rech: _Conv  # the conv of conv_rech (chout = s * chin), rechannels to c_out
    c_out: int  # rechannel target channels
    roll_cfg: tuple  # normalized roll node
    mel_cfg: tuple | None  # normalized mel node (or None)
    mid: _Conv
    res: _Conv
    lrelu: float
    res_tags: tuple = ("all_in_one",)


@dataclasses.dataclass(frozen=True)
class _MemberPlan:
    before: _Conv
    before_slope: float
    blocks: tuple
    after: _Conv
    heads: tuple  # one _Conv per captured feature (cycled process layers)
    before_tags: tuple = ("all_in_one",)


def _expect(cond, what):
    if not cond:
        raise StreamUnsupported(what)


def _expect_node(cfg, name):
    _expect(
        isinstance(cfg, tuple) and len(cfg) == 4 and cfg[0] == "#node"
        and cfg[1] == name,
        f"expected node {name}, got {cfg[:2] if isinstance(cfg, tuple) else cfg}",
    )
    return cfg[2], cfg[3]


def _expect_seq(cfg, n):
    _expect(
        isinstance(cfg, tuple) and len(cfg) == 2 and cfg[0] == "#seq"
        and len(cfg[1]) == n,
        f"expected #seq of {n}",
    )
    return cfg[1]


def _norm_name(norm_type) -> str:
    if norm_type == "spectral":
        return "spectral"
    if norm_type == "none":
        return "none"
    return "weight"


def _parse_conv(cfg, path, *, rech=False) -> _Conv:
    """conv / conv_rech / conv_shuffle(g=1) node -> _Conv + interpreter name."""
    kind = cfg[1] if isinstance(cfg, tuple) and len(cfg) == 4 else None
    if kind == "conv_shuffle":
        p, tags = _expect_node(cfg, "conv_shuffle")
        _expect(not tags, "tagged conv_shuffle")
        p = list(p)
        chin, chout, k = int(p[0]), int(p[1]), int(p[2])
        s = int(p[3]) if len(p) > 3 else 1
        d = int(p[4]) if len(p) > 4 else 1
        g = int(p[5]) if len(p) > 5 else 1
        _expect(g == 1, "grouped conv_shuffle")
        init = float(p[6]) if len(p) > 6 else 0.01
        # g==1 conv_shuffle lowers to a conv at path f"{path}_cs"
        # (module._node) -> NormConv1d name f"{path}_cs_conv"
        return _Conv(chin, chout, k, s, d, init, "weight", f"{path}_cs_conv")
    if rech:
        p, tags = _expect_node(cfg, "conv_rech")
        _expect(not tags, "tagged conv_rech")
        p = list(p)
        chin, chout, k = int(p[0]), int(p[1]), int(p[2])
        s = p[3] if len(p) > 3 else None
        if s is None:
            s = chout // math.gcd(chin, chout)
        s = int(s)
        d = int(p[4]) if len(p) > 4 else 1
        g = int(p[5]) if len(p) > 5 else 1
        _expect(g == 1, "grouped conv_rech")
        init = float(p[6]) if len(p) > 6 else 0.01
        # conv_rech's conv has features = s*chin then rechannels to chout
        return _Conv(chin, s * chin, k, s, d, init, "weight",
                     f"{path}_convrech")
    p, tags = _expect_node(cfg, "conv")
    _expect(not tags, "tagged conv")
    p = list(p)
    chin, chout, k = int(p[0]), int(p[1]), int(p[2])
    s = int(p[3]) if len(p) > 3 else 1
    d = int(p[4]) if len(p) > 4 else 1
    g = int(p[5]) if len(p) > 5 else 1
    _expect(g == 1, "grouped conv")
    init = float(p[6]) if len(p) > 6 else 0.01
    norm = _norm_name(p[7]) if len(p) > 7 else "weight"
    return _Conv(chin, chout, k, s, d, init, norm, f"{path}_conv")


def _parse_lrelu(cfg, *, want_tag):
    p, tags = _expect_node(cfg, "lrelu")
    _expect(bool(tags) == want_tag, "unexpected lrelu tagging")
    return float(p), tags


def parse_member(p, path: str) -> _MemberPlan:
    """Parse a normalized pfmap(all_in_one_discriminator) params tuple."""
    sub_cfg, capture_tags, feature_models = p
    aiod_p, aiod_tags = _expect_node(sub_cfg, "all_in_one_discriminator")
    _expect(not aiod_tags, "tagged all_in_one_discriminator")
    before_cfg, blocks_cfgs, after_cfg = aiod_p

    bpath = f"{path}_pfm_aiod_b"
    bconv_cfg, blrelu_cfg = _expect_seq(before_cfg, 2)
    before = _parse_conv(bconv_cfg, f"{bpath}_0")
    before_slope, btags = _parse_lrelu(blrelu_cfg, want_tag=True)
    _expect(any(t in capture_tags for t in btags), "before lrelu not captured")
    _expect(before.s == 1, "strided before conv")

    blocks = []
    for j, bc in enumerate(blocks_cfgs):
        aib_p, aib_tags = _expect_node(bc, "all_in_one_block")
        _expect(not aib_tags, "tagged all_in_one_block")
        bseq, raws, aseq = aib_p
        jpath = f"{path}_pfm_aiod_{j}"
        rech_cfg, rlrelu = _expect_seq(bseq, 2)
        rech = _parse_conv(rech_cfg, f"{jpath}_aib_b_0", rech=True)
        slope, _ = _parse_lrelu(rlrelu, want_tag=False)
        _expect(len(raws) in (1, 2), "raw branch count")
        roll_p, roll_tags = _expect_node(raws[0], "roll")
        _expect(not roll_tags, "tagged roll")
        mel_cfg = None
        if len(raws) == 2:
            _expect_node(raws[1], "mel")
            _expect(not raws[1][3], "tagged mel")
            mel_cfg = raws[1]
        mid_cfg, mlrelu, res_cfg, plrelu = _expect_seq(aseq, 4)
        apath = f"{jpath}_aib_a"
        mid = _parse_conv(mid_cfg, f"{apath}_0")
        _parse_lrelu(mlrelu, want_tag=False)
        res_p, res_tags = _expect_node(res_cfg, "res")
        _expect(any(t in capture_tags for t in res_tags), "res not captured")
        res = _parse_conv(res_p, f"{apath}_2_res")
        _parse_lrelu(plrelu, want_tag=False)
        res_tags = tuple(res_tags)

        period = roll_p[0] if isinstance(roll_p, (tuple, list)) else roll_p
        c_out = int(period)
        pad_mode = (
            roll_p[1]
            if isinstance(roll_p, (tuple, list)) and len(roll_p) > 1
            else "constant"
        )
        _expect(pad_mode == "constant", "reflect roll padding")
        _expect(rech.chout % c_out == 0, "rechannel divisibility")
        n_br = 2 + (mel_cfg is not None)
        _expect(mid.chin == n_br * c_out and mid.chout == c_out, "mid shape")
        _expect(mid.s == 1 and mid.d == 1, "mid conv stride/dilation")
        _expect(res.chin == c_out and res.chout == c_out and res.s == 1,
                "res shape")
        blocks.append(
            _Block(rech, c_out, raws[0], mel_cfg, mid, res, slope, res_tags)
        )

    aconv_cfg, atanh = _expect_seq(after_cfg, 2)
    _expect_node(atanh, "tanh")
    after = _parse_conv(aconv_cfg, f"{path}_pfm_aiod_a_0")
    _expect(after.s == 1, "strided after conv")

    n_feat = 1 + len(blocks)
    heads = []
    for i in range(n_feat):
        fm = feature_models[i % len(feature_models)]
        hconv_cfg, htanh = _expect_seq(fm, 2)
        _expect_node(htanh, "tanh")
        head = _parse_conv(hconv_cfg, f"{path}_pfmm{i}_0")
        _expect(head.chout == 1 and head.s == 1, "head shape")
        heads.append(head)
    _expect(heads[0].chin == before.chout, "head0 channels")
    for i, blk in enumerate(blocks):
        _expect(heads[i + 1].chin == blk.c_out, f"head{i + 1} channels")
    return _MemberPlan(before, before_slope, tuple(blocks), after,
                       tuple(heads), tuple(btags))



# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _dsl_padding(kernel: int, stride: int = 1, dilation: int = 1) -> int:
    return ((kernel - 1) * dilation + 1) // 2


def _conv_out(t: int, k: int, s: int, d: int, pad: int) -> int:
    return (t + 2 * pad - (k - 1) * d - 1) // s + 1


class _SegBuilder:
    """Levels, ops, tables and biases of one segment; batch = members x N."""

    def __init__(self, members: int):
        self.members = members
        self.levels: list[Level] = []
        self.inputs: list[torch.Tensor] = []
        self.ops: list[Op] = []
        self.tables: list[torch.Tensor] = []
        self.biases: list = []

    def add_input(self, x: torch.Tensor) -> int:
        self.levels.append(Level(x.shape[1], x.shape[2], is_input=True))
        self.inputs.append(x.contiguous())
        return len(self.levels) - 1

    def c_of(self, li: int) -> int:
        return self.levels[li].c

    def add_op(self, edges, act: str, slope: float, res_from: int | None, *, t_out: int,
               c_out: int, bias: torch.Tensor | None = None) -> int:
        """edges: [(src level, c_in view, table (members, K, c_in, c_out), K, s, d, pad)]."""
        es = []
        for src, c_in, table, k, s, d, pad in edges:
            es.append(Edge(src, c_in, k, s, d, pad))
            self.tables.append(table)
        self.levels.append(Level(t_out, c_out))
        out = len(self.levels) - 1
        self.ops.append(Op(out, tuple(es), act, float(slope), res_from))
        self.biases.append(bias)
        return out

    def run(self, weight_grads: bool) -> dict[int, torch.Tensor]:
        seg = Segment(tuple(self.levels), tuple(self.ops))
        outs = fused_stream_graph(seg, self.inputs, self.tables, self.biases,
                                  members=self.members, weight_grads=weight_grads)
        produced = [i for i, lvl in enumerate(self.levels) if not lvl.is_input]
        return dict(zip(produced, outs))


def _mel_tables(sr: int, k: int, out_ch: int, members: int, dtype, device):
    """The windowed real-DFT table (members, k, 1, 2*n_bins) and the stacked
    filterbank table (members, 1, 2*n_bins, out_ch), constants."""
    basis = _rdft_basis(k, k) * hann_window(k)[:, None]
    fb = mel_filterbank(sr, k, out_ch, 0.0, None, "htk", None)
    w1 = torch.from_numpy(np.ascontiguousarray(basis))[None, :, None, :]
    w2 = torch.from_numpy(np.concatenate([fb, fb], axis=0))[None, None]
    return (w1.expand(members, -1, -1, -1).to(device, dtype),
            w2.expand(members, -1, -1, -1).to(device, dtype))


def _lower_mel_branch(module, sb: _SegBuilder, mel_cfg, raw: torch.Tensor, t0: int):
    """A 'mel' raw branch as three graph ops (DFT edge, square, log-mel
    edge), or None when n_fft != hop (overlapping frames need reflect
    padding: the interpreter's mel is fed instead)."""
    from hifigan_tpu_torch.dsl.module import padding_period

    sr, out_ch, k, s = (int(v) for v in mel_cfg[2][:4])
    if module.mel_sampling_rate_override:
        sr = module.mel_sampling_rate_override
    if k != s:
        return None
    lo, hi = padding_period(t0, s)
    raw_p = F.pad(raw, (0, 0, lo, hi))
    n_bins = k // 2 + 1
    w1, w2 = _mel_tables(sr, k, out_ch, sb.members, raw.dtype, raw.device)
    pin = sb.add_input(raw_p)
    t1 = _conv_out(raw_p.shape[1], k, s, 1, 0)
    z = sb.add_op([(pin, 1, w1, k, s, 1, 0)], "none", 1.0, None, t_out=t1, c_out=2 * n_bins)
    sq = sb.add_op([], "square", 1.0, z, t_out=t1, c_out=2 * n_bins)
    mel = sb.add_op([(sq, 2 * n_bins, w2, 1, 1, 1, 0)], "log1e5", 1.0, None, t_out=t1,
                    c_out=out_ch)
    return mel, t1, out_ch


def eval_members_pfmap(members, path: str, args, plan: _MemberPlan | None = None,
                       p=None):
    """Fused evaluation of the same pfmap(all_in_one_discriminator) node of
    every module in ``members`` (one ensemble's members, or one module).

    Returns ``(outs, feats)``: ``outs = {'output': (M, N, t, 1), 'features':
    [(M, N, t, 1), ...]}`` stacked over members, and per member its
    interpreter-order captures ``[(tags, (N, t, c)), ...]``.
    """
    if plan is None:
        plan = parse_member(p, path)
    lead = members[0]
    m = len(members)
    raw = args[0]
    _expect(raw.dim() == 3 and raw.shape[-1] == 1, "raw input shape")
    n, t0, _ = raw.shape
    dt = raw.dtype
    weight_grads = lead.weight_grads
    raw_m = raw.repeat(m, 1, 1)  # (M*N, t0, 1): every member reads the same waveform

    def weights(cs: _Conv):
        pairs = [mod.conv_weights(cs.name, dt) for mod in members]
        return torch.stack([k for k, _ in pairs]), torch.stack([b for _, b in pairs]).float()

    per_member_feats: list[list] = [[] for _ in range(m)]
    heads_out: list[torch.Tensor] = []
    feats_out: list[tuple] = []
    x_prev = None
    out_final = None
    for j, blk in enumerate(plan.blocks):
        sb = _SegBuilder(m)
        if j == 0:
            _expect(plan.before.chin == 1, "before channels")
            _expect(blk.rech.chin == plan.before.chout, "before/rech channels")
            src = sb.add_input(raw_m)
            bf = plan.before
            kb, bb = weights(bf)
            pad = _dsl_padding(bf.k, 1, bf.d)
            bef = sb.add_op([(src, 1, kb, bf.k, 1, bf.d, pad)], "lrelu", plan.before_slope, None,
                            t_out=_conv_out(t0, bf.k, 1, bf.d, pad), c_out=bf.chout, bias=bb)
            h = plan.heads[0]
            kh, bh = weights(h)
            pad = _dsl_padding(h.k, 1, h.d)
            t_bef = sb.levels[bef].t
            h0 = sb.add_op([(bef, bf.chout, kh, h.k, 1, h.d, pad)], "tanh", 1.0, None,
                           t_out=_conv_out(t_bef, h.k, 1, h.d, pad), c_out=1, bias=bh)
            chain, t_chain = bef, t_bef
        else:
            chain = sb.add_input(x_prev)
            t_chain = x_prev.shape[1]

        r = blk.rech
        kr, br = weights(r)
        pad = _dsl_padding(r.k, r.s, r.d)
        t_rech = _conv_out(t_chain, r.k, r.s, r.d, pad)
        rech = sb.add_op([(chain, r.chin, kr, r.k, r.s, r.d, pad)], "lrelu", blk.lrelu, None,
                         t_out=t_rech, c_out=r.chout, bias=br)
        stream_len = t_rech * r.chout
        _expect(stream_len % blk.c_out == 0, "rechannel stream divisibility")
        c = blk.c_out
        branches = [(rech, stream_len // c)]

        roll_v, _ = lead._eval(blk.roll_cfg, (raw,), "roll")
        _expect(roll_v.shape[-1] == c, "roll channels")
        branches.append((sb.add_input(roll_v.to(dt).repeat(m, 1, 1)), roll_v.shape[1]))
        if blk.mel_cfg is not None:
            low = _lower_mel_branch(lead, sb, blk.mel_cfg, raw_m, t0)
            if low is not None:
                mel_li, mel_t, mel_c = low
                _expect(mel_c == c, "mel channels")
                branches.append((mel_li, mel_t))
            else:
                mel_v, _ = lead._eval(blk.mel_cfg, (raw,), "mel")
                _expect(mel_v.shape[-1] == c, "mel channels")
                branches.append((sb.add_input(mel_v.to(dt).repeat(m, 1, 1)), mel_v.shape[1]))

        max_len = max(t for _li, t in branches)
        mid = blk.mid
        pad_m = _dsl_padding(mid.k, 1, 1)
        km, bm = weights(mid)
        edges = [(li, c, km[:, :, bi * c:(bi + 1) * c], mid.k, 1, 1, pad_m)
                 for bi, (li, _t) in enumerate(branches)]
        t_mid = _conv_out(max_len, mid.k, 1, 1, pad_m)
        mid_li = sb.add_op(edges, "lrelu", blk.lrelu, None, t_out=t_mid, c_out=c, bias=bm)

        rs = blk.res
        kres, bres = weights(rs)
        pad = _dsl_padding(rs.k, 1, rs.d)
        t_res = _conv_out(t_mid, rs.k, 1, rs.d, pad)
        res = sb.add_op([(mid_li, c, kres, rs.k, 1, rs.d, pad)], "none", 1.0, mid_li,
                        t_out=t_res, c_out=c, bias=bres)
        post = sb.add_op([], "lrelu", blk.lrelu, res, t_out=t_res, c_out=c)
        h = plan.heads[j + 1]
        kh, bh = weights(h)
        pad = _dsl_padding(h.k, 1, h.d)
        head = sb.add_op([(res, c, kh, h.k, 1, h.d, pad)], "tanh", 1.0, None,
                         t_out=_conv_out(t_res, h.k, 1, h.d, pad), c_out=1, bias=bh)
        after_li = None
        if j == len(plan.blocks) - 1:
            a = plan.after
            _expect(a.chin == c, "after channels")
            ka, ba = weights(a)
            pad = _dsl_padding(a.k, 1, a.d)
            after_li = sb.add_op([(post, c, ka, a.k, 1, a.d, pad)], "tanh", 1.0, None,
                                 t_out=_conv_out(t_res, a.k, 1, a.d, pad), c_out=a.chout, bias=ba)

        outs = sb.run(weight_grads)
        if j == 0:
            feats_out.append((plan.before_tags, outs[bef]))
            heads_out.append(outs[h0])
        feats_out.append((blk.res_tags, outs[res]))
        heads_out.append(outs[head])
        x_prev = outs[post]
        if after_li is not None:
            out_final = outs[after_li]

    def split(y):
        return y.reshape(m, n, *y.shape[1:])

    for tags, y in feats_out:
        ys = split(y)
        for i in range(m):
            per_member_feats[i].append((tags, ys[i]))
    return {"output": split(out_final), "features": [split(h) for h in heads_out]}, per_member_feats
