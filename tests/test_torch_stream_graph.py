"""The stream-graph kernel's plain version and the fused all-in-one member
against the JAX package, on the CPU.

The member is the production layer family at a short length (the
``_member_fusable_disc_config`` of ``tests/test_dsl.py``: a ``roll:`` and an
``all:`` block with the in-graph mel branch, T=144), two ensemble members,
weights carried from JAX. The JAX side runs its fused member path
(``member_impl='fused_interpret'``) through its XLA reference executor, as
``tests/test_full_scale_configs.py`` does, and its interpreter. The CUDA
kernels are held against the same plain version on the card
(``chip_smoke.py`` phase 8, ``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.dsl.module import ConfigurableModule as JaxModule
from hifigan_tpu.dsl.parsing import parse_layers
from hifigan_tpu.dsl.static_configs import get_discriminator_config
from hifigan_tpu.ops.pallas import stream_graph as jsg
from hifigan_tpu_torch.dsl import fused_member as fm
from hifigan_tpu_torch.dsl.module import ConfigurableModule
from hifigan_tpu_torch.ops import stream_graph as sg
from hifigan_tpu_torch.train.checkpoint import dsl_state_dict_from_jax
from tests.torch_port_helpers import dsl_pair, leaves, run_cheap

FWD_ATOL = 2e-5
BWD_RTOL, BWD_ATOL = 2e-4, 2e-3
LAYERS = ["roll:1,9,1", "roll:1,5,2", "roll:2,5,2", "all:3,5,2", "roll:4,3,1"]
SR = 16000


def _cfg(ensemble=2):
    return get_discriminator_config(parse_layers(LAYERS), expansion_size=1,
                                    ensemble_size=ensemble)


@pytest.fixture(scope="module")
def pair():
    x = np.random.default_rng(5).standard_normal((2, 144, 1)).astype(np.float32)
    kw = {"mel_sampling_rate_override": SR, "update_spectral": True}
    jm, variables, tm = dsl_pair(_cfg(), x, jax_kw=dict(kw, member_impl="interpret"),
                                 torch_kw=dict(kw, member_impl="fused"))
    return x, variables, tm


def _jax_module(member_impl, monkeypatch, **kw):
    monkeypatch.setattr(jsg, "REFERENCE_EXECUTOR", True)
    return JaxModule(config=_cfg(), mel_sampling_rate_override=SR, update_spectral=True,
                     member_impl=member_impl, **kw)


def _loss_jax(jm, variables, x):
    out = jm.apply(variables, x, mutable=["spectral"])[0]
    return sum(jnp.sum(jnp.abs(v)) for v in jax.tree_util.tree_leaves(out["output"])) + 0.1 * sum(
        jnp.mean(jnp.abs(f)) for f in jax.tree_util.tree_leaves(out["features"]))


def _loss_torch(tm, x):
    out = tm(x)
    return sum(v.abs().sum() for v in leaves(out["output"])) + 0.1 * sum(
        f.abs().mean() for f in leaves(out["features"]))


def _segments(tm, x):
    rec, real = [], fm.fused_stream_graph

    def spy(seg, inputs, tables, biases, members=1, weight_grads=True):
        rec.append((seg, [t.detach() for t in inputs], [t.detach() for t in tables],
                    [None if b is None else b.detach() for b in biases], members))
        return real(seg, inputs, tables, biases, members=members, weight_grads=weight_grads)

    fm.fused_stream_graph = spy
    try:
        with torch.no_grad():
            tm(x)
    finally:
        fm.fused_stream_graph = real
    return rec


@pytest.mark.parametrize("jax_impl", ["fused_interpret", "interpret"])
def test_fused_member_forward_matches_jax(pair, jax_impl, monkeypatch):
    x, variables, tm = pair
    jm = _jax_module(jax_impl, monkeypatch)
    want = run_cheap(lambda v, xx: jm.apply(v, xx, mutable=["spectral"])[0], variables,
                     jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    w, g = jax.tree_util.tree_leaves(want), leaves(got)
    assert len(w) == len(g) == 2 * (1 + 1 + 3) + 2 * (1 + 3)  # mean/var of out + heads; fmap
    for a, b in zip(w, g):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=FWD_ATOL, rtol=0)


def _torch_grads(tm, x, need_x=True):
    xt = torch.from_numpy(x).requires_grad_(need_x)
    tm.zero_grad()
    _loss_torch(tm, xt).backward()
    grads = {k: p.grad.detach().numpy() for k, p in tm.named_parameters()}
    return (xt.grad.numpy() if need_x else None), grads


def _jax_grads(jm, variables, x):
    params = variables["params"]

    def f(p, xx):
        return _loss_jax(jm, {**variables, "params": p}, xx)

    gp, gx = run_cheap(jax.grad(f, argnums=(0, 1)), params, jnp.asarray(x))
    tree = {"params": jax.tree_util.tree_map(np.asarray, gp), "spectral": variables["spectral"]}
    named = {k: v for k, v in dsl_state_dict_from_jax(tree).items()
             if not k.endswith(("weight_u", "weight_v")) or k.endswith("weight_v") and
             k[:-len("weight_v")] + "weight_g" in dsl_state_dict_from_jax(tree)}
    return np.asarray(gx), named


@pytest.mark.parametrize("case", ["inputs and weights", "input without grad", "weight_grads=False"])
def test_fused_member_backward_matches_jax_grad(pair, case, monkeypatch):
    x, variables, tm = pair
    frozen = case == "weight_grads=False"
    jm = _jax_module("fused_interpret", monkeypatch, weight_grads=not frozen)
    gx, gw = _jax_grads(jm, variables, x)
    port = ConfigurableModule(_cfg(), mel_sampling_rate_override=SR, update_spectral=True,
                              member_impl="fused", weight_grads=not frozen)
    port.build(torch.zeros(1, 144, 1))
    port.load_state_dict(tm.state_dict())
    port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in
                          dsl_state_dict_from_jax(variables).items()})
    tx, tw = _torch_grads(port, x, need_x=case != "input without grad")
    if tx is not None:
        np.testing.assert_allclose(tx, gx, rtol=BWD_RTOL, atol=BWD_ATOL)
    assert set(tw) == set(gw)
    for k, g in tw.items():
        if frozen:  # the JAX executor differentiates the weights all the same
            assert not np.any(g), k
        else:
            np.testing.assert_allclose(g, gw[k], rtol=BWD_RTOL, atol=BWD_ATOL, err_msg=k)


@pytest.mark.parametrize("masks", ["every input", "no input", "no dy on level 1", "no weights"])
def test_backward_reference_matches_autograd(pair, masks):
    """The plain backward (what the kernels are held against on the card)
    equals autograd through the plain forward, under the skip rules."""
    x, _, tm = pair
    g = torch.Generator().manual_seed(2)
    for seg, ins, tabs, bs, m in _segments(tm, torch.from_numpy(x)):
        need_x = masks != "no input"
        wg = masks != "no weights"
        xs = [t.clone().requires_grad_(need_x) for t in ins]
        tt = [t.clone().requires_grad_(wg) for t in tabs]
        bb = [None if b is None else b.clone().requires_grad_(wg) for b in bs]
        outs = sg.fused_stream_graph_reference(seg, xs, tt, bb, m)
        dys = [torch.randn(o.shape, generator=g) for o in outs]
        if masks == "no dy on level 1":
            dys[1] = None
        live = [i for i, d in enumerate(dys) if d is not None]
        wrt = (xs if need_x else []) + ((tt + [b for b in bb if b is not None]) if wg else [])
        got = torch.autograd.grad([outs[i] for i in live], wrt, [dys[i] for i in live],
                                  allow_unused=True)
        dxs, dws, dbs = sg.fused_stream_graph_backward_reference(
            seg, ins, [o.detach() for o in outs], dys, tabs, m, dx_mask=[need_x] * len(xs),
            dw_mask=[wg] * len(tt), db_mask=[wg and b is not None for b in bs])
        want = ((list(dxs) if need_x else [])
                + ((list(dws) + [d for d, b in zip(dbs, bs) if b is not None]) if wg else []))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if a is None or b is None:  # not reached: both sides agree it is zero
                assert (a is None or not a.any()) and (b is None or not b.any())
            else:  # the same sums in another order (dW sums ~10^3 fp32 terms)
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_weight_grads_false_gives_zero_weight_grads_and_same_input_grads(pair):
    x, _, tm = pair
    seg, ins, tabs, bs, m = _segments(tm, torch.from_numpy(x))[1]
    got = {}
    for wg in (True, False):
        xs = [t.clone().requires_grad_() for t in ins]
        tt = [t.clone().requires_grad_() for t in tabs]
        outs = sg.fused_stream_graph(seg, xs, tt, bs, members=m, weight_grads=wg)
        sum(o.square().sum() for o in outs).backward()
        got[wg] = ([t.grad for t in xs], [t.grad for t in tt])
    for a, b in zip(got[True][0], got[False][0]):
        torch.testing.assert_close(a, b)
    assert all(not t.any() for t in got[False][1]) and any(t.any() for t in got[True][1])


def test_production_member_segments_and_backward_plans():
    """The shipped discriminator lowers to 10 segments of 59 ops, and the
    backward plans run the launches chip_smoke.py derives per distill step:
    52 dx / 43 dW ops in a live (weights only) call, 59 dx in the frozen
    copy's call on generated audio."""
    import json

    cfg = json.load(open("configs/distill.json"))
    dcfg = get_discriminator_config(parse_layers(cfg["models"]["discriminator"]["layers"]),
                                    expansion_size=1, ensemble_size=1)
    tm = ConfigurableModule(dcfg, mel_sampling_rate_override=16000, member_impl="fused")
    tm.build(torch.zeros(1, 2730, 1))
    segs = _segments(tm, torch.zeros(1, 2730, 1))
    assert len(segs) == 10 and sum(len(s[0].ops) for s in segs) == 59
    counts = {"live_dx": 0, "live_dw": 0, "frozen_dx": 0}
    for j, (seg, ins, tabs, bs, m) in enumerate(segs):
        n_in, n_tab, n_out = len(ins), len(tabs), len(seg.ops)
        chained = [j > 0 and i == 0 for i in range(n_in)]  # x_prev carries a gradient
        # the mel branch's DFT and filterbank tables are constants: the ops without a bias
        w_tabs = [bs[oi] is not None for oi, op in enumerate(seg.ops) for _ in op.edges]
        live = sg.backward_plan(seg, chained, w_tabs, [b is not None for b in bs], [True] * n_out)
        frozen = sg.backward_plan(seg, [True] * n_in, [False] * n_tab, [False] * n_out,
                                  [True] * n_out)
        counts["live_dx"] += sum(g is not None and bool(g.jobs) for g in live)
        counts["live_dw"] += sum(g is not None and (any(g.dw) or g.db) for g in live)
        counts["frozen_dx"] += sum(g is not None and bool(g.jobs) for g in frozen)
    assert counts == {"live_dx": 52, "live_dw": 43, "frozen_dx": 59}


def test_member_parse_rejects_other_families_before_any_work():
    cfg = ("pfmap", ([("conv", (1, 2, 3)), ("lrelu", 0.1)], ["x"], [[("conv", (2, 1, 3))]]))
    tm = ConfigurableModule(cfg, member_impl="fused").build(torch.zeros(1, 16, 1))
    with pytest.raises(fm.StreamUnsupported):
        fm.parse_member(tm.config[2], "m")
    x = torch.randn(2, 16, 1, generator=torch.Generator().manual_seed(0))
    interp = ConfigurableModule(cfg, member_impl="interpret").build(torch.zeros(1, 16, 1))
    interp.load_state_dict(tm.state_dict())
    for a, b in zip(leaves(tm(x)), leaves(interp(x))):  # interpreted instead
        torch.testing.assert_close(a, b, rtol=0, atol=0)
