"""The per-layer MSD conv (``msd_conv1d_lrelu``) of the port against the JAX
package, on the CPU: the op's plain version against the
``lax.conv_general_dilated`` oracle of ``tests/test_pallas_msd.py`` at the
eight MSD layer geometries (reduced widths), without a bias at asymmetric
padding, dilated, and once against the Pallas kernel itself in interpret
mode; ``DiscriminatorS(conv_impl='pallas')`` against the JAX MSD
(``'xla'``); ``ConfigurableModule(conv_impl='pallas_interpret')`` against
the JAX interpreter; the plain backward over a saved output; and the launch
counts ``chip_smoke.py`` derives for a V1 train step. The CUDA kernels are
held against the same plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models import MultiScaleDiscriminator as JaxMSD
from hifigan_tpu.ops.pallas.msd_conv import msd_conv1d_lrelu as jax_msd_conv
from hifigan_tpu.train.checkpoint import convert_torch_discriminators
from hifigan_tpu_torch.models import MultiScaleDiscriminator
from hifigan_tpu_torch.ops import msd_conv as tmsd
from tests.torch_port_helpers import dsl_pair, leaves, numpy_state, run_cheap, tiny_train_config

FWD_ATOL, FWD_RTOL = 2e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-4
# (Cin, Cout, K, stride, groups, padding): tests/test_pallas_msd.py:16-25
LAYERS = [
    (1, 16, 15, 1, 1, 7),
    (16, 16, 41, 2, 4, 20),
    (16, 32, 41, 2, 16, 20),
    (32, 64, 41, 4, 16, 20),
    (64, 128, 41, 4, 16, 20),
    (128, 128, 41, 1, 16, 20),
    (128, 128, 5, 1, 1, 2),
    (128, 1, 3, 1, 1, 1),
]
# (Cin, Cout, K, stride, dilation, groups, padding, bias, slope, T)
CASES = {f"msd layer {i}": (ci, co, k, s, 1, g, p, True, 0.1 if co != 1 else 1.0, 256)
         for i, (ci, co, k, s, g, p) in enumerate(LAYERS)}
CASES["no bias, asymmetric padding"] = (8, 16, 5, 1, 1, 1, (4, 2), False, 0.2, 64)
CASES["dilated (k3 d9)"] = (8, 16, 3, 1, 9, 1, 9, True, 0.1, 96)
CASES["strided, asymmetric, odd length"] = (6, 12, 7, 3, 1, 3, (4, 1), True, 0.2, 101)


def _operands(case, seed):
    ci, co, k, s, d, g, p, has_bias, slope, t = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, t, ci)) * 0.3).astype(np.float32)
    kern = (rng.standard_normal((k, ci // g, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((co,)) * 0.1).astype(np.float32) if has_bias else None
    return x, kern, bias


def _oracle(x, kern, bias, case):
    _, _, _, s, d, g, p, _, slope, _ = case
    pads = (p, p) if isinstance(p, int) else p
    y = jax.lax.conv_general_dilated(x, kern, window_strides=(s,), padding=[pads],
                                     rhs_dilation=(d,), dimension_numbers=("NWC", "WIO", "NWC"),
                                     feature_group_count=g)
    if bias is not None:
        y = y + bias
    return jnp.where(y >= 0, y, slope * y) if slope != 1.0 else y


def _port(x, kern, bias, case, fn=tmsd.msd_conv1d_lrelu):
    _, _, _, s, d, g, p, _, slope, _ = case
    return fn(x, kern, bias, stride=s, padding=p, dilation=d, groups=g, slope=slope)


def _port_grads(x, kern, bias, case, w_out):
    ts = [torch.tensor(a, requires_grad=True) for a in (x, kern) + ((bias,) if bias is not None
                                                                  else ())]
    y = _port(ts[0], ts[1], ts[2] if bias is not None else None, case)
    return y, torch.autograd.grad((y * torch.from_numpy(w_out)).sum(), ts)


@pytest.mark.parametrize("name", list(CASES))
def test_msd_conv_forward_and_grads_match_xla(name):
    case = CASES[name]
    x, kern, bias = _operands(case, sum(map(ord, name)))
    args = (x, kern) + ((bias,) if bias is not None else ())

    def loss(*a):
        y = _oracle(a[0], a[1], a[2] if bias is not None else None, case)
        return (y * w_out).sum(), y

    w_out = np.asarray(_oracle(x, kern, bias, case))
    w_out = np.random.default_rng(1).standard_normal(w_out.shape).astype(np.float32)
    want_g, want = run_cheap(jax.grad(loss, argnums=tuple(range(len(args))), has_aux=True), *args)
    got, got_g = _port_grads(x, kern, bias, case, w_out)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_ATOL,
                               rtol=FWD_RTOL)
    for what, a, b in zip(("dx", "dkernel", "dbias"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=what)


def test_msd_conv_matches_the_pallas_kernel_in_interpret_mode():
    """One small strided, grouped case against the Pallas kernel itself
    (phase folding, group densification and its custom VJP)."""
    case = (4, 8, 5, 2, 1, 2, 2, True, 0.1, 32)
    x, kern, bias = _operands(case, 7)
    w_out = np.random.default_rng(8).standard_normal((2, 16, 8)).astype(np.float32)

    def loss(a, b, c):
        y = jax_msd_conv(a, b, c, stride=2, padding=2, groups=2, slope=0.1, interpret=True)
        return (y * w_out).sum(), y

    want_g, want = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(x, kern, bias)
    got, got_g = _port_grads(x, kern, bias, case, w_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_ATOL,
                               rtol=FWD_RTOL)
    for what, a, b in zip(("dx", "dkernel", "dbias"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["msd layer 1", "dilated (k3 d9)", "no bias, asymmetric padding"])
def test_backward_reference_matches_autograd(name, dtype):
    """The plain backward over a saved output (what the dx kernel is held
    against on the card) is autograd's backward of the plain forward in
    fp32, and rounds as the JAX backward does in bf16."""
    case = CASES[name]
    x, kern, bias = _operands(case, 3)
    xt, kt = torch.from_numpy(x).to(dtype), torch.from_numpy(kern)
    bt = None if bias is None else torch.from_numpy(bias)
    y = _port(xt, kt, bt, case)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(4)).to(dtype)
    _, _, _, s, d, g, p, _, slope, _ = case
    dx, dk, db = tmsd.msd_conv1d_lrelu_backward_reference(
        xt, kt, y, dy, stride=s, padding=p, dilation=d, groups=g, slope=slope)
    assert dx.dtype == dk.dtype == db.dtype == dtype
    if dtype == torch.bfloat16:  # dz rounds in bf16 with the slope cast to bf16
        slope_bf16 = float(torch.tensor(slope).to(dtype))
        dz = torch.where(y >= 0, dy, (dy.float() * slope_bf16).to(dtype))
        torch.testing.assert_close(db, dz.float().sum((0, 1)).to(dtype), rtol=0, atol=0)
        return
    ts = [xt.clone().requires_grad_(), kt.clone().requires_grad_()]
    if bt is not None:
        ts.append(bt.clone().requires_grad_())
    out = _port(ts[0], ts[1], ts[2] if bt is not None else None, case)
    want = torch.autograd.grad(out, ts, dy)
    for a, b in zip((dx, dk, db), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_discriminator_s_pallas_matches_jax_msd():
    """``MultiScaleDiscriminator(conv_impl='pallas')`` (every DiscriminatorS
    layer through the op, spectral scale included) against the JAX MSD's
    'xla' path: logits, feature maps, input grads and scale 0's ``u``."""
    port = MultiScaleDiscriminator(width=16, num_scales=2, conv_impl="pallas",
                                   generator=torch.Generator().manual_seed(0))
    jvars = convert_torch_discriminators({"msd": numpy_state(port)})["msd"]
    rng = np.random.default_rng(5)
    y, y_hat = ((rng.standard_normal((2, 256)) * 0.3).astype(np.float32) for _ in range(2))
    jmsd = JaxMSD(width=16, num_scales=2, conv_impl="xla")

    def loss(a, b):
        out, new = jmsd.apply(jvars, a, b, True, mutable=["spectral"])
        leaves_ = jax.tree_util.tree_leaves(out)
        return sum((t * (0.01 * (i + 1))).sum() for i, t in enumerate(leaves_)), (out, new)

    want_g, (want, new) = run_cheap(jax.grad(loss, argnums=(0, 1), has_aux=True), y, y_hat)
    xs = [torch.tensor(a, requires_grad=True) for a in (y, y_hat)]
    got = port(*xs, update_spectral=True)
    got_leaves = jax.tree_util.tree_leaves(got)
    got_g = torch.autograd.grad(sum((t * (0.01 * (i + 1))).sum()
                                    for i, t in enumerate(got_leaves)), xs)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 2 * 2 * (1 + 8)
    for a, b in zip(got_leaves, want_leaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    u = np.asarray(new["spectral"]["discriminators_0"]["conv_post"]["u"])
    np.testing.assert_allclose(port.discriminators[0].conv_post.weight_u.numpy(), u, atol=1e-6)


def test_discriminator_state_does_not_depend_on_conv_impl():
    """A ``do_*`` MSD state written under one impl loads, strictly, under every other."""
    impls = ("pallas", "xla", "fused_stack", "auto")
    states = {i: MultiScaleDiscriminator(width=16, num_scales=2, conv_impl=i,
                                         generator=torch.Generator().manual_seed(2)).state_dict()
              for i in impls}
    for src in impls:
        for dst in impls:
            m = MultiScaleDiscriminator(width=16, num_scales=2, conv_impl=dst)
            m.load_state_dict(states[src], strict=True)
            assert all(torch.equal(v, m.state_dict()[k]) for k, v in states[src].items())


def test_dsl_discriminator_pallas_interpret_matches_jax(monkeypatch):
    """The small all-in-one ensemble discriminator of
    ``tests/test_pallas_msd.py:153-187`` with every conv node through the
    op (its plain version for these CPU tensors; members interpreted, so
    their convs take the op too), against the JAX interpreter: outputs and
    parameter grads."""
    from hifigan_tpu.dsl.parsing import parse_layers
    from hifigan_tpu.dsl.static_configs import get_discriminator_config
    from hifigan_tpu_torch.models.layers import NormConv1d
    from hifigan_tpu_torch.train.checkpoint import dsl_state_dict_from_jax

    layers = parse_layers(["roll:1,5,1", "roll:2,5,2", "all:3,5,1", "roll:4,3,1"])
    cfg = get_discriminator_config(layers, expansion_size=1, ensemble_size=2)
    x = np.random.default_rng(0).standard_normal((2, 40, 1)).astype(np.float32)
    jm, variables, tm = dsl_pair(cfg, x, jax_kw={"conv_impl": "xla"},
                                 torch_kw={"conv_impl": "pallas_interpret",
                                           "member_impl": "interpret"})
    calls = []
    real = tmsd.msd_conv1d_lrelu_reference
    monkeypatch.setattr(tmsd, "msd_conv1d_lrelu_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tm(torch.from_numpy(x))
    assert len(calls) == sum(isinstance(m, NormConv1d) for m in tm.modules()) > 0

    def jloss(params):
        out = jm.apply({**variables, "params": params}, jnp.asarray(x))
        return sum(jnp.sum(t) for t in jax.tree_util.tree_leaves(out["output"])), out

    want_g, want = run_cheap(jax.grad(jloss, has_aux=True), variables["params"])
    g, w = leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(sum(t.sum() for t in leaves(got["output"])),
                                list(params.values()))
    want_sd = dsl_state_dict_from_jax({**variables,
                                       "params": jax.tree_util.tree_map(np.asarray, want_g)})
    for name, grad in zip(params, grads):
        np.testing.assert_allclose(grad.numpy(), want_sd[name], atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def emulated_launches(monkeypatch):
    """Route the op through its autograd Function on the CPU, with the two
    launches emulated by the plain versions and counted: what the CUDA path
    would launch for the same calls."""
    counts = {"fwd": 0, "bwd_dx": 0}

    def fwd(g, x, kernel, bias):
        counts["fwd"] += 1
        return tmsd.msd_conv1d_lrelu_reference(
            x, kernel, bias, stride=g.stride, padding=(g.pad_l, g.pad_r), dilation=g.dilation,
            groups=g.groups, slope=g.slope)

    def dx(g, dy, y, kernel, x):
        counts["bwd_dx"] += 1
        return tmsd.msd_conv1d_lrelu_backward_reference(
            x, kernel, y, dy, stride=g.stride, padding=(g.pad_l, g.pad_r), dilation=g.dilation,
            groups=g.groups, slope=g.slope)[0]

    def op(x, kernel, bias, *, stride=1, padding=0, dilation=1, groups=1, slope=1.0):
        g = tmsd._geom(stride, padding, dilation, groups, slope)
        return tmsd._MsdConv.apply(g, x.contiguous(), kernel.to(x.dtype),
                                   None if bias is None else bias.to(x.dtype))

    monkeypatch.setattr(tmsd, "_launch_fwd", fwd)
    monkeypatch.setattr(tmsd, "_launch_dx", dx)
    monkeypatch.setattr(tmsd, "msd_conv1d_lrelu", op)
    return counts


def test_v1_step_launches_match_the_derived_count(monkeypatch):
    """A tiny V1 train step with ``msd_conv_impl='pallas'`` runs the launches
    ``chip_smoke.py`` derives from the step's structure (4 traversals a
    scale forward; dx skips conv_0 in the D half and the real traversal in
    the G half), and its metrics equal the 'xla' step's."""
    from chip_smoke import msd_launches_per_step
    from hifigan_tpu_torch.config import AttrDict
    from hifigan_tpu_torch.train import vocoder as tv

    h = tiny_train_config()
    batch = {"audio": (np.random.default_rng(0).standard_normal((2, h["segment_size"]))
                       * 0.1).astype(np.float32)}
    xla = tv.create_train_state(AttrDict(h, msd_conv_impl="xla"), seed=0, device="cpu")
    state = tv.create_train_state(AttrDict(h, msd_conv_impl="pallas"), seed=0, device="cpu")
    _, want = tv.make_train_step(AttrDict(h, msd_conv_impl="xla"))(xla, batch)
    counts = emulated_launches(monkeypatch)
    _, got = tv.make_train_step(AttrDict(h, msd_conv_impl="pallas"))(state, batch)
    assert counts == msd_launches_per_step(h.get("msd_num_scales", 3))
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6)


def test_distill_step_launches_match_the_derived_count(monkeypatch):
    """A tiny distill step (``_tiny_distill_config``) with
    ``conv_impl='pallas'`` runs the launches ``chip_smoke.py`` derives from
    the step's structure and each model's conv-op calls, and its losses,
    gradients (the Adam first moments) and updated parameters of the six
    groups equal the default step's."""
    from __graft_entry__ import _tiny_distill_config
    from chip_smoke import (
        distill_msd_launches_per_step,
        flat_losses,
        held_update,
        optimizer_snapshot,
        parameter_names,
    )
    from hifigan_tpu_torch.distill.model import DistillModels
    from hifigan_tpu_torch.distill.train import DistillTrainer
    from hifigan_tpu_torch.train.checkpoint import distill_state_dicts, load_distill_variables

    cfg, labels, weights = _tiny_distill_config(3)
    seg = cfg["loops"]["train"]["segment_length"]
    ref = DistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"], device="cpu")
    models = DistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                           conv_impl="pallas", device="cpu")
    ref.build(seg, seed=0)
    models.build(seg, seed=1)
    load_distill_variables(models, distill_state_dicts(ref))
    rng = np.random.default_rng(0)
    t_emb = seg // models.embedding_size
    batch = {"audio": (rng.standard_normal((3, seg)) * 0.1).astype(np.float32),
             "time_labels": {g: {k: rng.integers(0, len(v), (3, t_emb)) for k, v in grp.items()}
                             for g, grp in labels.items()}}
    ref_trainer = DistillTrainer(ref, cfg)
    ref_state, want = ref_trainer.make_train_step()(ref_trainer.create_state(build=False), batch)
    want = flat_losses(want)
    derived = distill_msd_launches_per_step(models, seg)
    assert derived["fwd"] > derived["bwd_dx"] > 0
    counts = emulated_launches(monkeypatch)
    trainer = DistillTrainer(models, cfg)
    state = trainer.create_state(build=False)
    before = {g: [p.detach().clone() for p in o.params] for g, o in state.optimizers.items()}
    ids = parameter_names(models)
    names = {g: [ids[id(p)] for p in o.params] for g, o in state.optimizers.items()}
    state, got = trainer.make_train_step()(state, batch)
    assert counts == derived
    for k, v in flat_losses(got).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    upd = held_update(names, trainer.flat_groups, before, optimizer_snapshot(state),
                      optimizer_snapshot(ref_state))
    assert upd["leaves"] == len(ids) and upd["grad_rel"] <= 1e-4, upd
    for g, (want_p, _) in optimizer_snapshot(ref_state).items():
        moved = 0
        for name, p0, a, b in zip(names[g], before[g], want_p, state.optimizers[g].params):
            np.testing.assert_allclose(b.detach().numpy(), a.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
            moved += not torch.equal(a, p0)
        assert moved > 0, g
