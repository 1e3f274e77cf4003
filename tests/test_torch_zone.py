"""The port's zone form of the MSD (``conv_impl='fused_zoned'``) against the JAX package, on the CPU.

The JAX package's own zoned tests run its Pallas kernel in interpret mode and
show that ``'fused_zoned'`` equals its XLA path up to layout: the same
logits, every zone map the folded XLA map, gradients within 3e-3. So the
port is held against that composition: JAX's XLA path, with the zone
chain's maps folded by JAX's own ``fold_group_zones``. The zone helpers are
plain ``jnp`` and are held directly, exactly. On the CPU the port's stack
takes its plain version, whose lane masks are those the CUDA kernels apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models import DiscriminatorS as JaxDiscriminatorS
from hifigan_tpu.ops.pallas import conv_stack as jcs
from hifigan_tpu.train.checkpoint import convert_torch_discriminators
from hifigan_tpu_torch.models import DiscriminatorS
from hifigan_tpu_torch.ops import conv_stack as cs
from tests.torch_port_helpers import numpy_state, run_cheap

WIDTH = 128
# V1's grouped MSD layers (c_in, c_out, stride, groups) at width 128; layer 1
# zones only with zone_min_groups <= 4
LAYERS = {1: (128, 128, 2, 4), 2: (128, 256, 2, 16), 3: (256, 512, 4, 16),
          4: (512, 1024, 4, 16), 5: (1024, 1024, 1, 16)}
K, PAD = 41, 20


def _folds(layer):
    ci, ch, _, g = LAYERS[layer]
    return 128 // (ci // g), 128 // (ch // g)


def _weights(rng, ci, ch, g):
    kern = rng.standard_normal((K, ci // g, ch)) / np.sqrt(K * ci // g)
    return kern.astype(np.float32), (0.1 * rng.standard_normal(ch)).astype(np.float32)


@pytest.mark.parametrize("t", [4096, 2049, 1025])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_zone_helpers_equal_jax(layer, t):
    """Banded table, bias, spec, fold and unfold: equal to JAX's exactly."""
    ci, ch, s, g = LAYERS[layer]
    f_in, f_out = _folds(layer)
    rng = np.random.default_rng(layer)
    kern, bias = _weights(rng, ci, ch, g)
    jk, jb, jspec = jcs.zone_grouped_layer(jnp.asarray(kern), jnp.asarray(bias), s, PAD, f_in,
                                           f_out, g, 0.1, t)
    tk, tb, tspec = cs.zone_grouped_layer(torch.from_numpy(kern), torch.from_numpy(bias), s,
                                          PAD, f_in, f_out, g, 0.1, t)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (tspec.c_out, tspec.kernel, tspec.stride, tspec.groups, tspec.pad_l, tspec.pad_r,
            tspec.slope, tspec.lane_period, tspec.lane_valid) == (
        jspec.c_out, jspec.kernel, jspec.stride, jspec.groups, jspec.pad_l, jspec.pad_r,
        jspec.slope, jspec.lane_period, jspec.lane_valid)
    assert (tspec.lane_period > 0) == (((t + 2 * PAD - K) // s + 1) % f_out > 0)
    x = rng.standard_normal((2, t, ci)).astype(np.float32)
    z = cs.fold_group_zones(torch.from_numpy(x), g, f_in)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jcs.fold_group_zones(jnp.asarray(x), g,
                                                                             f_in)))
    assert z.is_contiguous()
    y = rng.standard_normal((2, -(-t // f_out), g * f_out * (ch // g))).astype(np.float32)
    for t_out in (None, t - 1):
        np.testing.assert_array_equal(
            cs.unfold_group_zones(torch.from_numpy(y), g, f_out, t_out=t_out).numpy(),
            np.asarray(jcs.unfold_group_zones(jnp.asarray(y), g, f_out, t_out=t_out)))


def _xla_chain(x, weights, layers):
    """JAX's XLA convs (NWC) + bias + leaky ReLU over the layers."""
    ys = []
    for (kern, bias), layer in zip(weights, layers):
        s, g = LAYERS[layer][2], LAYERS[layer][3]
        x = jax.lax.conv_general_dilated(x, jnp.asarray(kern), (s,), [(PAD, PAD)],
                                         dimension_numbers=("NWC", "WIO", "NWC"),
                                         feature_group_count=g) + jnp.asarray(bias)
        x = jnp.where(x >= 0, x, 0.1 * x)
        ys.append(x)
    return ys


@pytest.mark.parametrize("t", [2048, 1025, 513])
def test_plain_stack_with_lane_masks_matches_the_folded_xla_chain(t):
    """V1's chain (layers 2-5) on the zone layout through the port's plain
    stack: every layer is JAX's XLA layer folded by JAX's
    ``fold_group_zones``, its fold-padding lanes exactly zero. The plain
    backward over the same outputs, lane masks included, is autograd's."""
    layers = (2, 3, 4, 5)
    rng = np.random.default_rng(t)
    weights = [_weights(rng, LAYERS[l][0], LAYERS[l][1], LAYERS[l][3]) for l in layers]
    x = (0.5 * rng.standard_normal((2, t, LAYERS[2][0]))).astype(np.float32)
    want = _xla_chain(jnp.asarray(x), weights, layers)
    g = 16
    zks, zbs, specs, t_in = [], [], [], t
    for (kern, bias), layer in zip(weights, layers):
        f_in, f_out = _folds(layer)
        zk, zb, spec = cs.zone_grouped_layer(torch.from_numpy(kern), torch.from_numpy(bias),
                                             LAYERS[layer][2], PAD, f_in, f_out, g, 0.1, t_in)
        zks.append(zk.requires_grad_())
        zbs.append(zb.contiguous().requires_grad_())
        specs.append(spec)
        t_in = (t_in + 2 * PAD - K) // LAYERS[layer][2] + 1
    assert any(sp.lane_period for sp in specs) == (t != 2048)
    xz = cs.fold_group_zones(torch.from_numpy(x), g, _folds(2)[0]).requires_grad_()
    ys = cs.fused_conv_stack(xz, zks, zbs, specs)
    for y, w, layer, sp in zip(ys, want, layers, specs):
        folded = np.asarray(jcs.fold_group_zones(w, g, _folds(layer)[1]))
        assert tuple(y.shape) == folded.shape
        np.testing.assert_allclose(y.detach().numpy(), folded, rtol=0,
                                   atol=1e-4 * np.abs(folded).max())
        mask = cs.lane_mask(sp, y.shape[1])
        if mask is not None:
            assert bool((y.detach()[:, mask == 0] == 0).all())
            assert bool((mask == 0).any())
    dys = [torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32)) for y in ys]
    got = torch.autograd.grad(ys, [xz, *zks, *zbs], dys)
    saved = [y.detach() for y in ys]
    dx, dks, dbs = cs.fused_conv_stack_backward_reference(
        xz.detach(), [k.detach() for k in zks], saved, dys, specs)
    for a, b in zip(got, [dx, *dks, *dbs]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


def _jax_variables(port: DiscriminatorS) -> dict:
    """The port module's weights as JAX ``DiscriminatorS`` variables."""
    sd = {f"discriminators.0.{k}": v for k, v in numpy_state(port).items()}
    msd = convert_torch_discriminators({"msd": sd})["msd"]
    out = {"params": msd["params"]["discriminators_0"]}
    if "spectral" in msd:
        out["spectral"] = msd["spectral"]["discriminators_0"]
    return out


def _port_grad_names(mods: dict) -> dict:
    """JAX parameter gradients in the port's names and layouts."""
    out = {}
    for mod, leaf in mods.items():
        tk = f"convs.{mod.split('_')[-1]}" if mod.startswith("convs_") else "conv_post"
        if "v" in leaf:
            out[f"{tk}.weight_v"] = np.transpose(np.asarray(leaf["v"]), (2, 1, 0))
            out[f"{tk}.weight_g"] = np.asarray(leaf["g"]).reshape(-1, 1, 1)
        else:
            out[f"{tk}.weight_orig"] = np.transpose(np.asarray(leaf["kernel"]), (2, 1, 0))
        out[f"{tk}.bias"] = np.asarray(leaf["bias"])
    return out


def _zone_maps(port: DiscriminatorS) -> dict:
    """{map index: (groups, fold)} of the zone chains' maps (index 0 is conv_0's)."""
    stack = port.stack_layers()
    return {1 + i: (g, 128 // (stack[i][1] // g)) for g, idx in port.runs(True) if g
            for i in idx}


@pytest.mark.parametrize("t,spectral,min_groups", [(512, False, 8), (257, False, 2),
                                                   (257, True, 8)])
def test_fused_zoned_discriminator_matches_jax_xla_with_folded_maps(t, spectral, min_groups):
    """Width 128, B=2: logits within 2e-4; every zone map JAX's XLA map
    folded (zeroed padding lanes included); the gradients of
    sum|logits| + 0.1 * sum mean|fmap| (JAX's means over the folded maps)
    in the input and every parameter within JAX's bar of 3e-3."""
    port = DiscriminatorS(use_spectral_norm=spectral, width=WIDTH, conv_impl="fused_zoned",
                          zone_min_groups=min_groups,
                          generator=torch.Generator().manual_seed(t))
    zone = _zone_maps(port)
    assert set(zone) >= {2, 3, 4, 5} and (1 in zone) == (min_groups <= 4)
    variables = _jax_variables(port)
    x = (0.3 * np.random.default_rng(t).standard_normal((2, t))).astype(np.float32)
    jd = JaxDiscriminatorS(use_spectral_norm=spectral, width=WIDTH, conv_impl="xla")

    def loss(params, xj):
        logits, fmap = jd.apply({**variables, "params": params}, xj)
        folded = [jcs.fold_group_zones(f, *zone[i]) if i in zone else f
                  for i, f in enumerate(fmap)]
        return (jnp.sum(jnp.abs(logits)) + 0.1 * sum(jnp.mean(jnp.abs(f)) for f in folded),
                (logits, folded))

    (_, (want_logits, want_maps)), (g_params, g_x) = run_cheap(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), variables["params"],
        jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    logits, fmap = port(xt)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=0,
                               atol=2e-4)
    assert len(fmap) == len(want_maps)
    for i, (got, want) in enumerate(zip(fmap, want_maps)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, i
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()), err_msg=str(i))
        if i in zone:
            assert bool((got.detach()[torch.from_numpy(want == 0)] == 0).all()), i
    total = logits.abs().sum() + 0.1 * sum(f.abs().mean() for f in fmap)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(total, [xt, *port.parameters()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g_x), rtol=3e-3, atol=3e-3)
    want_p = _port_grad_names(g_params)
    assert set(want_p) == set(names)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want_p[name], rtol=3e-3, atol=3e-3, err_msg=name)


def test_zoned_paired_call_equals_two_calls():
    """``pair=`` builds the zone tables once for both inputs: logits, maps
    and every gradient equal two separate calls'."""
    port = DiscriminatorS(width=WIDTH, conv_impl="fused_zoned",
                          generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    y, y_hat = (torch.from_numpy((0.3 * rng.standard_normal((2, 257))).astype(np.float32))
                for _ in range(2))

    def loss(outs):
        (lr, fr), (lg, fg) = outs
        return (lr.abs().sum() + lg.abs().sum()
                + 0.1 * sum((a - b).abs().mean() for a, b in zip(fr, fg)))

    paired = port(y, pair=y_hat)
    two = (port(y), port(y_hat))
    for a, b in zip(jax.tree_util.tree_leaves(paired), jax.tree_util.tree_leaves(two)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    params = list(port.parameters())
    for a, b in zip(torch.autograd.grad(loss(paired), params),
                    torch.autograd.grad(loss(two), params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t", [4096, 2049, 1025])
def test_zone_chain_is_v1s_chain(t):
    """``DiscriminatorS.zone_chain`` at V1 width over layer 1's output at the
    three scales: layers 2-5 as one chain with (f_in, f_out) (16, 8), (8, 4),
    (4, 2), (2, 2), kk 5, 8, 12, 21 and stride 1, 2, 2, 1; each table JAX's
    for its layer at its input length; the exit length the std chain's."""
    port = DiscriminatorS(width=WIDTH, conv_impl="fused_zoned",
                          generator=torch.Generator().manual_seed(t))
    assert port.runs(True) == [(None, [0]), (16, [1, 2, 3, 4]), (None, [5, 6])]
    stack = port.stack_layers()
    layers = [c.kernel_nwc(False, torch.float32) for c in [*port.convs[1:], port.conv_post]]
    zks, zbs, zspecs, f_entry, f_exit, t_out = port.zone_chain(layers, [1, 2, 3, 4], t)
    assert (f_entry, f_exit) == (16, 2)
    folds = [(zk.shape[1] // (stack[i][0] // stack[i][4]), sp.c_out // stack[i][1])
             for i, zk, sp in zip([1, 2, 3, 4], zks, zspecs)]
    assert folds == [(16, 8), (8, 4), (4, 2), (2, 2)]
    assert [(sp.kernel, sp.stride) for sp in zspecs] == [(5, 1), (8, 2), (12, 2), (21, 1)]
    t_in = t
    for i, zk, zb, sp in zip([1, 2, 3, 4], zks, zbs, zspecs):
        ci, ch, k, s, g, p, slope = stack[i]
        kern, bias = (v.detach().numpy() for v in layers[i])
        jk, jb, jspec = jcs.zone_grouped_layer(jnp.asarray(kern), jnp.asarray(bias), s, p,
                                               128 // (ci // g), 128 // (ch // g), g, slope, t_in)
        np.testing.assert_array_equal(zk.detach().numpy(), np.asarray(jk))
        np.testing.assert_array_equal(zb.detach().numpy(), np.asarray(jb))
        assert (sp.pad_l, sp.pad_r, sp.lane_period, sp.lane_valid) == (
            jspec.pad_l, jspec.pad_r, jspec.lane_period, jspec.lane_valid)
        t_in = cs.out_len(t_in, cs.LayerSpec(ch, k, s, g, p, p, slope))
    assert t_out == t_in
    assert any(sp.lane_period for sp in zspecs) == (t != 4096)
