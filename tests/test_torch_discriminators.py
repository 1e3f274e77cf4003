"""The port's discriminators against the JAX package's (``conv_impl='xla'``), on the CPU.

Weights: a seeded port module's state_dict goes to JAX through the JAX
package's ``convert_torch_discriminators`` and comes back into a module of
another seed through the port's ``discriminator_state_dict_from_jax``, so
both packages run the carried weights. Inputs are made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.models import (
    DiscriminatorS as JaxDiscriminatorS,
    MultiPeriodDiscriminator as JaxMPD,
    MultiScaleDiscriminator as JaxMSD,
)
from hifigan_tpu.train.checkpoint import convert_torch_discriminators
from hifigan_tpu_torch.models import (
    DiscriminatorS,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from hifigan_tpu_torch.train.checkpoint import discriminator_state_dict_from_jax
from tests.torch_port_helpers import numpy_state

T = 256
MSD = dict(width=16, num_scales=2)
MPD = dict(periods=(2, 3), channels=(4, 8, 8, 8))


def _wave(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, T)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """(JAX variables, port modules loaded through the port's carrier)."""
    seed = torch.Generator().manual_seed(0)
    src_mpd = MultiPeriodDiscriminator(**MPD, generator=seed)
    src_msd = MultiScaleDiscriminator(**MSD, conv_impl="xla", generator=seed)
    jvars = convert_torch_discriminators({"mpd": numpy_state(src_mpd), "msd": numpy_state(src_msd)})
    sd = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars["mpd"]),
                                           jax.tree_util.tree_map(np.asarray, jvars["msd"]))
    other = torch.Generator().manual_seed(1)
    mpd = MultiPeriodDiscriminator(**MPD, generator=other)
    msd = MultiScaleDiscriminator(**MSD, conv_impl="xla", generator=other)
    mpd.load_state_dict(sd["mpd"])
    msd.load_state_dict(sd["msd"])
    return jvars, mpd, msd


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def _port_grads(fn, *waves):
    xs = [torch.tensor(w, requires_grad=True) for w in waves]
    out = fn(*xs)
    leaves = [t for t in jax.tree_util.tree_leaves(out) if torch.is_tensor(t)]
    loss = sum((t.float() * (0.01 * (i + 1))).sum() for i, t in enumerate(leaves))
    return out, torch.autograd.grad(loss, xs)


def _jax_grads(fn, *waves):
    """fn(*xs) -> (outputs, extra): the outputs, input grads of the same
    loss as :func:`_port_grads`, and ``extra`` (state the call returns)."""

    def loss(*xs):
        out, extra = fn(*xs)
        return sum((t.astype(jnp.float32) * (0.01 * (i + 1))).sum()
                   for i, t in enumerate(jax.tree_util.tree_leaves(out))), (out, extra)

    grads, (out, extra) = jax.jit(jax.grad(loss, argnums=tuple(range(len(waves))),
                                           has_aux=True))(*map(jnp.asarray, waves))
    return out, grads, extra


def test_msd_matches_jax_with_spectral_update(carried):
    """Logits, fmaps, input grads and the scale-0 ``u`` after a D-update traversal."""
    jvars, _, msd = carried
    y, y_hat = _wave(0), _wave(1)
    jmsd = JaxMSD(**MSD, conv_impl="xla")
    want, want_g, new = _jax_grads(
        lambda a, b: jmsd.apply(jvars["msd"], a, b, True, mutable=["spectral"]), y, y_hat)
    got, got_g = _port_grads(lambda a, b: msd(a, b, update_spectral=True), y, y_hat)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(g, w)
    for g, w in zip(got_g, want_g):
        _close(g, w)
    u = jax.tree_util.tree_map(np.asarray, new["spectral"])["discriminators_0"]
    for key, buf in msd.named_buffers():
        if key.endswith("weight_u"):
            mod = key.split(".")[2]
            name = f"convs_{key.split('.')[3]}" if mod == "convs" else "conv_post"
            _close(buf, u[name]["u"], atol=1e-6)


def test_mpd_matches_jax(carried):
    jvars, mpd, _ = carried
    y, y_hat = _wave(2), _wave(3)
    jmpd = JaxMPD(**MPD)
    want, want_g, _ = _jax_grads(
        lambda a, b: (jmpd.apply({"params": jvars["mpd"]["params"]}, a, b), None), y, y_hat)
    got, got_g = _port_grads(lambda a, b: mpd(a, b), y, y_hat)
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape  # (B, H, W, C) feature maps
        _close(g, w)
    for g, w in zip(got_g, want_g):
        _close(g, w)


def test_discriminator_s_pair_call_matches_jax(carried):
    """A weight-normed scale's shared real/fake call."""
    jvars, _, msd = carried
    y, y_hat = _wave(4), _wave(5)
    jd = JaxDiscriminatorS(width=16, conv_impl="xla")
    params = {"params": jvars["msd"]["params"]["discriminators_1"]}
    want, want_g, _ = _jax_grads(lambda a, b: (jd.apply(params, a, pair=b), None), y, y_hat)
    got, got_g = _port_grads(lambda a, b: msd.discriminators[1](a, pair=b), y, y_hat)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(g, w)
    for g, w in zip(got_g, want_g):
        _close(g, w)


@pytest.mark.parametrize("weight_grads", [True, False])
def test_fused_stack_path_matches_xla_path(carried, weight_grads):
    """``conv_impl='fused_stack'`` (on the CPU: the stack's plain version)
    gives the 'xla' path's logits, fmaps and grads; ``weight_grads=False``
    leaves zero weight grads."""
    _, _, msd = carried
    xla = msd.discriminators[1]
    fused = DiscriminatorS(width=16, conv_impl="fused_stack")
    fused.load_state_dict(xla.state_dict())
    y = _wave(6)
    got, got_g = _port_grads(lambda a: fused(a, weight_grads=weight_grads), y)
    want, want_g = _port_grads(lambda a: xla(a), y)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_g[0], want_g[0], rtol=0, atol=1e-5)
    logits, _ = fused(torch.tensor(y), weight_grads=weight_grads)
    params = [p for n, p in fused.named_parameters() if not n.startswith("convs.0.")]
    grads = torch.autograd.grad(logits.sum(), params)
    assert all(bool((g == 0).all()) != weight_grads for g in grads)


def test_conv_impl_options():
    """Every ``conv_impl`` the JAX trainer accepts builds; ``'fused_zoned'``
    needs a width that is a multiple of 128, as in the JAX package, and runs;
    ``fused=True`` builds and runs on both discriminators."""
    assert DiscriminatorS(width=16).resolve_impl(torch.zeros(1, 8)) == "xla"
    assert DiscriminatorS(width=16, conv_impl="pallas").resolve_impl(torch.zeros(1, 8)) == "pallas"
    zoned = DiscriminatorS(width=128, conv_impl="fused_zoned")
    assert zoned.resolve_impl(torch.zeros(1, 8)) == "fused_zoned"
    logits, fmap = zoned(torch.zeros(2, 300))
    assert logits.shape[0] == 2 and len(fmap) == 8
    with pytest.raises(ValueError, match="multiple of 128"):
        DiscriminatorS(width=16, conv_impl="fused_zoned")
    with pytest.raises(ValueError):
        DiscriminatorS(width=16, conv_impl="cudnn")
    y = torch.zeros(2, T)
    for d in (MultiPeriodDiscriminator(**MPD, fused=True),
              MultiScaleDiscriminator(**MSD, fused=True, conv_impl="xla")):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = d(y, y)
        assert all(r.shape[0] == g.shape[0] == 2 for r, g in zip(y_d_rs, y_d_gs))
        assert all(f.shape[0] == 2 for fm in fmap_rs + fmap_gs for f in fm)


def _fresh(jvars) -> dict:
    """Port modules' state_dicts from the JAX variables (the carried modules'
    spectral buffers move with each test that updates them)."""
    return discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars["mpd"]),
                                             jax.tree_util.tree_map(np.asarray, jvars["msd"]))


@pytest.mark.parametrize("update_spectral", [True, False])
@pytest.mark.parametrize("conv_impl", ["xla", "fused_stack"])
def test_fused_msd_matches_jax(carried, conv_impl, update_spectral):
    """``fused=True``: one 2B call a scale against the JAX package's: the
    logits, maps, input gradients, and scale 0's ``u`` (one power iteration
    for both halves) and ``v`` after the call."""
    jvars = carried[0]
    msd = MultiScaleDiscriminator(**MSD, conv_impl=conv_impl, fused=True)
    msd.load_state_dict(_fresh(jvars)["msd"])
    u0 = {k: v.clone() for k, v in msd.named_buffers() if k.endswith("weight_u")}
    y, y_hat = _wave(7), _wave(8)
    jmsd = JaxMSD(**MSD, conv_impl="xla", fused=True)
    want, want_g, new = _jax_grads(
        lambda a, b: jmsd.apply(jvars["msd"], a, b, update_spectral, mutable=["spectral"]),
        y, y_hat)
    got, got_g = _port_grads(lambda a, b: msd(a, b, update_spectral=update_spectral), y, y_hat)
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    for g, w in zip(got_g, want_g):
        _close(g, w)
    u = jax.tree_util.tree_map(np.asarray, new["spectral"])["discriminators_0"]
    params = dict(msd.named_parameters())
    for key, buf in u0.items():
        mod = key.split(".")[2]
        name = f"convs_{key.split('.')[3]}" if mod == "convs" else "conv_post"
        _close(dict(msd.named_buffers())[key], u[name]["u"], atol=1e-6)
        if update_spectral:
            w = params[key[:-len("u")] + "orig"].detach()
            v = w.reshape(w.shape[0], -1).t() @ buf
            _close(dict(msd.named_buffers())[key[:-1] + "v"], v / (v.norm() + 1e-12), atol=1e-6)


@pytest.mark.parametrize("update_spectral", [True, False])
def test_fused_mpd_matches_jax(carried, update_spectral):
    jvars = carried[0]
    mpd = MultiPeriodDiscriminator(**MPD, fused=True)
    mpd.load_state_dict(_fresh(jvars)["mpd"])
    y, y_hat = _wave(9), _wave(10)
    jmpd = JaxMPD(**MPD, fused=True)
    want, want_g, _ = _jax_grads(
        lambda a, b: (jmpd.apply({"params": jvars["mpd"]["params"]}, a, b, update_spectral),
                      None), y, y_hat)
    got, got_g = _port_grads(lambda a, b: mpd(a, b, update_spectral), y, y_hat)
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    for g, w in zip(got_g, want_g):
        _close(g, w)
