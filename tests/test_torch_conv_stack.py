"""The conv-stack function's plain version against the JAX Pallas kernel
(``fused_conv_stack(..., interpret=True)``, as tests/test_pallas_conv_stack.py
runs it), on the CPU, in fp32.

N=2, T=256, C0=128 through (128, k41, s2, g4), (256, k41, s2, g16) and
(1, k3): the MSD's strided, grouped layers and its conv_post. The JAX
function and its VJP are compiled once for the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.ops.pallas import conv_stack as jcs
from hifigan_tpu_torch.ops import conv_stack as cs

ATOL = 1e-5
SPECS = [(128, 41, 2, 4, 20, 20, 0.1), (256, 41, 2, 16, 20, 20, 0.1), (1, 3, 1, 1, 1, 1, 1.0)]
C0, T, N = 128, 256, 2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, T, C0)) * 0.5).astype(np.float32)
    ks, bs = [], []
    c = C0
    for co, k, _, g, *_ in SPECS:
        fan = k * (c // g)
        ks.append((rng.standard_normal((k, c // g, co)) / np.sqrt(fan) * 1.5).astype(np.float32))
        bs.append((rng.standard_normal(co) * 0.1).astype(np.float32))
        c = co
    return x, ks, bs


def _cotangents(seed, last_only=False):
    rng = np.random.default_rng(seed)
    shapes, t = [], T
    for co, k, s, _, pl, pr, _ in SPECS:
        t = (t + pl + pr - k) // s + 1
        shapes.append((N, t, co))
    cots = [(rng.standard_normal(sh) * 0.01).astype(np.float32) for sh in shapes]
    return [np.zeros_like(c) for c in cots[:-1]] + cots[-1:] if last_only else cots


@pytest.fixture(scope="module")
def jax_vjp():
    specs = [jcs.LayerSpec(*s) for s in SPECS]

    def vjp(x, ks, bs, cots):
        ys, pull = jax.vjp(
            lambda x, ks, bs: jcs.fused_conv_stack(x, ks, bs, specs, interpret=True), x, ks, bs)
        return ys, pull(list(cots))

    def arrays(x, ks, bs, cots):
        return (jnp.asarray(x), [jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs],
                [jnp.asarray(c) for c in cots])

    x, ks, bs = _inputs(0)
    # the backend's cheap codegen: the same HLO, a compile about half as long
    run = jax.jit(vjp).lower(*arrays(x, ks, bs, _cotangents(1))).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})

    def call(x, ks, bs, cots):
        ys, (dx, dks, dbs) = run(*arrays(x, ks, bs, cots))
        return [np.asarray(y) for y in ys], np.asarray(dx), [np.asarray(k) for k in dks], \
            [np.asarray(b) for b in dbs]

    return call


def _port(x, ks, bs, cots, weight_grads=True, last_only=False):
    xt = torch.tensor(x, requires_grad=True)
    kt = [torch.tensor(k, requires_grad=True) for k in ks]
    bt = [torch.tensor(b, requires_grad=True) for b in bs]
    ys = cs.fused_conv_stack(xt, kt, bt, [cs.LayerSpec(*s) for s in SPECS],
                             weight_grads=weight_grads)
    pairs = list(zip(ys, cots))[-1:] if last_only else zip(ys, cots)
    loss = sum((y * torch.tensor(c)).sum() for y, c in pairs)
    dx, *rest = torch.autograd.grad(loss, [xt, *kt, *bt])
    return [y.detach().numpy() for y in ys], dx.numpy(), [g.numpy() for g in rest[:3]], \
        [g.numpy() for g in rest[3:]]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("last_only", [False, True])
def test_plain_version_matches_jax_forward_and_grads(jax_vjp, last_only):
    x, ks, bs = _inputs(0)
    cots = _cotangents(1, last_only)
    want = jax_vjp(x, ks, bs, cots)
    got = _port(x, ks, bs, cots, last_only=last_only)
    assert [y.shape for y in got[0]] == [(2, 128, 128), (2, 64, 256), (2, 64, 1)]
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _close(got[1], want[1])
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        _close(g, w)


def test_weight_grads_false_gives_zero_weight_grads(jax_vjp):
    x, ks, bs = _inputs(0)
    cots = _cotangents(1)
    want = jax_vjp(x, ks, bs, cots)
    got = _port(x, ks, bs, cots, weight_grads=False)
    _close(got[1], want[1])
    assert all(not g.any() for g in got[2] + got[3])


def test_two_input_call_matches_jax_per_input(jax_vjp):
    x1, ks, bs = _inputs(0)
    x2 = _inputs(2)[0]
    ys = cs.fused_conv_stack([torch.tensor(x1), torch.tensor(x2)], [torch.tensor(k) for k in ks],
                             [torch.tensor(b) for b in bs], [cs.LayerSpec(*s) for s in SPECS])
    assert len(ys) == 2
    for xi, got in zip((x1, x2), ys):
        want = jax_vjp(xi, ks, bs, _cotangents(1))[0]
        for g, w in zip(got, want):
            _close(g.numpy(), w)


@pytest.mark.parametrize("need_x,weight_grads,dead", [
    (True, True, ()), (False, True, (0, 1)), (True, False, (1,))])
def test_backward_reference_matches_autograd(need_x, weight_grads, dead):
    """The kernels' plain backward (given the saved outputs) equals autograd
    through the plain forward, with dead cotangents, an input that needs no
    gradient and ``weight_grads=False``."""
    x, ks, bs = _inputs(3)
    specs = [cs.LayerSpec(*s) for s in SPECS]
    xt = torch.tensor(x, requires_grad=need_x)
    kt = [torch.tensor(k, requires_grad=True) for k in ks]
    bt = [torch.tensor(b, requires_grad=True) for b in bs]
    ys = cs.fused_conv_stack_reference(xt, kt, bt, specs, weight_grads=weight_grads)
    dys = [None if i in dead else torch.tensor(c) for i, c in enumerate(_cotangents(4))]
    loss = sum((y * d).sum() for y, d in zip(ys, dys) if d is not None)
    want = torch.autograd.grad(loss, ([xt] if need_x else []) + kt + bt)
    dx, dks, dbs = cs.fused_conv_stack_backward_reference(
        xt.detach(), [torch.tensor(k) for k in ks], [y.detach() for y in ys], dys, specs,
        need_x=need_x, weight_grads=weight_grads)
    got = ([dx] if need_x else []) + [
        g if g is not None else torch.zeros_like(w) for g, w in zip(dks + dbs, kt + bt)]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)


def test_out_len_matches_jax_plan():
    t, specs = T, [cs.LayerSpec(*s) for s in SPECS]
    lens = []
    for sp in specs:
        t = cs.out_len(t, sp)
        lens.append(t)
    plans = jcs._plans(tuple(jcs.LayerSpec(*s) for s in SPECS), T, C0, N, 256, 4)
    assert lens == [lp.t_out for plan in plans for lp in plan.layers]
