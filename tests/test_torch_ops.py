"""Port conv primitives vs the JAX ops (fp32 on CPU, <= 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.ops import conv as jconv
from hifigan_tpu_torch.ops import conv as tconv


@pytest.mark.parametrize("k,stride,padding,dilation,groups,cin,cout", [
    (7, 1, 3, 1, 1, 8, 16),
    (3, 1, 5, 5, 1, 16, 16),
    (5, 2, (1, 3), 1, 4, 8, 12),
])
def test_conv1d_matches_jax(k, stride, padding, dilation, groups, cin, cout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 37, cin)).astype(np.float32)
    w = rng.standard_normal((k, cin // groups, cout)).astype(np.float32) * 0.2
    b = rng.standard_normal((cout,)).astype(np.float32)
    ref = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                                  padding=padding, dilation=dilation, groups=groups))
    got = tconv.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                       stride=stride, padding=padding, dilation=dilation, groups=groups).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k,stride,padding,output_padding", [(16, 8, 4, 0), (4, 2, 1, 0), (5, 3, 1, 1)])
def test_conv_transpose1d_matches_jax(k, stride, padding, output_padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, 12)).astype(np.float32)
    w = rng.standard_normal((k, 12, 6)).astype(np.float32) * 0.2
    b = rng.standard_normal((6,)).astype(np.float32)
    ref = np.asarray(jconv.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                            stride=stride, padding=padding,
                                            output_padding=output_padding))
    got = tconv.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                 stride=stride, padding=padding,
                                 output_padding=output_padding).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_leaky_relu_and_weight_norm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 11, 5)).astype(np.float32)
    for slope in (0.1, 0.01):
        np.testing.assert_allclose(tconv.leaky_relu(torch.from_numpy(x), slope).numpy(),
                                   np.asarray(jconv.leaky_relu(jnp.asarray(x), slope)), atol=0)
    v = rng.standard_normal((7, 4, 6)).astype(np.float32)
    g = rng.standard_normal((6,)).astype(np.float32)
    for axes in ((0, 1), (0, 2)):
        gg = g if axes == (0, 1) else g[:4]
        ref = np.asarray(jconv.weight_norm_kernel(jnp.asarray(v), jnp.asarray(gg), axes))
        got = tconv.weight_norm_kernel(torch.from_numpy(v), torch.from_numpy(gg), axes).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    assert tconv.torch_same_padding(11, 5) == jconv.torch_same_padding(11, 5) == 25


@pytest.mark.parametrize("n,t,c,k,s,p", [(2, 64, 8, 31, 1, 15), (3, 65, 1, 4, 2, 2),
                                         (2, 40, 5, 4, 2, 2)])
@pytest.mark.parametrize("channels_first", [False, True])
def test_avg_pool1d_matches_jax_and_torch(n, t, c, k, s, p, channels_first):
    """The port's pool (a window view and a sum) against the JAX pool
    (forward) and torch's F.avg_pool1d (forward and input gradient), on a
    contiguous (N, W, C) input and on one with channels-first memory."""
    rng = np.random.default_rng(t + c)
    x = rng.standard_normal((n, t, c)).astype(np.float32)
    xt = torch.from_numpy(x)
    if channels_first:
        xt = xt.transpose(1, 2).contiguous().transpose(1, 2)
    xt.requires_grad_()
    got = tconv.avg_pool1d(xt, k, s, padding=p)
    want = np.asarray(jconv.avg_pool1d(jnp.asarray(x), k, s, padding=p))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-6)
    xr = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    ref = torch.nn.functional.avg_pool1d(xr, k, s, p).transpose(1, 2)
    dy = torch.from_numpy(rng.standard_normal(ref.shape).astype(np.float32))
    (g,) = torch.autograd.grad(got, xt, dy)
    (gr,) = torch.autograd.grad(ref, xr, dy)
    np.testing.assert_allclose(g.numpy(), gr.transpose(1, 2).numpy(), atol=1e-6, rtol=1e-6)
