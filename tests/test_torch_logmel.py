"""The fused log-mel op (``fused_log_mel``) of the port against the JAX
package, on the CPU: its plain version and ``log_mel_spectrogram(method=
'pallas')`` against the JAX matmul path at the lengths of
``tests/test_pallas_logmel.py`` and one that is not a hop multiple, the
geometry gate, one small case against the Pallas kernel in interpret mode,
and the gradient of a sin-weighted sum against ``jax.grad``. The CUDA kernel
is held against the same plain version on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.audio.mel import MelConfig as JaxMelConfig
from hifigan_tpu.audio.mel import log_mel_spectrogram as jax_log_mel
from hifigan_tpu.ops.pallas.logmel import fused_log_mel as jax_fused_log_mel
from hifigan_tpu_torch.audio import mel as tmel
from hifigan_tpu_torch.ops import logmel as tlogmel

ATOL, RTOL = 2e-4, 1e-4  # tests/test_pallas_logmel.py:26
JAX_MATMUL = JaxMelConfig(method="matmul")


def _wave(batch, t, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, t)) * 0.3).clip(-1, 1).astype(np.float32)


def test_supports_gate():
    """The gate cases of tests/test_pallas_logmel.py:12-16."""
    assert tlogmel.supports_fused_log_mel(tmel.MelConfig())
    assert not tlogmel.supports_fused_log_mel(tmel.MelConfig(hop_size=200))
    assert not tlogmel.supports_fused_log_mel(tmel.MelConfig(power=1.0))
    with pytest.raises(ValueError, match="unsupported mel geometry"):
        tlogmel.fused_log_mel(torch.zeros(1, 4096), tmel.MelConfig(hop_size=200))


@pytest.mark.parametrize("t", [8192, 8192 + 256 * 5, 8192 + 113])
def test_fused_log_mel_matches_jax(t):
    y = _wave(2, t, t)
    want = np.asarray(jax.jit(lambda a: jax_log_mel(a, JAX_MATMUL))(y))
    got = tlogmel.fused_log_mel_reference(torch.from_numpy(y), tmel.MelConfig())
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    via_cfg = tmel.log_mel_spectrogram(torch.from_numpy(y), tmel.MelConfig(method="pallas"))
    np.testing.assert_allclose(via_cfg.numpy(), want, atol=ATOL, rtol=RTOL)


def test_method_pallas_keeps_the_geometry_gate():
    """An unsupported geometry under method='pallas' takes the rfft
    composition, as the JAX package's matmul fallback (same values)."""
    y = _wave(1, 4000, 3)
    cfg = tmel.MelConfig(hop_size=200, method="pallas")
    want = np.asarray(jax_log_mel(y, dataclasses.replace(JAX_MATMUL, hop_size=200)))
    got = tmel.log_mel_spectrogram(torch.from_numpy(y), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    one = tmel.log_mel_spectrogram(torch.from_numpy(y[0]), tmel.MelConfig(method="pallas"))
    assert one.shape == (80, 1 + (4000 + 768 - 1024) // 256)


def test_fused_log_mel_matches_the_pallas_kernel_in_interpret_mode():
    y = _wave(1, 2048 + 113, 4)
    want = np.asarray(jax_fused_log_mel(jnp.asarray(y), JAX_MATMUL, interpret=True))
    got = tlogmel.fused_log_mel(torch.from_numpy(y), tmel.MelConfig())
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_fused_log_mel_gradient_matches_jax():
    """The sin-weighted loss of tests/test_pallas_logmel.py:43-60."""
    y = (np.random.default_rng(2).standard_normal((1, 4096)) * 0.3).astype(np.float32)
    want = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jnp.sin(jax_log_mel(a, JAX_MATMUL)))))(y))
    yt = torch.tensor(y, requires_grad=True)
    (got,) = torch.autograd.grad(torch.sin(tlogmel.fused_log_mel(yt, tmel.MelConfig())).sum(), yt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_cuda_backward_recomputes_the_plain_composition():
    """The autograd Function's backward (the CUDA path's) pulls the
    cotangent through the plain composition, saving only y: on the CPU it
    equals autograd through the plain version."""
    y = torch.from_numpy(_wave(2, 3000, 5))
    g = torch.randn((2, 80, tlogmel.num_frames(3000, tmel.MelConfig())),
                    generator=torch.Generator().manual_seed(6))

    class Ctx:
        cfg = tmel.MelConfig()
        saved_tensors = (y,)

    (got, none) = tlogmel._FusedLogMel.backward(Ctx, g)
    yt = y.clone().requires_grad_()
    (want,) = torch.autograd.grad(tlogmel.fused_log_mel_reference(yt, tmel.MelConfig()), yt, g)
    assert none is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
