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
from hifigan_tpu_torch.audio.stft import hann_window
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


C3 = np.float32(0.866025403784438647)  # sin(2 pi / 3), the kernel's constant
C5 = [np.float32(v) for v in (0.309016994374947424, -0.809016994374947424)]  # cos(2 pi k / 5)
S5 = [np.float32(v) for v in (0.951056516295153572, 0.587785252292473129)]  # sin(2 pi k / 5)


def _butterfly(v):
    """The kernel's 2-, 3-, 4- and 5-point DFTs with constant rotations."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 3:
        t1, t2 = v[1] + v[2], -1j * (v[1] - v[2]) * C3
        m = v[0] - t1 * np.float32(0.5)
        return [v[0] + t1, m + t2, m - t2]
    if len(v) == 4:
        a, b, c, d = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        return [a + c, b - 1j * d, a - c, b + 1j * d]
    t1, t2 = v[1] + v[4], v[2] + v[3]
    t3, t4 = -1j * (v[1] - v[4]), -1j * (v[2] - v[3])
    a1, a2 = v[0] + C5[0] * t1 + C5[1] * t2, v[0] + C5[1] * t1 + C5[0] * t2
    b1, b2 = S5[0] * t3 + S5[1] * t4, S5[1] * t3 - S5[0] * t4
    return [v[0] + (t1 + t2), a1 + b1, a2 + b2, a2 - b2, a1 - b1]


def _emulate_fft_body(y: np.ndarray, cfg) -> np.ndarray:
    """The kernel's FFT body in numpy complex64: frames 2q and 2q+1
    windowed into one complex sequence, the mixed-radix Stockham passes of
    ``fft_passes`` (butterfly j reads j + r n/R, twiddles by the table's
    entry r (j % ns) n/(ns R), writes (j // ns) ns R + j % ns + r ns), the
    real split into both frames' power (Z[(n - k) mod n]), the sparse
    filterbank, the log clamp. Returns (B, mels, F)."""
    window, twiddle, idx, vals = tlogmel.fft_tables(cfg)
    tw = (twiddle[:, 0] + 1j * twiddle[:, 1]).astype(np.complex64)
    yp, frames = tlogmel._pad_crop(torch.from_numpy(y), cfg)
    n, hop = cfg.n_fft, cfg.hop_size
    fr = np.stack([yp.numpy()[:, f * hop:f * hop + n] for f in range(frames)], axis=1) * window
    if frames % 2:
        fr = np.concatenate([fr, np.zeros_like(fr[:, :1])], axis=1)
    src = (fr[:, 0::2] + 1j * fr[:, 1::2]).astype(np.complex64)
    ns = 1
    for radix in tlogmel.fft_passes(n):
        j = np.arange(n // radix)
        jm = j % ns
        r_step = (n // radix) // ns
        assert r_step * ns * radix == n  # the pass's table step is an integer
        v = [src[..., j + r * (n // radix)] * tw[r * jm * r_step] for r in range(radix)]
        assert all(int((r * jm * r_step).max()) < n for r in range(radix))
        out = _butterfly(v)
        dst = np.full_like(src, np.nan)
        for r in range(radix):
            dst[..., (j // ns) * ns * radix + jm + r * ns] = out[r]
        assert not np.isnan(dst).any()  # the pass writes every element once
        src, ns = dst, ns * radix
    assert ns == n
    k = np.arange(n // 2 + 1)
    zk, zn = src[..., k], src[..., (n - k) % n]
    pa = 0.25 * ((zk.real + zn.real) ** 2 + (zk.imag - zn.imag) ** 2)
    pb = 0.25 * ((zk.real - zn.real) ** 2 + (zk.imag + zn.imag) ** 2)
    power = np.stack([pa, pb], axis=2).reshape(y.shape[0], -1, n // 2 + 1)[:, :frames]
    mel = np.stack([power[..., k0:k0 + cnt] @ vals[off:off + cnt] for k0, cnt, off in idx.T],
                   axis=1)
    return np.log(np.maximum(mel, tlogmel.LOG_CLIP)).astype(np.float32)


@pytest.mark.parametrize("n_fft", [1024, 1200])
def test_fft_body_emulation_matches_the_pallas_kernel_in_interpret_mode(n_fft):
    """The FFT body's arithmetic against the JAX kernel (interpret mode) at
    the V1 geometry and at n_fft 1200 / hop 300 (radix 5, 5, 3, 4, 4),
    within that test's 2e-4 + 1e-4 |ref|."""
    geometry = dict(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4)
    y = _wave(1, 2 * n_fft + 113, 4)
    want = np.asarray(jax_fused_log_mel(jnp.asarray(y), dataclasses.replace(JAX_MATMUL, **geometry),
                                        interpret=True))
    got = _emulate_fft_body(y, tmel.MelConfig(**geometry))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


PASSES = {512: [2, 4, 4, 4, 4], 1024: [4] * 5, 2048: [2] + [4] * 5, 1200: [5, 5, 3, 4, 4],
          960: [5, 3, 4, 4, 4], 800: [5, 5, 2, 4, 4], 1536: [3, 2, 4, 4, 4, 4]}


@pytest.mark.parametrize("n_fft", list(PASSES))
def test_fft_body_emulation_matches_rfft(n_fft):
    """Each pass plan (radix 2 then 4; radix 4 only; radix 5 and 3 first),
    an odd frame count: the emulated log-mel against rfft's power through
    the dense filterbank, within 2e-4 + 1e-4 |ref|."""
    cfg = tmel.MelConfig(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4)
    assert tlogmel.uses_fft(cfg)
    assert tlogmel.fft_passes(n_fft) == PASSES[n_fft]
    y = _wave(2, 7 * n_fft // 4 + 37, n_fft)
    yp, frames = tlogmel._pad_crop(torch.from_numpy(y), cfg)
    assert frames % 2 == 1
    spec = torch.fft.rfft(yp.unfold(-1, n_fft, n_fft // 4).double()
                          * torch.from_numpy(hann_window(n_fft, np.float64)), dim=-1)
    fb = torch.from_numpy(tlogmel._tables(cfg)[1]).double()
    want = torch.log(torch.clamp(spec.abs() ** 2 @ fb, min=tlogmel.LOG_CLIP)).transpose(1, 2)
    np.testing.assert_allclose(_emulate_fft_body(y, cfg), want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("radix", [2, 3, 4, 5])
def test_butterflies_are_the_dft(radix):
    """Each butterfly with its constant rotations is the radix-point DFT."""
    v = np.random.default_rng(radix).standard_normal((2, radix, 6)).astype(np.float32)
    z = (v[0] + 1j * v[1]).astype(np.complex64)
    got = np.stack(_butterfly(list(z)))
    np.testing.assert_allclose(got, np.fft.fft(z, axis=0), atol=1e-5, rtol=0)


def test_fft_plan_and_shared_memory():
    """The pass plan of n_fft = 2^a 3^b 5^c and the body's shared memory in
    bytes: the signal tile and two buffers of 4 complex sequences (76.8 KB
    at n_fft 1200); no plan for another prime factor."""
    assert tlogmel.fft_passes(1100) is None and tlogmel.fft_passes(7 * 64) is None
    assert tlogmel.fft_passes(1) is None and tlogmel.fft_passes(4) == [4]
    cfg = tmel.MelConfig(n_fft=1200, win_size=1200, hop_size=300)
    assert tlogmel.fft_smem_bytes(cfg) == 4 * (7 * 300 + 1200) + 2 * 4 * 1200 * 8 == 90000
    big = tmel.MelConfig(n_fft=3200, win_size=3200, hop_size=800)  # 2^7 5^2: buffers too large
    assert tlogmel.fft_passes(3200) is not None and not tlogmel.uses_fft(big)
    assert tlogmel.fft_smem_bytes(big) > tlogmel.SMEM_LIMIT


@pytest.mark.parametrize("mel_scale,norm", [("htk", None), ("slaney", "slaney")])
def test_sparse_filterbank_rebuilds_the_dense_one(mel_scale, norm):
    """Each mel's contiguous range of nonzero bins, rebuilt dense, equals
    ``mel_filterbank`` (729 weights at the default HTK geometry)."""
    fb = tmel.mel_filterbank(22050, 1024, 80, 0, 8000, mel_scale, norm)
    idx, vals = tlogmel.sparse_filterbank(fb)
    assert idx.shape == (3, 80) and idx.dtype == np.int32 and vals.dtype == np.float32
    dense = np.zeros_like(fb)
    for m, (k0, cnt, off) in enumerate(idx.T):
        dense[k0:k0 + cnt, m] = vals[off:off + cnt]
    np.testing.assert_array_equal(dense, fb)
    assert vals.size == np.count_nonzero(fb)
    assert vals.size == {"htk": 729, "slaney": 727}[mel_scale]


def test_body_choice_follows_n_fft():
    """n_fft = 2^a 3^b 5^c whose buffers fit shared memory takes the FFT
    body (1024, 1200, 2048); any other geometry the gate admits keeps the
    dense one (1100 = 2^2 5^2 11; 4096, whose buffers do not fit)."""
    assert tlogmel.uses_fft(tmel.MelConfig())
    assert tlogmel.uses_fft(tmel.MelConfig(n_fft=2048, win_size=2048, hop_size=512))
    mixed = tmel.MelConfig(n_fft=1200, win_size=1200, hop_size=300)
    assert tlogmel.supports_fused_log_mel(mixed) and tlogmel.uses_fft(mixed)
    dense = tmel.MelConfig(n_fft=1100, win_size=1100, hop_size=275)
    assert tlogmel.supports_fused_log_mel(dense) and not tlogmel.uses_fft(dense)
    assert not tlogmel.uses_fft(tmel.MelConfig(n_fft=4096, win_size=4096, hop_size=1024))
