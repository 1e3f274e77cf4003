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
# cos and sin of 2 pi m / p, m = 1 .. (p - 1) / 2, rounded to fp32 (LOGMEL_ROT7, 11, 13)
ROT = {p: tuple([np.float32(f(2 * np.pi * m / p)) for m in range(1, (p - 1) // 2 + 1)]
                for f in (np.cos, np.sin)) for p in (7, 11, 13)}


def _butterfly_prime(v):
    """The kernel's 7-, 11- and 13-point DFTs: pairs r, p - r summed (t) and
    differenced (u), X_k = v_0 + sum t cos - i sum u sin, X_{p-k} with + i."""
    p = len(v)
    h = (p - 1) // 2
    cos, sin = ROT[p]
    t = [v[r] + v[p - r] for r in range(1, h + 1)]
    u = [v[r] - v[p - r] for r in range(1, h + 1)]
    out = [None] * p
    out[0] = v[0]
    for tr in t:
        out[0] = out[0] + tr
    for k in range(1, h + 1):
        c, sn = v[0], np.complex64(0)
        for r in range(1, h + 1):
            m = r * k % p
            mm = m if m <= h else p - m
            c = c + cos[mm - 1] * t[r - 1]
            sn = sn + (sin[mm - 1] if m <= h else -sin[mm - 1]) * u[r - 1]
        out[k], out[p - k] = c - 1j * sn, c + 1j * sn
    return out


def _butterfly(v):
    """The kernel's 2-, 3-, 4- and 5-point DFTs with constant rotations, and
    its 7-, 11- and 13-point ones."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 3:
        t1, t2 = v[1] + v[2], -1j * (v[1] - v[2]) * C3
        m = v[0] - t1 * np.float32(0.5)
        return [v[0] + t1, m + t2, m - t2]
    if len(v) == 4:
        a, b, c, d = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        return [a + c, b - 1j * d, a - c, b + 1j * d]
    if len(v) > 5:
        return _butterfly_prime(v)
    t1, t2 = v[1] + v[4], v[2] + v[3]
    t3, t4 = -1j * (v[1] - v[4]), -1j * (v[2] - v[3])
    a1, a2 = v[0] + C5[0] * t1 + C5[1] * t2, v[0] + C5[1] * t1 + C5[0] * t2
    b1, b2 = S5[0] * t3 + S5[1] * t4, S5[1] * t3 - S5[0] * t4
    return [v[0] + (t1 + t2), a1 + b1, a2 + b2, a2 - b2, a1 - b1]


def _stockham(src: np.ndarray, tw: np.ndarray, passes: list) -> np.ndarray:
    """The kernel's Stockham passes over the last axis (butterfly j reads j +
    r n/R, twiddles by the table's entry r (j % ns) n/(ns R), writes (j //
    ns) ns R + j % ns + r ns)."""
    n = src.shape[-1]
    ns = 1
    for radix in passes:
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
    return src


def _complex(table: np.ndarray) -> np.ndarray:
    return (table[:, 0] + 1j * table[:, 1]).astype(np.complex64)


def _emulate_fft_body(y: np.ndarray, cfg) -> np.ndarray:
    """The kernel's FFT body in numpy complex64 on the route and frames a
    block of ``plan``: each block's tile staged with zeros past the
    signal's end, frames 2q and 2q+1 windowed into one complex sequence, the
    mixed-radix Stockham passes of ``fft_passes`` (Bluestein: the sequence
    times the chirp, zero-padded to the plan's length, the passes, the
    product with the filter conjugated, the passes again, X[k] = c[k]
    conj(R[k])), the real split into both frames' power (Z[(n - k) mod n]),
    the sparse filterbank, the log clamp. Returns (B, mels, F)."""
    route, length, block_frames = tlogmel.plan(cfg)
    assert route in ("fft", "bluestein") and block_frames in (8, 4, 2)
    tab = tlogmel.fft_tables(cfg)
    tw = _complex(tab.twiddle)
    passes = tlogmel.fft_passes(length)
    yp, frames = tlogmel._pad_crop(torch.from_numpy(y), cfg)
    n, hop = cfg.n_fft, cfg.hop_size
    padded = -(-frames // block_frames) * block_frames  # frames of whole blocks
    sig = np.zeros((y.shape[0], (padded - 1) * hop + n), dtype=np.float32)
    sig[:, :yp.shape[1]] = yp.numpy()
    fr = np.stack([sig[:, f * hop:f * hop + n] for f in range(padded)], axis=1) * tab.window
    src = (fr[:, 0::2] + 1j * fr[:, 1::2]).astype(np.complex64)
    if route == "bluestein":
        chirp, filt = _complex(tab.chirp), _complex(tab.filter)
        a = np.zeros(src.shape[:-1] + (length,), dtype=np.complex64)
        a[..., :n] = src * chirp
        r = _stockham(np.conj(_stockham(a, tw, passes) * filt), tw, passes)
        src = chirp * np.conj(r[..., :n])
    else:
        assert length == n
        src = _stockham(src, tw, passes)
    k = np.arange(n // 2 + 1)
    zk, zn = src[..., k], src[..., (n - k) % n]
    pa = 0.25 * ((zk.real + zn.real) ** 2 + (zk.imag - zn.imag) ** 2)
    pb = 0.25 * ((zk.real - zn.real) ** 2 + (zk.imag + zn.imag) ** 2)
    power = np.stack([pa, pb], axis=2).reshape(y.shape[0], -1, n // 2 + 1)[:, :frames]
    mel = np.stack([power[..., k0:k0 + cnt] @ tab.mel_vals[off:off + cnt]
                    for k0, cnt, off in tab.mel_idx.T], axis=1)
    return np.log(np.maximum(mel, tlogmel.LOG_CLIP)).astype(np.float32)


def _geometry(n_fft: int) -> dict:
    return dict(n_fft=n_fft, win_size=n_fft, hop_size=n_fft // 4)


@pytest.mark.parametrize("n_fft", [1024, 1200, 1100, 1764, 1028])
def test_fft_body_emulation_matches_the_pallas_kernel_in_interpret_mode(n_fft):
    """The FFT body's arithmetic against the JAX kernel (interpret mode) at
    the V1 geometry, n_fft 1200 / hop 300 (radix 5, 5, 3, 4, 4), 1100 / 275
    (radix 11, 5, 5, 4), 1764 / 441 (radix 7, 7, 3, 3, 4) and 1028 / 257
    (Bluestein at 2160), within that test's 2e-4 + 1e-4 |ref|."""
    y = _wave(1, 2 * n_fft + 113, 4)
    want = np.asarray(jax_fused_log_mel(
        jnp.asarray(y), dataclasses.replace(JAX_MATMUL, **_geometry(n_fft)), interpret=True))
    got = _emulate_fft_body(y, tmel.MelConfig(**_geometry(n_fft)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# n_fft: (route, transform length, frames a block, passes of that length)
PLANS = {
    512: ("fft", 512, 8, [2, 4, 4, 4, 4]), 1024: ("fft", 1024, 8, [4] * 5),
    2048: ("fft", 2048, 4, [2] + [4] * 5), 1200: ("fft", 1200, 8, [5, 5, 3, 4, 4]),
    960: ("fft", 960, 8, [5, 3, 4, 4, 4]), 800: ("fft", 800, 8, [5, 5, 2, 4, 4]),
    1536: ("fft", 1536, 8, [3, 2, 4, 4, 4, 4]), 1100: ("fft", 1100, 8, [11, 5, 5, 4]),
    1764: ("fft", 1764, 4, [7, 7, 3, 3, 4]), 1716: ("fft", 1716, 4, [13, 11, 3, 4]),
    1028: ("bluestein", 2160, 4, [5, 3, 3, 3, 4, 4]),
    3200: ("fft", 3200, 2, [5, 5, 2, 4, 4, 4]), 4096: ("fft", 4096, 2, [4] * 6),
}


@pytest.mark.parametrize("n_fft", list(PLANS))
def test_fft_body_emulation_matches_rfft(n_fft):
    """Each pass plan (radix 2 then 4; radix 4 only; radix 5 and 3 first;
    radix 13, 11 and 7; Bluestein; 4 and 2 frames a block), an odd frame count:
    the emulated log-mel against rfft's power through the dense filterbank,
    within 2e-4 + 1e-4 |ref|."""
    cfg = tmel.MelConfig(**_geometry(n_fft))
    route, length, frames, passes = PLANS[n_fft]
    assert tlogmel.plan(cfg) == (route, length, frames)
    assert tlogmel.fft_passes(length) == passes
    y = _wave(2, 7 * n_fft // 4 + 37, n_fft)
    yp, frames = tlogmel._pad_crop(torch.from_numpy(y), cfg)
    assert frames % 2 == 1
    spec = torch.fft.rfft(yp.unfold(-1, n_fft, n_fft // 4).double()
                          * torch.from_numpy(hann_window(n_fft, np.float64)), dim=-1)
    fb = torch.from_numpy(tlogmel._tables(cfg)[1]).double()
    want = torch.log(torch.clamp(spec.abs() ** 2 @ fb, min=tlogmel.LOG_CLIP)).transpose(1, 2)
    np.testing.assert_allclose(_emulate_fft_body(y, cfg), want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("radix", [2, 3, 4, 5, 7, 11, 13])
def test_butterflies_are_the_dft(radix):
    """Each butterfly with its constant rotations is the radix-point DFT."""
    v = np.random.default_rng(radix).standard_normal((2, radix, 6)).astype(np.float32)
    z = (v[0] + 1j * v[1]).astype(np.complex64)
    got = np.stack(_butterfly(list(z)))
    np.testing.assert_allclose(got, np.fft.fft(z, axis=0), atol=1e-5, rtol=0)


def test_fft_plan_and_shared_memory():
    """The pass plan of n_fft = 2^a 3^b 5^c 7^d 11^e 13^f (none for a prime
    factor above 13), Bluestein's length, and the body's shared memory in
    bytes: the signal tile and two buffers of frames / 2 complex sequences
    (90,000 at n_fft 1200 and 8 frames, two blocks an SM). The frames a
    block: the most that let two blocks share an SM (1764 and 1028 at 4,
    3200 and 4096 at 2), else the most that fit one block (5,600 at 4)."""
    assert tlogmel.fft_passes(1100) == [11, 5, 5, 4] and tlogmel.fft_passes(7 * 64) == [7, 4, 4, 4]
    assert tlogmel.fft_passes(17 * 64) is None and tlogmel.fft_passes(7 * 64, primes=False) is None
    assert tlogmel.fft_passes(1) is None and tlogmel.fft_passes(4) == [4]
    assert tlogmel.bluestein_length(1028) == 2160 and tlogmel.bluestein_length(257) == 540
    cfg = tmel.MelConfig(**_geometry(1200))
    assert tlogmel.fft_smem_bytes(cfg, 8, 1200) == 4 * (7 * 300 + 1200) + 2 * 4 * 1200 * 8 == 90000
    assert 90000 <= tlogmel.SMEM_TWO_BLOCKS == 115712 and tlogmel.plan(cfg).frames == 8
    for n_fft, frames in ((1764, 4), (3200, 2), (4096, 2)):
        big = tmel.MelConfig(**_geometry(n_fft))
        assert tlogmel.fft_smem_bytes(big, 2 * frames, n_fft) > tlogmel.SMEM_TWO_BLOCKS
        assert tlogmel.fft_smem_bytes(big, frames, n_fft) <= tlogmel.SMEM_TWO_BLOCKS
        assert tlogmel.plan(big) == ("fft", n_fft, frames)
    one_block = tmel.MelConfig(**_geometry(5600))  # 2^5 5^2 7: two blocks fit at no count
    assert tlogmel.fft_smem_bytes(one_block, 2, 5600) > tlogmel.SMEM_TWO_BLOCKS
    assert tlogmel.fft_smem_bytes(one_block, 4, 5600) <= tlogmel.SMEM_LIMIT
    assert tlogmel.plan(one_block) == ("fft", 5600, 4)
    blue = tmel.MelConfig(**_geometry(1028))
    assert tlogmel.fft_smem_bytes(blue, 4, 2160) == 4 * (3 * 257 + 1028 + 1 + 2 * 2 * 2160 * 2)
    assert tlogmel.fft_smem_bytes(blue, 8, 2160) > tlogmel.SMEM_TWO_BLOCKS
    assert tlogmel.plan(blue) == ("bluestein", 2160, 4)


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
    """Every admitted geometry whose buffers fit shared memory at 2 frames a
    block takes an FFT: n_fft = 2^a 3^b 5^c 7^d 11^e 13^f the "fft" route
    (1024, 2048, 1200, 1100 = 2^2 5^2 11, 4096, 11000), any other
    n_fft the "bluestein" route (1028 = 2^2 257, 6248 = 2^3 11 71 at 2
    frames); beyond the budget the "dense" route, for a pass plan (12000,
    above 11,068) and for Bluestein (6404 = 2^2 1601, above 6,248)."""
    routes = {1024: "fft", 2048: "fft", 1200: "fft", 1100: "fft", 4096: "fft", 11000: "fft",
              1028: "bluestein", 6248: "bluestein", 12000: "dense", 6404: "dense"}
    for n_fft, route in routes.items():
        cfg = tmel.MelConfig(**_geometry(n_fft))
        assert tlogmel.supports_fused_log_mel(cfg) and tlogmel.plan(cfg).route == route, n_fft
    assert tlogmel.plan(tmel.MelConfig(**_geometry(11000))).frames == 2
    assert tlogmel.plan(tmel.MelConfig(**_geometry(6248))).frames == 2
    assert tlogmel.plan(tmel.MelConfig(**_geometry(12000))) == ("dense", 12000, 0)


_SHIM = r"""
#include "logmel_plan.cuh"
extern "C" {
int plan_passes(int n, int primes, int* radix) {
  logmel_plan::FftPlan p;
  if (!logmel_plan::fft_plan(n, &p, primes != 0)) return -1;
  for (int i = 0; i < p.passes; ++i) radix[i] = p.radix[i];
  return p.passes;
}
int bluestein_length(int n) { return logmel_plan::bluestein_length(n); }
long long smem_bytes(int hop, int n, int len, int frames) {
  return logmel_plan::smem_floats(hop, n, len, frames) * 4;
}
float rotation(int p, int row, int m) {
  static const float r7[2][3] = {LOGMEL_ROT7}, r11[2][5] = {LOGMEL_ROT11},
                     r13[2][6] = {LOGMEL_ROT13};
  return p == 7 ? r7[row][m - 1] : p == 11 ? r11[row][m - 1] : r13[row][m - 1];
}
}
"""


@pytest.fixture(scope="module")
def device_plan(tmp_path_factory):
    """``csrc/logmel_plan.cuh`` (the kernel entry's plan) compiled with the
    host's C++ compiler and loaded with ctypes."""
    import ctypes
    import shutil
    import subprocess

    from hifigan_tpu_torch.ops import _build

    d = tmp_path_factory.mktemp("logmel_plan")
    (d / "shim.cpp").write_text(_SHIM)
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to read the kernel's plan"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{_build.CSRC}",
                    str(d / "shim.cpp"), "-o", str(d / "libplan.so")], check=True)
    lib = ctypes.CDLL(str(d / "libplan.so"))
    lib.smem_bytes.restype = ctypes.c_longlong
    lib.rotation.restype = ctypes.c_float
    return lib


GEOMETRIES = sorted(set(PLANS) | {448, 1088, 2068, 4100, 5600, 6248, 6252, 6404, 11000, 11068,
                                  11072, 12000})


@pytest.mark.parametrize("n_fft", GEOMETRIES)
def test_host_and_device_plans_agree(device_plan, n_fft):
    """For every geometry of these tests, ``csrc/logmel_plan.cuh`` compiled
    on the host and ``ops/logmel.py`` give the same pass plans (with and
    without radix 7-13), Bluestein length and shared memory at 8, 4 and 2
    frames."""
    import ctypes

    cfg = tmel.MelConfig(**_geometry(n_fft))
    for n in (n_fft, tlogmel.bluestein_length(n_fft)):
        for primes in (True, False):
            radix = (ctypes.c_int * 16)()
            count = device_plan.plan_passes(n, int(primes), radix)
            want = tlogmel.fft_passes(n, primes=primes)
            assert (None if count < 0 else list(radix[:count])) == want, (n, primes)
    assert device_plan.bluestein_length(n_fft) == tlogmel.bluestein_length(n_fft)
    # the FFT's length with or without Bluestein (a dense geometry's too)
    length = n_fft if tlogmel.fft_passes(n_fft) else tlogmel.bluestein_length(n_fft)
    for frames in tlogmel.FRAME_CHOICES:
        assert device_plan.smem_bytes(cfg.hop_size, n_fft, length, frames) == \
            tlogmel.fft_smem_bytes(cfg, frames, length)


def test_rotation_tables_are_cos_and_sin(device_plan):
    """The radix-7, 11 and 13 butterflies' constants as the compiler reads
    them are cos and sin of 2 pi m / p rounded to fp32 (the emulation's)."""
    for p, (cos, sin) in ROT.items():
        for m in range(1, (p - 1) // 2 + 1):
            assert np.float32(device_plan.rotation(p, 0, m)) == cos[m - 1]
            assert np.float32(device_plan.rotation(p, 1, m)) == sin[m - 1]
