// Fused log-mel spectrogram forward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces hifigan_tpu/ops/pallas/logmel.py::fused_log_mel (:135; the
// kernel _kernel :43, Pallas call :101). Driven from
// hifigan_tpu_torch/ops/logmel.py, which reflect-pads and crops the signal
// (XLA ops outside the Pallas call in JAX). Over the padded signal
// (B, (F - 1)*hop + n_fft) it computes, per frame f,
//
//   frame = sig[f*hop : f*hop + n_fft]
//   spec  = frame @ basis          basis (n_fft, 2*n_bins) = [cos | -sin] * Hann
//   power = re^2 + im^2            (n_bins,)
//   mel   = power @ fb             fb (n_bins, mels)
//   out[b, m, f] = log(max(mel[m], 1e-5))
//
// all in fp32 (no TF32: the JAX kernel runs its matmuls at HIGHEST, and
// the error near the log clip needs full fp32). No backward kernel: the
// wrapper's VJP recomputes through the plain matmul composition, as the JAX
// one does.
//
// What bounds it: nothing of the card's at this size. A 16 x 10 s batch at
// the V1 geometry (n_fft 1024, hop 256, 80 mels) needs ~0.41 GFLOP as an
// FFT a frame and ~18.5 MB of signal and output: a few microseconds of
// either. What costs is the algorithm: the DFT as a dense product does 73x
// the FFT's operations, so every geometry whose buffers fit shared memory
// takes an FFT.
//
// Three routes, chosen on the host (hifigan_tpu_torch/ops/logmel.py::plan),
// with the plan of logmel_plan.cuh:
//
// FFT body (hifigan_logmel_fft; n_fft = 2^a 3^b 5^c 7^d 11^e 13^f, route
// "fft", or any other n_fft through Bluestein, route "bluestein"): one
// 256-thread block per (utterance, kFrames frames), kFrames 8, 4 or 2 as the
// host picks from the buffers' size (the most that let two blocks share an
// SM, else the most that fit; one instance of the kernel each, so the V1
// geometry's loops are as short as with 8 fixed).
// - The tile's (kFrames - 1)*hop + n_fft samples are staged in shared memory
//   once. Frames 2q and 2q+1 are windowed on the load into the real and
//   imaginary parts of one complex sequence z = a + i b.
// - A complex n_fft-point FFT per pair, all pairs of the tile at once:
//   mixed-radix Stockham autosort passes over the plan (radix 13s, 11s, 7s,
//   5s, then 3s, then a radix 2 when the power of two is odd, then radix
//   4s), ping-ponging between two shared-memory buffers, one block barrier
//   per pass; each butterfly twiddles its inputs from a table exp(-2 pi i m
//   / length) that the host computes in float64, then takes its 2-, 3-, 4-
//   or 5-point DFT with constant rotations, or its 7-, 11- or 13-point DFT
//   directly (pairs r, p - r summed and differenced, then rotated by a
//   constant table of cos and sin 2 pi m / p). The index arithmetic divides
//   by each pass's constants with conv_core.cuh's FastDiv.
// - Bluestein (an n_fft with a prime factor above 13): X[k] = c[k] (a * b)[k]
//   with the chirp c[n] = exp(-i pi n^2 / n_fft), a[n] = z[n] c[n] and b =
//   conj c. The windowed sequence times c, zero-padded to M (the smallest
//   2^a 3^b 5^c >= 2 n_fft - 1), goes through the same passes at length M;
//   the product with the filter FFT(b) / M (host, float64, stored fp32) is
//   conjugated on the way, so the same forward passes invert it (conj
//   FFT(conj x) = M IFFT(x)); then X[k] = c[k] conj(R[k]). Chirp phases are
//   pi (n^2 mod 2 n_fft) / n_fft in float64.
// - The real split: A[k] = (Z[k] + conj Z[(n-k) mod n]) / 2 and B[k] =
//   (Z[k] - conj Z[(n-k) mod n]) / 2i give both frames' onesided spectra;
//   their power goes to the free buffer.
// - The filterbank is stored sparse: per mel its contiguous range of
//   nonzero bins (729 weights at V1 against the dense 513 x 80); one
//   (frame, mel) output a thread, frames on neighbouring lanes, then the
//   log clamp.
//
// Dense body (hifigan_logmel; route "dense": a geometry whose buffers
// overflow shared memory even at 2 frames a block): one 256-thread block per
// (utterance, tile of kTileF frames); its shared memory does not grow with
// n_fft.
// - The DFT walks the bins in chunks of kChunk: the windowed basis rows and
//   the tile's frames stream through shared memory kBK samples at a time
//   (the re and im columns of the chunk side by side), each thread holding
//   4 frames x 4 bins of re and im in registers; the chunk's power goes to
//   shared memory.
// - Each chunk's power is then summed into the tile's mel sums in shared
//   memory (one (frame, mel) a thread at a time), and after the last chunk
//   the log clamp writes the (mels, F) output with frames on neighbouring
//   lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_core.cuh"
#include "logmel_plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileF = 16;  // frames per block
constexpr int kChunk = 256;  // bins per DFT chunk: 64 threads x 4 bins
constexpr int kBK = 16;      // basis rows per shared-memory step
constexpr float kClip = 1e-5f;
static_assert(kThreads == kTileF * kBK, "the dense body stages one frame sample a thread");

// Shared memory (floats): the basis step (re | im of a chunk), the frames'
// step, the chunk's power, the tile's mel sums.
constexpr int kBasisFloats = kBK * 2 * kChunk;
inline int dense_smem_floats(int mels) {
  return kBasisFloats + kTileF * kBK + kChunk * kTileF + mels * kTileF;
}

__global__ void __launch_bounds__(kThreads)
    logmel_kernel(const float* __restrict__ sig, const float* __restrict__ basis,
                  const float* __restrict__ fb, float* __restrict__ out, int F, int L, int hop,
                  int n_fft, int n_bins, int mels) {
  extern __shared__ __align__(16) float smem[];
  float* basis_s = smem;
  float* frame_s = basis_s + kBasisFloats;  // [frame][kBK]
  float* power_s = frame_s + kTileF * kBK;  // [bin of the chunk][kTileF]
  float* mel_s = power_s + kChunk * kTileF;  // [mel][kTileF]
  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * kTileF;
  const int nf = min(kTileF, F - f0);
  const int ncol = 2 * n_bins;
  const float* row = sig + (long)b * L + (long)f0 * hop;

  // thread (mg, f) owns the mel sums of frame f and mels mg, mg + 16, ...
  const int f = tid % kTileF, mg = tid / kTileF;
  for (int m = mg; m < mels; m += kThreads / kTileF) mel_s[m * kTileF + f] = 0.f;

  // --- DFT by chunks: thread (ty, tx): frames ty*4 + i, bins c0 + tx*4 + j ---
  const int tx = tid % 64, ty = tid / 64;
  for (int c0 = 0; c0 < n_bins; c0 += kChunk) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;
    for (int n0 = 0; n0 < n_fft; n0 += kBK) {
      __syncthreads();  // the last step's basis and frames (and chunk's power) are done with
      for (int e = tid; e < kBasisFloats; e += kThreads) {
        const int r = e / (2 * kChunk), cc = e % (2 * kChunk), n = n0 + r;
        const int k = c0 + cc % kChunk;
        const int col = cc < kChunk ? k : n_bins + k;
        basis_s[e] = n < n_fft && k < n_bins ? __ldg(basis + (long)n * ncol + col) : 0.f;
      }
      {  // one sample a thread (zeros for frames past F)
        const int fr = tid / kBK, n = n0 + tid % kBK;
        frame_s[tid] = fr < nf && n < n_fft ? row[(long)fr * hop + n] : 0.f;
      }
      __syncthreads();
      const int steps = min(kBK, n_fft - n0);
      for (int r = 0; r < steps; ++r) {
        const float4 br = *reinterpret_cast<const float4*>(basis_s + r * 2 * kChunk + tx * 4);
        const float4 bi =
            *reinterpret_cast<const float4*>(basis_s + r * 2 * kChunk + kChunk + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = frame_s[(ty * 4 + i) * kBK + r];
          re[i][0] = fmaf(a, br.x, re[i][0]);
          re[i][1] = fmaf(a, br.y, re[i][1]);
          re[i][2] = fmaf(a, br.z, re[i][2]);
          re[i][3] = fmaf(a, br.w, re[i][3]);
          im[i][0] = fmaf(a, bi.x, im[i][0]);
          im[i][1] = fmaf(a, bi.y, im[i][1]);
          im[i][2] = fmaf(a, bi.z, im[i][2]);
          im[i][3] = fmaf(a, bi.w, im[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        power_s[(tx * 4 + j) * kTileF + ty * 4 + i] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    __syncthreads();

    // --- the chunk's share of the mel product ---
    const int nk = min(kChunk, n_bins - c0);
    for (int m = mg; m < mels; m += kThreads / kTileF) {
      float acc = 0.f;
      for (int k = 0; k < nk; ++k)
        acc = fmaf(power_s[k * kTileF + f], __ldg(fb + (long)(c0 + k) * mels + m), acc);
      mel_s[m * kTileF + f] += acc;
    }
  }

  // --- log clamp (each thread reads only the sums it wrote) ---
  if (f < nf)
    for (int m = mg; m < mels; m += kThreads / kTileF)
      out[((long)b * mels + m) * F + f0 + f] = logf(fmaxf(mel_s[m * kTileF + f], kClip));
}

// --- FFT body ---

using logmel_plan::FftPlan;

__constant__ float kRot7[2][3] = {LOGMEL_ROT7};
__constant__ float kRot11[2][5] = {LOGMEL_ROT11};
__constant__ float kRot13[2][6] = {LOGMEL_ROT13};

// cos (row 0) or sin (row 1) of 2 pi m / P, m = 1 .. (P - 1) / 2.
template <int P>
__device__ __forceinline__ float rot(int row, int m) {
  if constexpr (P == 7) return kRot7[row][m - 1];
  else if constexpr (P == 11) return kRot11[row][m - 1];
  else return kRot13[row][m - 1];
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
__device__ __forceinline__ float2 conj(float2 a) { return make_float2(a.x, -a.y); }
// a + sb b + sc c
__device__ __forceinline__ float2 comb(float2 a, float2 b, float sb, float2 c, float sc) {
  return make_float2(a.x + sb * b.x + sc * c.x, a.y + sb * b.y + sc * c.y);
}
// -i a
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }

// The P-point DFT (P = 7, 11, 13) of v_r = s[r nr] twiddled by the table's
// entry r tw, written to d[k ns]. With t_r = v_r + v_{P-r} and u_r = v_r -
// v_{P-r} (r = 1 .. H), X_k = v_0 + sum_r t_r cos(2 pi r k / P) - i sum_r u_r
// sin(2 pi r k / P), and X_{P-k} the same with + i. Every index and rotation
// is a constant once the loops unroll.
template <int P>
__device__ __forceinline__ void butterfly_prime(const float2* s, int nr,
                                                const float2* __restrict__ twiddle, int tw,
                                                float2* d, int ns) {
  constexpr int H = (P - 1) / 2;
  const float2 v0 = s[0];
  float2 t[H], u[H];
#pragma unroll
  for (int r = 1; r <= H; ++r) {
    const float2 a = cmul(s[r * nr], __ldg(twiddle + r * tw));
    const float2 c = cmul(s[(P - r) * nr], __ldg(twiddle + (P - r) * tw));
    t[r - 1] = cadd(a, c);
    u[r - 1] = csub(a, c);
  }
  float2 sum = v0;
#pragma unroll
  for (int r = 0; r < H; ++r) sum = cadd(sum, t[r]);
  d[0] = sum;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 c = v0, sn = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const int m = (r * k) % P, mm = m <= H ? m : P - m;  // cos and sin of 2 pi m / P from mm
      const float cs = rot<P>(0, mm), sg = m <= H ? rot<P>(1, mm) : -rot<P>(1, mm);
      c = make_float2(fmaf(cs, t[r - 1].x, c.x), fmaf(cs, t[r - 1].y, c.y));
      sn = make_float2(fmaf(sg, u[r - 1].x, sn.x), fmaf(sg, u[r - 1].y, sn.y));
    }
    d[k * ns] = make_float2(c.x + sn.y, c.y - sn.x);        // c - i sn
    d[(P - k) * ns] = make_float2(c.x - sn.y, c.y + sn.x);  // c + i sn
  }
}

// Stockham autosort passes over nseq sequences of `len` points in `src`,
// ping-ponging with `dst`; on return `src` holds the transforms and `dst`
// is free. The plan comes packed, radix p in bits 4p .. 4p + 3 of
// `radices` (a register, where an indexed array would go to local memory).
// Pass with radix R over sub-transforms of size ns: butterfly j
// reads src[j + r * len/R] (r < R), twiddled by the table's entry r (j % ns)
// len/(ns R) = exp(-2 pi i r (j % ns) / (ns R)), and writes its R-point DFT
// to dst[(j / ns) * ns * R + j % ns + r * ns]. kPrimes compiles the radix 7,
// 11 and 13 butterflies in.
template <bool kPrimes>
__device__ __forceinline__ void stockham(float2*& src, float2*& dst,
                                         const float2* __restrict__ twiddle, int len, int nseq,
                                         int passes, unsigned long long radices) {
  constexpr float kS3 = 0.866025403784438647f;                            // sin(2 pi / 3)
  constexpr float kC51 = 0.309016994374947424f, kC52 = -0.809016994374947424f;  // cos(2 pi k / 5)
  constexpr float kS51 = 0.951056516295153572f, kS52 = 0.587785252292473129f;   // sin(2 pi k / 5)
  int ns = 1;
  for (int p = 0; p < passes; ++p) {
    const int R = static_cast<int>((radices >> (4 * p)) & 15);
    const int nr = len / R;    // butterflies per sequence
    const int step = nr / ns;  // table step of r = 1: len / (ns R)
    const conv_core::FastDiv fnr(nr), fns(ns);
    for (int e = threadIdx.x; e < nseq * nr; e += kThreads) {
      const int q = fnr.div(e), j = e - q * nr;
      const int jd = fns.div(j), jm = j - jd * ns;
      const int tw = jm * step;
      const float2* s = src + q * len + j;
      float2* d = dst + q * len + jd * ns * R + jm;
      const float2 v0 = s[0];
      if (R == 2) {
        const float2 v1 = cmul(s[nr], __ldg(twiddle + tw));
        d[0] = cadd(v0, v1);
        d[ns] = csub(v0, v1);
      } else if (R == 3) {
        const float2 v1 = cmul(s[nr], __ldg(twiddle + tw));
        const float2 v2 = cmul(s[2 * nr], __ldg(twiddle + 2 * tw));
        const float2 t1 = cadd(v1, v2), t2 = cscale(mul_mi(csub(v1, v2)), kS3);
        const float2 m = csub(v0, cscale(t1, 0.5f));
        d[0] = cadd(v0, t1);
        d[ns] = cadd(m, t2);
        d[2 * ns] = csub(m, t2);
      } else if (R == 4) {
        const float2 v1 = cmul(s[nr], __ldg(twiddle + tw));
        const float2 v2 = cmul(s[2 * nr], __ldg(twiddle + 2 * tw));
        const float2 v3 = cmul(s[3 * nr], __ldg(twiddle + 3 * tw));
        const float2 a = cadd(v0, v2), bb = csub(v0, v2), c = cadd(v1, v3), dd = csub(v1, v3);
        d[0] = cadd(a, c);
        d[ns] = make_float2(bb.x + dd.y, bb.y - dd.x);  // b - i d
        d[2 * ns] = csub(a, c);
        d[3 * ns] = make_float2(bb.x - dd.y, bb.y + dd.x);  // b + i d
      } else if (R == 5) {
        const float2 v1 = cmul(s[nr], __ldg(twiddle + tw));
        const float2 v2 = cmul(s[2 * nr], __ldg(twiddle + 2 * tw));
        const float2 v3 = cmul(s[3 * nr], __ldg(twiddle + 3 * tw));
        const float2 v4 = cmul(s[4 * nr], __ldg(twiddle + 4 * tw));
        const float2 t1 = cadd(v1, v4), t2 = cadd(v2, v3);
        const float2 t3 = mul_mi(csub(v1, v4)), t4 = mul_mi(csub(v2, v3));
        const float2 zero = make_float2(0.f, 0.f);
        const float2 a1 = comb(v0, t1, kC51, t2, kC52), a2 = comb(v0, t1, kC52, t2, kC51);
        const float2 b1 = comb(zero, t3, kS51, t4, kS52), b2 = comb(zero, t3, kS52, t4, -kS51);
        d[0] = cadd(v0, cadd(t1, t2));
        d[ns] = cadd(a1, b1);
        d[2 * ns] = cadd(a2, b2);
        d[3 * ns] = csub(a2, b2);
        d[4 * ns] = csub(a1, b1);
      } else if constexpr (kPrimes) {
        if (R == 7) butterfly_prime<7>(s, nr, twiddle, tw, d, ns);
        else if (R == 11) butterfly_prime<11>(s, nr, twiddle, tw, d, ns);
        else butterfly_prime<13>(s, nr, twiddle, tw, d, ns);
      }
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
    ns *= R;
  }
}

// kFrames: frames per block (8, 4 or 2); kPrimes: the plan has radix 7, 11
// or 13 passes; kBluestein: the transform runs at Bluestein's length `len`
// (else len == n_fft).
template <int kFrames, bool kPrimes, bool kBluestein>
__global__ void __launch_bounds__(kThreads)
    logmel_fft_kernel(const float* __restrict__ sig, const float* __restrict__ window,
                      const float2* __restrict__ twiddle, const float2* __restrict__ chirp,
                      const float2* __restrict__ filter, const int* __restrict__ mel_idx,
                      const float* __restrict__ fb_vals, float* __restrict__ out, int F, int L,
                      int hop, int n_fft, int len, int passes, unsigned long long radices,
                      int mels) {
  extern __shared__ __align__(16) float smem[];
  const int n_sig = (kFrames - 1) * hop + n_fft;
  constexpr int nseq = kFrames / 2;  // complex sequences: two frames each
  float* sig_s = smem;
  float2* src = reinterpret_cast<float2*>(smem + ((n_sig + 3) & ~3));
  float2* dst = src + nseq * len;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, F - f0);

  // stage the tile's samples (zeros past the signal's end feed frames past F only)
  const float* row = sig + (long)b * L + (long)f0 * hop;
  const int avail = L - f0 * hop;
  for (int i = tid; i < n_sig; i += kThreads) sig_s[i] = i < avail ? row[i] : 0.f;
  __syncthreads();

  // frames 2q and 2q+1, windowed, as the real and imaginary parts of
  // sequence q (Bluestein: times the chirp, zero-padded to len)
  const conv_core::FastDiv flen(len);
  for (int e = tid; e < nseq * len; e += kThreads) {
    const int q = flen.div(e), n = e - q * len;
    float2 v = make_float2(0.f, 0.f);
    if (!kBluestein || n < n_fft) {
      const float w = __ldg(window + n);
      v = make_float2(sig_s[2 * q * hop + n] * w, sig_s[(2 * q + 1) * hop + n] * w);
      if (kBluestein) v = cmul(v, __ldg(chirp + n));
    }
    src[e] = v;
  }
  __syncthreads();

  stockham<kPrimes>(src, dst, twiddle, len, nseq, passes, radices);
  if (kBluestein) {
    // times the filter FFT(b) / len, conjugated: the forward passes then invert
    for (int e = tid; e < nseq * len; e += kThreads)
      src[e] = conj(cmul(src[e], __ldg(filter + (e - flen.div(e) * len))));
    __syncthreads();
    stockham<kPrimes>(src, dst, twiddle, len, nseq, passes, radices);
  }

  // real split and power of both frames into the free buffer: [frame][bin]
  const int n_bins = n_fft / 2 + 1;
  float* power_s = reinterpret_cast<float*>(dst);
  for (int e = tid; e < nseq * n_bins; e += kThreads) {
    const int q = e / n_bins, k = e - q * n_bins, kn = k == 0 ? 0 : n_fft - k;
    float2 zk = src[q * len + k], zn = src[q * len + kn];
    if (kBluestein) {  // X[k] = c[k] conj(R[k])
      zk = cmul(__ldg(chirp + k), conj(zk));
      zn = cmul(__ldg(chirp + kn), conj(zn));
    }
    const float ar = zk.x + zn.x, ai = zk.y - zn.y, br = zk.x - zn.x, bi = zk.y + zn.y;
    power_s[2 * q * n_bins + k] = 0.25f * (ar * ar + ai * ai);
    power_s[(2 * q + 1) * n_bins + k] = 0.25f * (br * br + bi * bi);
  }
  __syncthreads();

  // sparse filterbank (per mel: first bin, count, offset of its weights) and log
  const int f = tid % kFrames, mg = tid / kFrames;
  if (f < nf) {
    for (int m = mg; m < mels; m += kThreads / kFrames) {
      const int k0 = __ldg(mel_idx + m), cnt = __ldg(mel_idx + mels + m),
                off = __ldg(mel_idx + 2 * mels + m);
      const float* p = power_s + f * n_bins + k0;
      float acc = 0.f;
      for (int i = 0; i < cnt; ++i) acc = fmaf(p[i], __ldg(fb_vals + off + i), acc);
      out[((long)b * mels + m) * F + f0 + f] = logf(fmaxf(acc, kClip));
    }
  }
}

cudaError_t max_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

}  // namespace

extern "C" {

// The dense body. sig (batch, L) fp32 with L = (F - 1)*hop + n_fft, basis (n_fft, 2*n_bins),
// fb (n_bins, mels), out (batch, mels, F), all contiguous fp32. Returns the
// cudaError_t of the launch (invalid value for a geometry the kernel does
// not take or shared memory beyond the card's).
int hifigan_logmel(const float* sig, const float* basis, const float* fb, float* out, int batch,
                   int F, int L, int hop, int n_fft, int n_bins, int mels, void* stream) {
  if (batch < 1 || F < 1 || hop < 1 || n_fft < 1 || n_bins < 1 || mels < 1 ||
      L < (F - 1) * hop + n_fft || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (size_t)dense_smem_floats(mels) * sizeof(float);
  int max_optin = 0;
  cudaError_t err = max_smem_optin(&max_optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > (size_t)max_optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kTileF - 1) / kTileF, batch);
  logmel_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      sig, basis, fb, out, F, L, hop, n_fft, n_bins, mels);
  return static_cast<int>(cudaGetLastError());
}

// The FFT body, both routes. sig (batch, L) fp32 with L = (F - 1)*hop +
// n_fft; window (n_fft,); twiddle (len,) complex exp(-2 pi i m / len) as (re,
// im) pairs; for Bluestein (len != n_fft) chirp (n_fft,) complex exp(-i pi
// (n^2 mod 2 n_fft) / n_fft) and filter (len,) complex FFT(conj chirp, laid
// out circularly) / len, else both null; mel_idx (3, mels) int32: each mel's
// first nonzero bin, count and offset into fb_vals; out (batch, mels, F).
// len must be n_fft where n_fft has a pass plan (fft_plan) and Bluestein's
// length otherwise, frames 8, 4 or 2 (the host's ops/logmel.py::plan) and
// smem the smem_floats of these in bytes (ops/logmel.py::fft_smem_bytes);
// any other value is refused, as is shared memory beyond the card's.
// Returns the cudaError_t of the launch.
int hifigan_logmel_fft(const float* sig, const float* window, const float* twiddle,
                       const float* chirp, const float* filter, const int* mel_idx,
                       const float* fb_vals, float* out, int batch, int F, int L, int hop,
                       int n_fft, int len, int frames, int mels, int smem, void* stream) {
  FftPlan plan;
  const bool direct = logmel_plan::fft_plan(n_fft, &plan);
  const bool bluestein = !direct && n_fft >= 2 && chirp && filter &&
                         len == logmel_plan::bluestein_length(n_fft) &&
                         logmel_plan::fft_plan(len, &plan, false);
  if (batch < 1 || F < 1 || hop < 1 || mels < 1 || !(direct ? len == n_fft : bluestein) ||
      L < (F - 1) * hop + n_fft || batch > 65535 || (frames != 8 && frames != 4 && frames != 2) ||
      smem != logmel_plan::smem_floats(hop, n_fft, len, frames) * (long long)sizeof(float))
    return static_cast<int>(cudaErrorInvalidValue);
  int max_optin = 0;
  cudaError_t err = max_smem_optin(&max_optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_optin) return static_cast<int>(cudaErrorInvalidValue);
  bool primes = false;
  unsigned long long radices = 0;
  for (int p = 0; p < plan.passes; ++p) {
    primes = primes || plan.radix[p] > 5;
    radices |= static_cast<unsigned long long>(plan.radix[p]) << (4 * p);
  }
  using Kernel = decltype(&logmel_fft_kernel<8, false, false>);
  const auto pick = [frames](Kernel k8, Kernel k4, Kernel k2) {
    return frames == 8 ? k8 : frames == 4 ? k4 : k2;
  };
  const Kernel kernel =
      bluestein ? pick(logmel_fft_kernel<8, false, true>, logmel_fft_kernel<4, false, true>,
                       logmel_fft_kernel<2, false, true>)
      : primes  ? pick(logmel_fft_kernel<8, true, false>, logmel_fft_kernel<4, true, false>,
                       logmel_fft_kernel<2, true, false>)
                : pick(logmel_fft_kernel<8, false, false>, logmel_fft_kernel<4, false, false>,
                       logmel_fft_kernel<2, false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + frames - 1) / frames, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sig, window, reinterpret_cast<const float2*>(twiddle),
      reinterpret_cast<const float2*>(chirp), reinterpret_cast<const float2*>(filter), mel_idx,
      fb_vals, out, F, L, hop, n_fft, len, plan.passes, radices, mels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
