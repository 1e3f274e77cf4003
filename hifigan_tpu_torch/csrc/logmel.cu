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
// the FFT's operations.
//
// Two bodies, chosen on the host by n_fft (hifigan_tpu_torch/ops/logmel.py):
//
// FFT body (hifigan_logmel_fft; n_fft = 2^a 3^b 5^c whose buffers fit
// shared memory, every shipped config): one 256-thread block per
// (utterance, kFftFrames frames).
// - The tile's (kFftFrames - 1)*hop + n_fft samples are staged in shared
//   memory once. Frames 2q and 2q+1 are windowed on the load into the real
//   and imaginary parts of one complex sequence z = a + i b.
// - A complex n_fft-point FFT per pair, all pairs of the tile at once:
//   mixed-radix Stockham autosort passes over the host's plan (radix 5s,
//   then 3s, then a radix 2 when the power of two is odd, then radix 4s),
//   ping-ponging between two shared-memory buffers, one block barrier per
//   pass; each butterfly twiddles its inputs from a table exp(-2 pi i m /
//   n_fft) that the host computes in float64, then takes its 2-, 3-, 4- or
//   5-point DFT with constant rotations. The index arithmetic divides by
//   each pass's constants with conv_core.cuh's FastDiv.
// - The real split: A[k] = (Z[k] + conj Z[(n-k) mod n]) / 2 and B[k] =
//   (Z[k] - conj Z[(n-k) mod n]) / 2i give both frames' onesided spectra;
//   their power goes to the free buffer.
// - The filterbank is stored sparse: per mel its contiguous range of
//   nonzero bins (729 weights at V1 against the dense 513 x 80); one
//   (frame, mel) output a thread, frames on neighbouring lanes, then the
//   log clamp.
//
// Dense body (hifigan_logmel; any other geometry the gate admits: n_fft
// with a prime factor above 5, e.g. 1100, or buffers beyond shared memory):
// one 256-thread block per (utterance, tile of kTileF frames).
// - The tile's (kTileF - 1)*hop + n_fft contiguous samples are staged in
//   shared memory once; frames are read from there directly.
// - The DFT walks the bins in chunks of kChunk: the windowed basis rows
//   stream through shared memory kBK at a time (the re and im columns of
//   the chunk side by side), each thread holding 4 frames x 4 bins of re
//   and im in registers; the chunk's power goes to shared memory. Bins past
//   the last whole chunk are summed by warps with a shuffle reduction.
// - The mel product then reads the tile's power from shared memory, one
//   (frame, mel) output a thread at a time, and writes the (mels, F)
//   output with frames on neighbouring lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileF = 16;  // frames per block
constexpr int kChunk = 256;  // bins per DFT chunk: 64 threads x 4 bins
constexpr int kBK = 16;      // basis rows per shared-memory step
constexpr float kClip = 1e-5f;

// Shared memory: the signal tile, the basis step (re | im of a chunk), the power tile.
__host__ __device__ inline int sig_floats(int hop, int n_fft) { return (kTileF - 1) * hop + n_fft; }
constexpr int kBasisFloats = kBK * 2 * kChunk;

__global__ void __launch_bounds__(kThreads)
    logmel_kernel(const float* __restrict__ sig, const float* __restrict__ basis,
                  const float* __restrict__ fb, float* __restrict__ out, int F, int L, int hop,
                  int n_fft, int n_bins, int mels) {
  extern __shared__ __align__(16) float smem[];
  const int n_sig = sig_floats(hop, n_fft);
  float* sig_s = smem;
  float* basis_s = smem + ((n_sig + 3) & ~3);
  float* power_s = basis_s + kBasisFloats;  // [bin][kTileF]
  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * kTileF;
  const int nf = min(kTileF, F - f0);
  const int ncol = 2 * n_bins;

  // stage the tile's samples (zeros past the signal's end feed frames past F only)
  const float* row = sig + (long)b * L + (long)f0 * hop;
  const int avail = L - f0 * hop;
  for (int i = tid; i < n_sig; i += kThreads) sig_s[i] = i < avail ? row[i] : 0.f;

  // --- DFT over whole chunks: thread (ty, tx): frames ty*4 + i, bins tx*4 + j ---
  const int tx = tid % 64, ty = tid / 64;
  const int full = (n_bins / kChunk) * kChunk;
  for (int c0 = 0; c0 < full; c0 += kChunk) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;
    for (int n0 = 0; n0 < n_fft; n0 += kBK) {
      __syncthreads();  // the previous step's basis (and, first, the signal) is done with
      for (int e = tid; e < kBasisFloats; e += kThreads) {
        const int r = e / (2 * kChunk), cc = e % (2 * kChunk), n = n0 + r;
        const int col = cc < kChunk ? c0 + cc : n_bins + c0 + cc - kChunk;
        basis_s[e] = n < n_fft ? __ldg(basis + (long)n * ncol + col) : 0.f;
      }
      __syncthreads();
      const int steps = min(kBK, n_fft - n0);
      for (int r = 0; r < steps; ++r) {
        const float4 br = *reinterpret_cast<const float4*>(basis_s + r * 2 * kChunk + tx * 4);
        const float4 bi =
            *reinterpret_cast<const float4*>(basis_s + r * 2 * kChunk + kChunk + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = sig_s[(ty * 4 + i) * hop + n0 + r];
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
        power_s[(c0 + tx * 4 + j) * kTileF + ty * 4 + i] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
  }
  __syncthreads();

  // --- bins past the whole chunks: warp w sums frames w and w + 8 over lanes ---
  const int warp = tid / 32, lane = tid % 32;
  for (int k = full; k < n_bins; ++k) {
    for (int f = warp; f < kTileF; f += kThreads / 32) {
      float sr = 0.f, si = 0.f;
      for (int n = lane; n < n_fft; n += 32) {
        const float a = sig_s[f * hop + n];
        sr = fmaf(a, __ldg(basis + (long)n * ncol + k), sr);
        si = fmaf(a, __ldg(basis + (long)n * ncol + n_bins + k), si);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
        si += __shfl_xor_sync(0xffffffffu, si, o);
      }
      if (lane == 0) power_s[k * kTileF + f] = sr * sr + si * si;
    }
  }
  __syncthreads();

  // --- mel product and log: thread (mg, f), mels mg, mg + 16, ... ---
  const int f = tid % kTileF, mg = tid / kTileF;
  if (f < nf) {
    for (int m = mg; m < mels; m += kThreads / kTileF) {
      float acc = 0.f;
      for (int k = 0; k < n_bins; ++k) acc = fmaf(power_s[k * kTileF + f], __ldg(fb + (long)k * mels + m), acc);
      out[((long)b * mels + m) * F + f0 + f] = logf(fmaxf(acc, kClip));
    }
  }
}

// --- FFT body ---

constexpr int kFftFrames = 8;          // frames per block
constexpr int kFfts = kFftFrames / 2;  // complex FFTs per block: two frames each
constexpr int kMaxPasses = 16;

// The pass plan (ops/logmel.py::fft_passes): radix 5s, then 3s, then a
// radix 2 when the power of two is odd, then radix 4s.
struct FftPlan {
  int passes;
  int radix[kMaxPasses];
};

// False unless n = 2^a 3^b 5^c >= 2.
inline bool fft_plan(int n, FftPlan* p) {
  int m = n, c5 = 0, c3 = 0, a = 0;
  while (m > 1 && m % 5 == 0) m /= 5, ++c5;
  while (m > 1 && m % 3 == 0) m /= 3, ++c3;
  while (m > 1 && m % 2 == 0) m /= 2, ++a;
  if (n < 2 || m != 1 || c5 + c3 + a % 2 + a / 2 > kMaxPasses) return false;
  p->passes = 0;
  for (int i = 0; i < c5; ++i) p->radix[p->passes++] = 5;
  for (int i = 0; i < c3; ++i) p->radix[p->passes++] = 3;
  if (a % 2) p->radix[p->passes++] = 2;
  for (int i = 0; i < a / 2; ++i) p->radix[p->passes++] = 4;
  return true;
}

// Shared memory (floats): the signal tile, then the two ping-pong buffers
// of kFfts complex sequences (ops/logmel.py::fft_smem_bytes).
__host__ __device__ inline int fft_smem_floats(int hop, int n_fft) {
  return (((kFftFrames - 1) * hop + n_fft + 3) & ~3) + 2 * kFfts * n_fft * 2;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
// a + sb b + sc c
__device__ __forceinline__ float2 comb(float2 a, float2 b, float sb, float2 c, float sc) {
  return make_float2(a.x + sb * b.x + sc * c.x, a.y + sb * b.y + sc * c.y);
}
// -i a
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }

__global__ void __launch_bounds__(kThreads)
    logmel_fft_kernel(const float* __restrict__ sig, const float* __restrict__ window,
                      const float2* __restrict__ twiddle, const int* __restrict__ mel_idx,
                      const float* __restrict__ fb_vals, float* __restrict__ out, int F, int L,
                      int hop, int n_fft, FftPlan plan, int mels) {
  extern __shared__ __align__(16) float smem[];
  const int n_sig = (kFftFrames - 1) * hop + n_fft;
  float* sig_s = smem;
  float2* src = reinterpret_cast<float2*>(smem + ((n_sig + 3) & ~3));
  float2* dst = src + kFfts * n_fft;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * kFftFrames;
  const int nf = min(kFftFrames, F - f0);

  // stage the tile's samples (zeros past the signal's end feed frames past F only)
  const float* row = sig + (long)b * L + (long)f0 * hop;
  const int avail = L - f0 * hop;
  for (int i = tid; i < n_sig; i += kThreads) sig_s[i] = i < avail ? row[i] : 0.f;
  __syncthreads();

  // frames 2q and 2q+1, windowed, as the real and imaginary parts of FFT q
  const conv_core::FastDiv fn(n_fft);
  for (int e = tid; e < kFfts * n_fft; e += kThreads) {
    const int q = fn.div(e), n = e - q * n_fft;
    const float w = __ldg(window + n);
    src[e] = make_float2(sig_s[2 * q * hop + n] * w, sig_s[(2 * q + 1) * hop + n] * w);
  }
  __syncthreads();

  // Stockham autosort passes. Pass with radix R over sub-transforms of size
  // ns: butterfly j reads src[j + r * n/R] (r < R), twiddled by the table's
  // entry r (j % ns) n/(ns R) = exp(-2 pi i r (j % ns) / (ns R)), and writes
  // its R-point DFT to dst[(j / ns) * ns * R + j % ns + r * ns].
  constexpr float kS3 = 0.866025403784438647f;                            // sin(2 pi / 3)
  constexpr float kC51 = 0.309016994374947424f, kC52 = -0.809016994374947424f;  // cos(2 pi k / 5)
  constexpr float kS51 = 0.951056516295153572f, kS52 = 0.587785252292473129f;   // sin(2 pi k / 5)
  int ns = 1;
  for (int p = 0; p < plan.passes; ++p) {
    const int R = plan.radix[p];
    const int nr = n_fft / R;  // butterflies per FFT
    const int step = nr / ns;  // table step of r = 1: n / (ns R)
    const conv_core::FastDiv fnr(nr), fns(ns);
    for (int e = tid; e < kFfts * nr; e += kThreads) {
      const int q = fnr.div(e), j = e - q * nr;
      const int jd = fns.div(j), jm = j - jd * ns;
      const int tw = jm * step;
      const float2* s = src + q * n_fft + j;
      float2* d = dst + q * n_fft + jd * ns * R + jm;
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
      } else {  // R == 5
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
      }
    }
    __syncthreads();
    float2* t = src;
    src = dst;
    dst = t;
    ns *= R;
  }

  // real split and power of both frames into the free buffer: [frame][bin]
  const int n_bins = n_fft / 2 + 1;
  float* power_s = reinterpret_cast<float*>(dst);
  for (int e = tid; e < kFfts * n_bins; e += kThreads) {
    const int q = e / n_bins, k = e - q * n_bins;
    const float2 zk = src[q * n_fft + k], zn = src[q * n_fft + (k == 0 ? 0 : n_fft - k)];
    const float ar = zk.x + zn.x, ai = zk.y - zn.y, br = zk.x - zn.x, bi = zk.y + zn.y;
    power_s[2 * q * n_bins + k] = 0.25f * (ar * ar + ai * ai);
    power_s[(2 * q + 1) * n_bins + k] = 0.25f * (br * br + bi * bi);
  }
  __syncthreads();

  // sparse filterbank (per mel: first bin, count, offset of its weights) and log
  const int f = tid % kFftFrames, mg = tid / kFftFrames;
  if (f < nf) {
    for (int m = mg; m < mels; m += kThreads / kFftFrames) {
      const int k0 = __ldg(mel_idx + m), cnt = __ldg(mel_idx + mels + m),
                off = __ldg(mel_idx + 2 * mels + m);
      const float* p = power_s + f * n_bins + k0;
      float acc = 0.f;
      for (int i = 0; i < cnt; ++i) acc = fmaf(p[i], __ldg(fb_vals + off + i), acc);
      out[((long)b * mels + m) * F + f0 + f] = logf(fmaxf(acc, kClip));
    }
  }
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
  const size_t bytes =
      (size_t)(((sig_floats(hop, n_fft) + 3) & ~3) + kBasisFloats + n_bins * kTileF) * sizeof(float);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
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

// The FFT body. sig (batch, L) fp32 with L = (F - 1)*hop + n_fft; window
// (n_fft,); twiddle (n_fft,) complex exp(-2 pi i m / n_fft) as (re, im)
// pairs; mel_idx (3, mels) int32: each mel's first nonzero bin, count and
// offset into fb_vals; out (batch, mels, F). n_fft must be 2^a 3^b 5^c and
// smem the shared memory fft_smem_floats gives, in bytes (the host's
// ops/logmel.py::fft_smem_bytes); any other value is refused. Returns the
// cudaError_t of the launch.
int hifigan_logmel_fft(const float* sig, const float* window, const float* twiddle,
                       const int* mel_idx, const float* fb_vals, float* out, int batch, int F,
                       int L, int hop, int n_fft, int mels, int smem, void* stream) {
  FftPlan plan;
  if (batch < 1 || F < 1 || hop < 1 || mels < 1 || !fft_plan(n_fft, &plan) ||
      L < (F - 1) * hop + n_fft || batch > 65535 ||
      smem != fft_smem_floats(hop, n_fft) * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(logmel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + kFftFrames - 1) / kFftFrames, batch);
  logmel_fft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sig, window, reinterpret_cast<const float2*>(twiddle), mel_idx, fb_vals, out, F, L, hop,
      n_fft, plan, mels);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
