// Fused HiFi-GAN MRF stage for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces hifigan_tpu/ops/pallas/resblock_tail.py::fused_tail_stage (the
// Pallas kernel at :395, body :306-389). One launch computes one whole
// multi-receptive-field stage of the generator:
//
//   out = mean_j ResBlock_j(x),  ResBlock: h <- h + conv(lrelu0.1(...))
//
// ResBlock1 runs (dilated conv, unit conv) pairs, ResBlock2 single dilated
// convs. Every conv is 'same' with bias over (K, C, C) taps; its input is
// zeroed outside the true sequence [0, T) before every conv (the whole-
// sequence model's zero padding), its output is rounded to the storage type,
// and the mean over resblocks is taken in fp32. With a post conv the stage
// then applies lrelu(0.01) -> conv_post (k7, C -> 1) -> tanh and writes the
// waveform (B, T) in fp32.
//
// What bounds it: arithmetic. A V1 request of 256 mel frames at B=1 does
// about 152 GFLOP of MRF work (18 convs per stage, 126 taps * C^2 per
// output sample) against a few hundred MB of activations and weights, far
// above the H100's ~20 FLOP/byte fp32 ridge.
//
// Design (simple and correct first; wgmma/TMA are later work):
// - Work item = (batch row, time tile). A block computes the tile plus the
//   stage halo (sum of one chain's conv radii, + 3 with the post conv) and
//   walks each resblock chain conv by conv, shrinking the computed rows by
//   each conv's radius, so no output depends on a row it did not compute.
// - Each conv is a tiled SIMT GEMM with fp32 FMA: out rows x out channels
//   in 64x64 (C >= 64) or 128x32 tiles, 4x4 per thread; the K loop stages
//   16 input channels of every tap's shifted rows (lrelu + sequence mask
//   applied on the load) and those channels' weights of every tap in
//   shared memory. Weights stream from global/L2.
// - Intermediate activations live in a per-block scratch in global memory
//   (two ping-pong buffers of (tile + 2*halo) x C in the storage type, plus
//   an fp32 mean accumulator), not in shared memory. At stage 0 (C=256) a
//   64-row tile plus 2 x 60 halo rows is 188 KB per fp32 buffer: two such
//   buffers do not fit in 227 KB, and the GEMM staging needs room too. The
//   scratch of one block is a few hundred KB and stays in L2; blocks loop
//   over work items (persistent grid), so the scratch is sized by the grid,
//   not by the sequence.
// - bf16 and fp32 storage share one code path: loads convert to fp32,
//   each conv's output is rounded back to the storage type (the reference's
//   per-conv rounding), accumulation is fp32 throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;   // input channels per K step
constexpr int kTM = 4;    // output rows per thread
constexpr int kAStride = kBK + 1;  // padded row of the staged input tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round through the storage type
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <typename T> __device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : rnd<T>(v * slope);
}

struct StageArgs {
  const void* x;       // (B, T, C) storage type
  const void* w;       // every conv's (K, C, C) taps, concatenated
  const void* bias;    // (n_conv, C)
  const int* desc;     // per conv: k, dilation, offset of its taps in w
  const void* post_w;  // (7, C) or null
  const void* post_b;  // (1,)
  void* y;             // (B, T, C) storage type, or (B, T) fp32 with post
  void* scratch;       // grid x 2 x work x C storage type
  float* acc;          // grid x (tile + 2 * post_halo) x C fp32
  int batch, seq, C, n_rb, convs_per_rb, pair_size, tile, halo, post_halo;
  int n_tiles, a_floats;  // a_floats: shared floats before the weight tile
};

// One 'same' dilated conv over output rows [lo, hi) of the work window.
// Row r of the window is sequence row g0 + r; src/res element (r, c) lives
// at ptr[(r + off) * C + c]. Input rows outside [0, seq) read as zero.
// res (may alias dst, element for element) adds the residual.
template <typename T, int BN>
__device__ void conv_rows(const T* w, const T* bias, int k, int d, int C,
                          const T* src, long src_off, const T* res, long res_off, T* dst,
                          int lo, int hi, int g0, int seq, float* As, float* Ws) {
  constexpr int TX = BN / 4;
  constexpr int TY = kThreads / TX;
  constexpr int BM = TY * kTM;
  const int r = (k - 1) * d / 2;
  const int span = BM + (k - 1) * d;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  for (int m0 = lo; m0 < hi; m0 += BM) {
    for (int n0 = 0; n0 < C; n0 += BN) {
      float acc[kTM][4];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int c0 = 0; c0 < C; c0 += kBK) {
        for (int i = tid; i < span * kBK; i += kThreads) {
          const int row = i / kBK, kk = i % kBK;
          const int wr = m0 - r + row;
          const int g = g0 + wr, ci = c0 + kk;
          float v = 0.f;
          if (g >= 0 && g < seq && ci < C && wr < hi + r)
            v = lrelu<T>(to_f(src[(wr + src_off) * C + ci]), 0.1f);
          As[row * kAStride + kk] = v;
        }
        for (int i = tid; i < k * kBK * BN; i += kThreads) {
          const int col = i % BN, rest = i / BN;
          const int kk = rest % kBK, tap = rest / kBK;
          const int ci = c0 + kk, co = n0 + col;
          Ws[i] = (ci < C && co < C) ? to_f(w[((long)tap * C + ci) * C + co]) : 0.f;
        }
        __syncthreads();
        for (int tap = 0; tap < k; ++tap) {
          const float* Ab = As + (ty * kTM + tap * d) * kAStride;
          const float* Wb = Ws + tap * kBK * BN + tx * 4;
#pragma unroll
          for (int kk = 0; kk < kBK; ++kk) {
            const float4 bv = *reinterpret_cast<const float4*>(Wb + kk * BN);
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              const float av = Ab[i * kAStride + kk];
              acc[i][0] = fmaf(av, bv.x, acc[i][0]);
              acc[i][1] = fmaf(av, bv.y, acc[i][1]);
              acc[i][2] = fmaf(av, bv.z, acc[i][2]);
              acc[i][3] = fmaf(av, bv.w, acc[i][3]);
            }
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int o = m0 + ty * kTM + i;
        if (o >= hi) continue;
        const int g = g0 + o;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = n0 + tx * 4 + j;
          if (co >= C) continue;
          float v = rnd<T>(acc[i][j] + to_f(bias[co]));
          if (res != nullptr) {
            const float rv = (g >= 0 && g < seq) ? to_f(res[(o + res_off) * C + co]) : 0.f;
            v = rnd<T>(rv + v);
          }
          dst[(long)o * C + co] = from_f<T>(v);
        }
      }
    }
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads) mrf_stage_kernel(StageArgs a) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Ws = As + a.a_floats;

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.bias);
  const int C = a.C, seq = a.seq, H = a.halo, hp = a.post_halo, tile = a.tile;
  const int work = tile + 2 * H;
  const int arows = tile + 2 * hp;
  T* bufA = static_cast<T*>(a.scratch) + (long)blockIdx.x * 2 * work * C;
  T* bufB = bufA + (long)work * C;
  float* accb = a.acc + (long)blockIdx.x * arows * C;
  const int n_items = a.batch * a.n_tiles;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / a.n_tiles;
    const int t0 = (item % a.n_tiles) * tile;
    const int g0 = t0 - H;  // sequence row of window row 0
    const T* xb = x + (long)b * seq * C;

    for (int rb = 0; rb < a.n_rb; ++rb) {
      const int* dsc = a.desc + 3 * rb * a.convs_per_rb;
      int r_total = 0;
      for (int j = 0; j < a.convs_per_rb; ++j) r_total += (dsc[3 * j] - 1) * dsc[3 * j + 1] / 2;

      const T* h = xb;
      long h_off = g0;
      const T* prev = xb;
      long prev_off = g0;
      int r_done = 0;
      for (int j = 0; j < a.convs_per_rb; ++j) {
        const int k = dsc[3 * j], d = dsc[3 * j + 1];
        r_done += (k - 1) * d / 2;
        const int r_after = r_total - r_done;
        const int lo = H - hp - r_after;
        const int hi = H + tile + hp + r_after;
        const bool first = (j % a.pair_size) == 0;
        const bool last = (j % a.pair_size) == a.pair_size - 1;
        const T* src = first ? h : prev;
        const long src_off = first ? h_off : prev_off;
        T* dst = (src == bufA) ? bufB : bufA;
        conv_rows<T, BN>(w + dsc[3 * j + 2], bias + (long)(rb * a.convs_per_rb + j) * C, k, d,
                         C, src, src_off, last ? h : nullptr, h_off, dst, lo, hi, g0, seq,
                         As, Ws);
        __syncthreads();
        prev = dst;
        prev_off = 0;
        if (last) {
          h = dst;
          h_off = 0;
        }
      }
      for (int e = threadIdx.x; e < arows * C; e += kThreads) {
        const int row = e / C, c = e % C;
        const float v = to_f(h[(H - hp + row + h_off) * C + c]);
        accb[e] = rb == 0 ? v : accb[e] + v;
      }
      __syncthreads();
    }

    const float n_rb = static_cast<float>(a.n_rb);
    if (a.post_w == nullptr) {
      T* y = static_cast<T*>(a.y) + (long)b * seq * C;
      for (int e = threadIdx.x; e < tile * C; e += kThreads) {
        const int row = e / C, c = e % C;
        if (t0 + row < seq) y[(long)(t0 + row) * C + c] = from_f<T>(accb[e] / n_rb);
      }
    } else {
      // lrelu(0.01) of the rounded mean, masked, into bufA; then one warp
      // per output sample: k7 C -> 1 conv, bias, tanh
      for (int e = threadIdx.x; e < arows * C; e += kThreads) {
        const int g = t0 - hp + e / C;
        const float v = (g >= 0 && g < seq) ? lrelu<T>(rnd<T>(accb[e] / n_rb), 0.01f) : 0.f;
        bufA[e] = from_f<T>(v);
      }
      __syncthreads();
      const T* pw = static_cast<const T*>(a.post_w);
      const float pb = to_f(static_cast<const T*>(a.post_b)[0]);
      float* y = static_cast<float*>(a.y) + (long)b * seq;
      const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
      for (int row = warp; row < tile; row += kThreads / 32) {
        if (t0 + row >= seq) break;
        float s = 0.f;
        for (int idx = lane; idx < (2 * hp + 1) * C; idx += 32)
          s = fmaf(to_f(bufA[(long)row * C + idx]), to_f(pw[idx]), s);
        for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) y[t0 + row] = tanhf(s + pb);
      }
    }
    __syncthreads();
  }
}

template <typename T, int BN>
int launch(const StageArgs& a, int grid, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mrf_stage_kernel<T, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mrf_stage_kernel<T, BN><<<grid, kThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for a stage whose widest conv has
// max_k taps and a receptive extent (k-1)*d of max_ext rows.
int hifigan_mrf_stage_smem(int C, int max_k, int max_ext, int* a_floats_out) {
  const int bn = C >= 64 ? 64 : 32;
  const int bm = (kThreads / (bn / 4)) * kTM;
  const int a_floats = ((bm + max_ext) * kAStride + 3) / 4 * 4;
  *a_floats_out = a_floats;
  return (a_floats + max_k * kBK * bn) * static_cast<int>(sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int hifigan_mrf_stage(int dtype, const void* x, const void* w, const void* bias,
                      const int* desc, const void* post_w, const void* post_b, void* y,
                      void* scratch, float* acc, int batch, int seq, int C, int n_rb,
                      int convs_per_rb, int pair_size, int tile, int halo, int post_halo,
                      int max_k, int max_ext, int grid, void* stream) {
  StageArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.desc = desc;
  a.post_w = post_w;
  a.post_b = post_b;
  a.y = y;
  a.scratch = scratch;
  a.acc = acc;
  a.batch = batch;
  a.seq = seq;
  a.C = C;
  a.n_rb = n_rb;
  a.convs_per_rb = convs_per_rb;
  a.pair_size = pair_size;
  a.tile = tile;
  a.halo = halo;
  a.post_halo = post_halo;
  a.n_tiles = (seq + tile - 1) / tile;
  const int smem = hifigan_mrf_stage_smem(C, max_k, max_ext, &a.a_floats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = C >= 64;
  if (dtype == 0) return wide ? launch<float, 64>(a, grid, smem, s) : launch<float, 32>(a, grid, smem, s);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, 64>(a, grid, smem, s)
                : launch<__nv_bfloat16, 32>(a, grid, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
