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
// With a folded upsampler (pre_w != null, Pallas body :332-343) the input is
// the previous stage's output (B, T_in, C_in) and the stage's x is first
// computed as lrelu(0.1) -> ConvTranspose1d(stride u) + bias, rounded to the
// storage type once (T = T_in * u). The TPU kernel does that as a blocked
// matmul chain tied to its lane width (stride 2 only); here it is split by
// output phase p: output row m*u + p is a dilation-1 conv of taps =
// ceil(k/u) taps over input rows m + off(p) + t, off(p) = (p + pad)/u -
// (taps - 1), with the host's phase-split taps (u, taps, C_in, C). Any
// stride works. Input rows outside [0, T_in) read as zero.
//
// What bounds it: arithmetic. A V1 request of 256 mel frames at B=1 does
// about 152 GFLOP of MRF work (18 convs per stage, 126 taps * C^2 per
// output sample) against a few tens of MB of activations and weights, far
// above the H100's ridge (~295 FLOP/byte in bf16, ~20 in fp32).
//
// Two bodies, chosen by the storage type (the wrapper passes it
// explicitly):
//
// fp32 -- the SIMT body (hifigan_mrf_stage). TF32 would break the 1e-4
// fp32 parity, so fp32 stays on CUDA cores:
// - Work item = (batch row, time tile). A block computes the tile plus the
//   stage halo (sum of one chain's conv radii, + 3 with the post conv) and
//   walks each resblock chain conv by conv, shrinking the computed rows by
//   each conv's radius, so no output depends on a row it did not compute.
// - Each conv is a tiled SIMT GEMM with fp32 FMA: out rows x out channels
//   in 64x64 (C >= 64) or 128x32 tiles, 4x4 per thread; the K loop stages
//   16 input channels of every tap's shifted rows (lrelu + sequence mask
//   applied on the load) and those channels' weights in shared memory.
// - Intermediates live in a per-block global scratch (two ping-pong
//   buffers plus an fp32 mean accumulator); blocks loop over work items.
// - A folded upsampler first computes the tile's whole window (tile plus
//   halo) of upsampled x into a third scratch buffer, phase by phase, with
//   the same SIMT GEMM over C_in; the chains then read x from there.
//
// bf16 -- the tensor-core body (hifigan_mrf_stage_tc), the served path:
// - Conv core: each conv is an implicit GEMM, M = output rows, N = C_out,
//   K = taps x C_in, on mma.sync.m16n8k16 (bf16 in, fp32 accumulators).
//   A 128-row x BN-column output tile (BN = 32, 64 or 128 by C, 8 warps
//   of 32 columns each) reads its A operand from a shared-memory window of
//   128 + (k-1)*d rows x C_in, lrelu(0.1) and the sequence mask already
//   applied, rows padded by 8 elements so ldmatrix is conflict-free; tap t
//   reads it at row offset t*d. The taps stream in (tap, 64 input
//   channels) chunks through a 3-stage cp.async ring, so copies overlap the
//   products; ldmatrix.trans feeds the (K, N) weight tiles. C_in is padded
//   to 16 with zeros (V2's C = 8 and 16); C must be a multiple of 8.
// - Epilogue as the SIMT one: bias, round, residual, round.
// - Schedule: one persistent cooperative launch runs the stage conv by
//   conv over the whole sequence. Phase j computes conv j of every
//   resblock at once (its output tiles spread over all co-resident blocks,
//   the widest kernels first), then a grid-wide barrier; activations
//   ping-pong through two (B, T, C) buffers per resblock in device memory
//   (1-4 MB at B=1, in the 50 MB L2). A last phase takes the fp32 mean over
//   resblocks (with the post conv, one more barrier and phase). No halo is
//   recomputed and every SM gets work at B=1. A tiled schedule that keeps a
//   time tile plus halo in shared memory (x read and y written once) was
//   measured slower at every V1 and V2 stage and batch on the H100 and is
//   not kept (PERF.md).
// - A folded upsampler adds one phase before conv 0: work items (output
//   phase, batch row, 128 input rows, column tile) run the conv core over
//   a C_in-wide window of lrelu'd input rows and store rows m*u + p of one
//   more (B, T, C) plane, which then stands for x (first conv's source and
//   the residual). Still one launch per stage.

#include <cooperative_groups.h>
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
  const void* x;       // (B, T, C) storage type, or (B, T_in, C_in) with pre_w
  const void* w;       // every conv's (K, C, C) taps, concatenated
  const void* bias;    // (n_conv, C)
  const int* desc;     // per conv: k, dilation, offset of its taps in w
  const void* post_w;  // (7, C) or null
  const void* post_b;  // (1,)
  void* y;             // (B, T, C) storage type, or (B, T) fp32 with post
  const void* pre_w;   // (u, taps, C_in, C) phase-split upsampler taps, or null
  const void* pre_b;   // (C,)
  void* scratch;       // grid x (2, or 3 with pre_w) x work x C storage type
  float* acc;          // grid x (tile + 2 * post_halo) x C fp32
  int batch, seq, C, n_rb, convs_per_rb, pair_size, tile, halo, post_halo;
  int n_tiles, a_floats;  // a_floats: shared floats before the weight tile
  int cin, stride, taps, pre_pad;  // the folded upsampler's (seq = T_in * stride)
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

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

// The folded upsampler over window rows [0, rows) (sequence rows g0 + r),
// phase by phase: row m*u + p = bias + sum_t lrelu(xin[m + off(p) + t]) @
// w[p][t], rounded; xin rows outside [0, seq_in) read as zero, window rows
// outside [0, seq) are stored as zero. Same tiling as conv_rows.
template <typename T, int BN>
__device__ void upsample_rows(const T* w, const T* bias, const T* xin, int seq_in, int cin,
                              int C, int u, int taps, int pad, T* dst, int g0, int rows, int seq,
                              float* As, float* Ws) {
  constexpr int TX = BN / 4;
  constexpr int TY = kThreads / TX;
  constexpr int BM = TY * kTM;
  const int span = BM + taps - 1;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  for (int p = 0; p < u; ++p) {
    const int off = (p + pad) / u - (taps - 1);
    const int m_lo = -floor_div(p - g0, u);  // ceil((g0 - p) / u)
    const int m_hi = floor_div(g0 + rows - 1 - p, u);
    const T* wp = w + (long)p * taps * cin * C;
    for (int m0 = m_lo; m0 <= m_hi; m0 += BM) {
      for (int n0 = 0; n0 < C; n0 += BN) {
        float acc[kTM][4];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

        for (int c0 = 0; c0 < cin; c0 += kBK) {
          for (int i = tid; i < span * kBK; i += kThreads) {
            const int row = i / kBK, kk = i % kBK;
            const int gi = m0 + off + row, ci = c0 + kk;
            float v = 0.f;
            if (gi >= 0 && gi < seq_in && ci < cin) v = lrelu<T>(to_f(xin[(long)gi * cin + ci]), 0.1f);
            As[row * kAStride + kk] = v;
          }
          for (int i = tid; i < taps * kBK * BN; i += kThreads) {
            const int col = i % BN, rest = i / BN;
            const int kk = rest % kBK, tap = rest / kBK;
            const int ci = c0 + kk, co = n0 + col;
            Ws[i] = (ci < cin && co < C) ? to_f(wp[((long)tap * cin + ci) * C + co]) : 0.f;
          }
          __syncthreads();
          for (int tap = 0; tap < taps; ++tap) {
            const float* Ab = As + (ty * kTM + tap) * kAStride;
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
          const int m = m0 + ty * kTM + i;
          if (m > m_hi) continue;
          const int g = m * u + p;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int co = n0 + tx * 4 + j;
            if (co >= C) continue;
            const float v = (g >= 0 && g < seq) ? rnd<T>(acc[i][j] + to_f(bias[co])) : 0.f;
            dst[(long)(g - g0) * C + co] = from_f<T>(v);
          }
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
  const bool pre = a.pre_w != nullptr;
  T* bufA = static_cast<T*>(a.scratch) + (long)blockIdx.x * (pre ? 3 : 2) * work * C;
  T* bufB = bufA + (long)work * C;
  T* bufU = bufB + (long)work * C;  // the upsampled window (pre only)
  float* accb = a.acc + (long)blockIdx.x * arows * C;
  const int n_items = a.batch * a.n_tiles;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / a.n_tiles;
    const int t0 = (item % a.n_tiles) * tile;
    const int g0 = t0 - H;  // sequence row of window row 0
    const T* xb = x + (long)b * seq * C;
    long x_off = g0;
    if (pre) {
      const int seq_in = seq / a.stride;
      upsample_rows<T, BN>(static_cast<const T*>(a.pre_w), static_cast<const T*>(a.pre_b),
                           x + (long)b * seq_in * a.cin, seq_in, a.cin, C, a.stride, a.taps,
                           a.pre_pad, bufU, g0, work, seq, As, Ws);
      __syncthreads();
      xb = bufU;
      x_off = 0;
    }

    for (int rb = 0; rb < a.n_rb; ++rb) {
      const int* dsc = a.desc + 3 * rb * a.convs_per_rb;
      int r_total = 0;
      for (int j = 0; j < a.convs_per_rb; ++j) r_total += (dsc[3 * j] - 1) * dsc[3 * j + 1] / 2;

      const T* h = xb;
      long h_off = x_off;
      const T* prev = xb;
      long prev_off = x_off;
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

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------
namespace {
namespace tc {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kBM = 128;    // output rows of a conv tile
constexpr int kStages = 3;  // cp.async ring of weight chunks
constexpr int kPad = 8;     // bf16 elements of padding per shared-memory row

struct Args {
  const bf16* x;       // (B, T, C)
  const bf16* w;       // every conv's (K, C, C) taps, concatenated
  const bf16* bias;    // (n_conv, C)
  const int* desc;     // per conv: k, dilation, offset of its taps in w
  const bf16* post_w;  // (7, C) or null
  const bf16* post_b;  // (1,)
  void* y;             // (B, T, C) bf16, or (B, T) fp32 with post
  bf16* scratch;       // (2 * n_rb + post + pre) planes of (B, T, C)
  int batch, seq, C, cpad, kc, n_rb, convs_per_rb, pair_size, max_ext;
  // the folded upsampler (pre_w != null): x above is then its output plane
  // `up`, and xin (B, T_in, cin) the stage's input
  const bf16* xin;
  const bf16* pre_w;   // (u, taps, cin, C) phase-split taps
  const bf16* pre_b;   // (C,)
  bf16* up;
  int cin, cpad_in, kc_in, stride, taps, pre_pad, seq_in;
};

template <int BN>
struct Tile {
  static constexpr int WARPS_N = BN / 32;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WM = kBM / WARPS_M;  // rows per warp
  static constexpr int MT = WM / 16;        // m16 tiles per warp
  static constexpr int WS = BN + kPad;      // weight chunk row stride
};

__host__ __device__ inline int align8(int v) { return (v + 7) & ~7; }

// Shared memory of the kernel; the host computes the same. The operand
// window (elements) holds 128 + max_ext rows of cpad, and with a folded
// upsampler also 128 + taps - 1 rows of cpad_in (cpad_in = 0: none).
__host__ __device__ inline int window_elems(int cpad, int max_ext, int cpad_in, int taps) {
  const int mrf = (kBM + max_ext) * (cpad + kPad);
  const int pre = cpad_in > 0 ? (kBM + taps - 1) * (cpad_in + kPad) : 0;
  return align8(mrf > pre ? mrf : pre);
}
__host__ __device__ inline int stage_smem(int bn, int cpad, int kc, int max_ext, int cpad_in,
                                          int kc_in, int taps) {
  const int k = kc_in > kc ? kc_in : kc;
  return window_elems(cpad, max_ext, cpad_in, taps) * 2 + kStages * k * (bn + kPad) * 2;
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float rnd(float v) { return bf(tobf(v)); }
__device__ __forceinline__ bf16 lrelu_b(bf16 v, float slope) {
  const float f = bf(v);
  return f >= 0.f ? v : tobf(f * slope);
}
__device__ __forceinline__ uint4 lrelu8(uint4 v, float slope) {
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = lrelu_b(e[i], slope);
  return v;
}

// Weight chunk q of a conv with (K, cin, C) taps (tap q / kchunks, input
// channels from (q % kchunks) * kc, output columns [n0, n0 + BN)) into a
// ring slot; channels past cin and columns past C read as zero.
template <int BN>
__device__ __forceinline__ void load_w_chunk(bf16* dst, const bf16* w, int q, int kchunks, int kc,
                                             int cin, int C, int n0) {
  constexpr int PR = BN / 8;  // 16-byte pieces per row
  const int tap = q / kchunks, ci0 = (q % kchunks) * kc;
  for (int e = threadIdx.x; e < kc * PR; e += kThreads) {
    const int row = e / PR, col = (e % PR) * 8;
    const int ci = ci0 + row, co = n0 + col;
    const bool ok = ci < cin && co < C;
    cp_async16(dst + row * Tile<BN>::WS + col, ok ? w + ((long)tap * cin + ci) * C + co : w, ok);
  }
}

// One kBM x BN output tile of a dilated conv into fp32 registers:
// acc[m][n] = sum_tap sum_ci A[a0 + m + tap*d][ci] * w[tap][ci][n0 + n],
// ci over cin (padded to cpad), n over C. A is bf16 in shared memory (row
// stride as, rows past a_rows - 1 clamped: they feed only output rows the
// caller discards). Ends with the block synchronised and the weight ring
// drained.
template <int BN>
__device__ void conv_core(float (&acc)[Tile<BN>::MT][4][4], const bf16* A, int as, int a0,
                          int a_rows, const bf16* w, int k, int d, int C, int cin, int cpad,
                          int kc, int n0, bf16* ring) {
  using T = Tile<BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / T::WARPS_N) * T::WM, wn0 = (warp % T::WARPS_N) * 32;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  const int kchunks = cpad / kc;
  const int nq = k * kchunks;
  const int slot = kc * T::WS;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nq) load_w_chunk<BN>(ring + s * slot, w, s, kchunks, kc, cin, C, n0);
    cp_async_commit();
  }
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q landed for all; chunk q - 1's slot is free
    const int nxt = q + kStages - 1;
    if (nxt < nq)
      load_w_chunk<BN>(ring + (nxt % kStages) * slot, w, nxt, kchunks, kc, cin, C, n0);
    cp_async_commit();
    const bf16* wc = ring + (q % kStages) * slot;
    const int tap = q / kchunks, ci0 = (q % kchunks) * kc;
    const bf16* arow[T::MT];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int row = min(a0 + wm0 + i * 16 + (lane & 15) + tap * d, a_rows - 1);
      arow[i] = A + row * as + ci0 + (lane >> 4) * 8;
    }
    const bf16* brow = wc + (lane & 15) * T::WS + wn0 + (lane >> 4) * 8;
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t af[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) ldsm_x4(af[i], arow[i] + kk);
      uint32_t bfr[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) ldsm_x4_t(bfr[np], brow + kk * T::WS + np * 16);
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2], bfr[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The fragment element (i, j, v) of a warp's tile: row and column within
// the kBM x BN output tile.
template <int BN>
__device__ __forceinline__ int frag_row(int i, int v) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / Tile<BN>::WARPS_N) * Tile<BN>::WM + i * 16 + (lane >> 2) + (v / 2) * 8;
}
template <int BN>
__device__ __forceinline__ int frag_col(int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % Tile<BN>::WARPS_N) * 32 + j * 8 + (lane & 3) * 2;
}

// lrelu(0.1)(src) of rows [g_start, g_start + rows), zero outside [0, seq)
// and past C, into the operand window A.
__device__ void stage_window(bf16* A, int as, const bf16* src, int g_start, int rows, int seq,
                             int C, int cpad) {
  const int pr = cpad / 8;
  for (int e = threadIdx.x; e < rows * pr; e += kThreads) {
    const int i = e / pr, c = (e % pr) * 8, g = g_start + i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < seq && c < C)
      v = lrelu8(*reinterpret_cast<const uint4*>(src + (long)g * C + c), 0.1f);
    *reinterpret_cast<uint4*>(A + i * as + c) = v;
  }
}

// conv_post (k7, C -> 1) + tanh of one output sample, by one warp: the
// lrelu(0.01) of the mean m (B's (T, C) plane) at rows [g - 3, g + 3],
// zero outside the sequence.
__device__ __forceinline__ float post_sample(const bf16* pw, float pb, int C, int lane,
                                             const bf16* m, int g, int seq) {
  float s = 0.f;
  for (int idx = lane; idx < 7 * C; idx += 32) {
    const int tap = idx / C, c = idx % C, gg = g + tap - 3;
    const float v = (gg >= 0 && gg < seq) ? bf(lrelu_b(m[(long)gg * C + c], 0.01f)) : 0.f;
    s = fmaf(v, bf(pw[idx]), s);
  }
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  return tanhf(s + pb);
}

// One cooperative launch, conv by conv over the whole sequence, a
// grid-wide barrier between phases. MINB blocks share an SM and hide each
// other's loads where shared memory allows it (kernel_for picks it by width).
template <int BN, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) mrf_stage_tc_kernel(Args a) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int as = a.cpad + kPad;
  const bool pre = a.pre_w != nullptr;
  bf16* A = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = A + window_elems(a.cpad, a.max_ext, pre ? a.cpad_in : 0, a.taps);
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, seq = a.seq;
  const long plane = (long)a.batch * seq * C;
  const int m_tiles = (seq + kBM - 1) / kBM, n_tiles = (C + BN - 1) / BN;
  const int per_rb = a.batch * m_tiles * n_tiles;

  // the folded upsampler: phase p of rows m*u + p, 128 input rows a tile
  if (pre) {
    const int as_in = a.cpad_in + kPad, rows = kBM + a.taps - 1;
    const int mt_in = (a.seq_in + kBM - 1) / kBM;
    const int per_phase = a.batch * mt_in * n_tiles;
    for (int item = blockIdx.x; item < a.stride * per_phase; item += gridDim.x) {
      const int p = item / per_phase;
      int rest = item % per_phase;
      const int n0 = (rest % n_tiles) * BN;
      rest /= n_tiles;
      const int m0 = (rest % mt_in) * kBM, b = rest / mt_in;
      const int off = (p + a.pre_pad) / a.stride - (a.taps - 1);
      stage_window(A, as_in, a.xin + (long)b * a.seq_in * a.cin, m0 + off, rows, a.seq_in, a.cin,
                   a.cpad_in);
      float acc[T::MT][4][4];
      conv_core<BN>(acc, A, as_in, 0, rows, a.pre_w + (long)p * a.taps * a.cin * C, a.taps, 1, C,
                    a.cin, a.cpad_in, a.kc_in, n0, ring);
      bf16* dst = a.up + (long)b * seq * C;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int co = n0 + frag_col<BN>(jj);
          if (co >= C) continue;
          const float b0 = bf(a.pre_b[co]), b1 = bf(a.pre_b[co + 1]);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int m = m0 + frag_row<BN>(i, 2 * h2);
            if (m >= a.seq_in) continue;
            *reinterpret_cast<__nv_bfloat162*>(dst + ((long)m * a.stride + p) * C + co) =
                __halves2bfloat162(tobf(acc[i][jj][2 * h2] + b0), tobf(acc[i][jj][2 * h2 + 1] + b1));
          }
        }
    }
    grid.sync();
  }

  // buffer codes: 0 = x, 1 and 2 = the resblock's two scratch planes
  int h_code = 0, prev_code = 0;
  for (int j = 0; j < a.convs_per_rb; ++j) {
    const bool first = j % a.pair_size == 0, last = j % a.pair_size == a.pair_size - 1;
    const int src_code = first ? h_code : prev_code;
    const int dst_code = src_code == 1 ? 2 : 1;
    for (int item = blockIdx.x; item < a.n_rb * per_rb; item += gridDim.x) {
      const int rb = a.n_rb - 1 - item / per_rb;  // the widest kernels first
      int rest = item % per_rb;
      const int n0 = (rest % n_tiles) * BN;
      rest /= n_tiles;
      const int m0 = (rest % m_tiles) * kBM, b = rest / m_tiles;
      const int* dsc = a.desc + 3 * (rb * a.convs_per_rb + j);
      const int k = dsc[0], d = dsc[1], r = (k - 1) * d / 2;
      const long boff = (long)b * seq * C;
      bf16* planes = a.scratch + 2L * rb * plane + boff;
      const bf16* src = src_code == 0 ? a.x + boff : planes + (src_code - 1) * plane;
      const bf16* res = h_code == 0 ? a.x + boff : planes + (h_code - 1) * plane;
      bf16* dst = planes + (dst_code - 1) * plane;
      const int rows = kBM + (k - 1) * d;
      stage_window(A, as, src, m0 - r, rows, seq, C, a.cpad);
      float acc[T::MT][4][4];
      conv_core<BN>(acc, A, as, 0, rows, a.w + dsc[2], k, d, C, C, a.cpad, a.kc, n0, ring);
      const bf16* bias = a.bias + (long)(rb * a.convs_per_rb + j) * C;
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int co = n0 + frag_col<BN>(jj);
          if (co >= C) continue;
          const float b0 = bf(bias[co]), b1 = bf(bias[co + 1]);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int o = m0 + frag_row<BN>(i, 2 * h2);
            if (o >= seq) continue;
            float v0 = rnd(acc[i][jj][2 * h2] + b0), v1 = rnd(acc[i][jj][2 * h2 + 1] + b1);
            if (last) {
              const __nv_bfloat162 rv =
                  *reinterpret_cast<const __nv_bfloat162*>(res + (long)o * C + co);
              v0 = rnd(bf(rv.x) + v0);
              v1 = rnd(bf(rv.y) + v1);
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + (long)o * C + co) =
                __halves2bfloat162(tobf(v0), tobf(v1));
          }
        }
    }
    prev_code = dst_code;
    if (last) h_code = dst_code;
    grid.sync();
  }

  // mean over resblocks, in fp32 and resblock order, rounded once
  const bool post = a.post_w != nullptr;
  bf16* mean = post ? a.scratch + 2L * a.n_rb * plane : static_cast<bf16*>(a.y);
  const float n_rb = static_cast<float>(a.n_rb);
  for (long e = 2L * (blockIdx.x * (long)kThreads + threadIdx.x); e < plane;
       e += 2L * gridDim.x * kThreads) {
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < a.n_rb; ++r) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          a.scratch + (2L * r + h_code - 1) * plane + e);
      s0 += bf(v.x);
      s1 += bf(v.y);
    }
    *reinterpret_cast<__nv_bfloat162*>(mean + e) = __halves2bfloat162(tobf(s0 / n_rb), tobf(s1 / n_rb));
  }
  if (!post) return;
  grid.sync();
  const float pb = bf(a.post_b[0]);
  float* y = static_cast<float*>(a.y);
  const int lane = threadIdx.x % 32;
  const long n_rows = (long)a.batch * seq;
  for (long row = blockIdx.x * (long)(kThreads / 32) + threadIdx.x / 32; row < n_rows;
       row += (long)gridDim.x * (kThreads / 32)) {
    const long b = row / seq;
    const int t = static_cast<int>(row % seq);
    const float v = post_sample(a.post_w, pb, C, lane, mean + b * seq * C, t, seq);
    if (lane == 0) y[row] = v;
  }
}

// The kernel for a tiling: at most 255 registers a thread where a block
// of the 128-column tile fills shared memory alone (cpad > 128), else the
// register cap that lets 2 (64- and 128-column tiles) or 4 (32) blocks
// share an SM. On the H100 the 2-block cap speeds up V1's C=128 stage at
// B=16 by about a quarter, and slows the C=256 one, which a block's shared
// memory keeps at one block per SM anyway.
const void* kernel_for(int bn, int cpad) {
  switch (bn) {
    case 32: return reinterpret_cast<const void*>(mrf_stage_tc_kernel<32, 4>);
    case 64: return reinterpret_cast<const void*>(mrf_stage_tc_kernel<64, 2>);
    case 128:
      return cpad > 128 ? reinterpret_cast<const void*>(mrf_stage_tc_kernel<128, 1>)
                        : reinterpret_cast<const void*>(mrf_stage_tc_kernel<128, 2>);
    default: return nullptr;
  }
}

}  // namespace tc
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

// The fp32 SIMT body. Returns the cudaError_t of the launch.
// With pre_w (the folded upsampler, phase-split taps) x is (B, seq / stride,
// cin); max_k and max_ext then cover its taps too.
int hifigan_mrf_stage(const void* x, const void* w, const void* bias,
                      const int* desc, const void* post_w, const void* post_b,
                      const void* pre_w, const void* pre_b, void* y,
                      void* scratch, float* acc, int batch, int seq, int C, int n_rb,
                      int convs_per_rb, int pair_size, int tile, int halo, int post_halo,
                      int max_k, int max_ext, int grid, int cin, int stride, int taps,
                      int pre_pad, void* stream) {
  if (pre_w != nullptr && (stride < 1 || seq % stride != 0 || taps < 1 || cin < 1 ||
                           taps > max_k || taps - 1 > max_ext))
    return static_cast<int>(cudaErrorInvalidValue);
  StageArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.desc = desc;
  a.post_w = post_w;
  a.post_b = post_b;
  a.pre_w = pre_w;
  a.pre_b = pre_b;
  a.cin = cin;
  a.stride = stride;
  a.taps = taps;
  a.pre_pad = pre_pad;
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
  return C >= 64 ? launch<float, 64>(a, grid, smem, s) : launch<float, 32>(a, grid, smem, s);
}

}  // extern "C"

extern "C" {

// The tensor-core body's tiling for a width C: output columns per tile
// (bn), the padded input width (cpad) and input channels per weight chunk
// (kc). C must be a multiple of 8.
static void tc_tiling(int C, int* bn, int* cpad, int* kc) {
  *bn = C <= 32 ? 32 : C <= 64 ? 64 : 128;
  *cpad = (C + 15) & ~15;
  *kc = *cpad % 64 == 0 ? 64 : *cpad % 32 == 0 ? 32 : 16;
}

// Shared memory (bytes) of the tensor-core body for width C, a widest conv
// extent (k-1)*d of max_ext rows and, with a folded upsampler (cin > 0), its
// input width and taps (ops/resblock_tail.py::tc_smem).
static int tc_stage_smem(int C, int max_ext, int cin, int taps) {
  int bn, cpad, kc, bn_in = 0, cpad_in = 0, kc_in = 0;
  tc_tiling(C, &bn, &cpad, &kc);
  if (cin > 0) tc_tiling(cin, &bn_in, &cpad_in, &kc_in);
  return tc::stage_smem(bn, cpad, kc, max_ext, cpad_in, kc_in, taps);
}

// Co-resident blocks per SM of the tensor-core kernel for width C at this
// shared memory.
int hifigan_mrf_tc_blocks_per_sm(int C, int smem, int* out) {
  int bn, cpad, kc;
  tc_tiling(C, &bn, &cpad, &kc);
  const void* fn = tc::kernel_for(bn, cpad);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, tc::kThreads, smem);
  return static_cast<int>(err);
}

// The bf16 tensor-core body, launched cooperatively: grid at most the
// co-resident blocks (else cudaErrorCooperativeLaunchTooLarge). smem must be
// tc_stage_smem's value; scratch holds (2 * n_rb + (post_w != null) +
// (pre_w != null)) planes of batch * seq * C bf16. With pre_w (the folded
// upsampler's phase-split taps) x is (batch, seq / stride, cin). Returns the
// cudaError_t of the launch.
int hifigan_mrf_stage_tc(const void* x, const void* w, const void* bias, const int* desc,
                         const void* post_w, const void* post_b, const void* pre_w,
                         const void* pre_b, void* y, void* scratch, int batch, int seq, int C,
                         int n_rb, int convs_per_rb, int pair_size, int max_ext, int grid,
                         int smem, int cin, int stride, int taps, int pre_pad, void* stream) {
  const bool pre = pre_w != nullptr;
  if (C < 8 || C % 8 != 0 || batch < 1 || seq < 1 || grid < 1 || n_rb < 1 ||
      convs_per_rb < 1 || pair_size < 1 || convs_per_rb % pair_size != 0 ||
      (pre && (cin < 8 || cin % 8 != 0 || stride < 1 || seq % stride != 0 || taps < 1)) ||
      smem != tc_stage_smem(C, max_ext, pre ? cin : 0, taps))
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Args a;
  a.x = static_cast<const tc::bf16*>(x);
  a.w = static_cast<const tc::bf16*>(w);
  a.bias = static_cast<const tc::bf16*>(bias);
  a.desc = desc;
  a.post_w = static_cast<const tc::bf16*>(post_w);
  a.post_b = static_cast<const tc::bf16*>(post_b);
  a.y = y;
  a.scratch = static_cast<tc::bf16*>(scratch);
  a.batch = batch;
  a.seq = seq;
  a.C = C;
  a.n_rb = n_rb;
  a.convs_per_rb = convs_per_rb;
  a.pair_size = pair_size;
  a.max_ext = max_ext;
  int bn;
  tc_tiling(C, &bn, &a.cpad, &a.kc);
  a.xin = nullptr;
  a.pre_w = static_cast<const tc::bf16*>(pre_w);
  a.pre_b = static_cast<const tc::bf16*>(pre_b);
  a.up = nullptr;
  a.cin = a.cpad_in = a.kc_in = a.seq_in = a.pre_pad = 0;
  a.stride = 1;
  a.taps = 0;
  if (pre) {
    // the upsampled x gets the plane after the resblocks' (and the mean's)
    int bn_in;
    a.up = a.scratch + (2L * n_rb + (post_w != nullptr ? 1 : 0)) * batch * seq * C;
    a.xin = a.x;
    a.x = a.up;
    a.cin = cin;
    tc_tiling(cin, &bn_in, &a.cpad_in, &a.kc_in);
    a.stride = stride;
    a.taps = taps;
    a.pre_pad = pre_pad;
    a.seq_in = seq / stride;
  }
  const void* fn = tc::kernel_for(bn, a.cpad);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(tc::kThreads), params,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
