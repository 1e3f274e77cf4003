// One conv1d + bias + leaky-ReLU layer, forward and input gradient, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces hifigan_tpu/ops/pallas/msd_conv.py::msd_conv1d_lrelu (:191): the
// tap-loop kernel _tapconv_kernel (:56, Pallas call :96) that computes the
// forward, and the same kernel reused on the masked cotangent for dx
// (:165). Driven from hifigan_tpu_torch/ops/msd_conv.py, one launch per
// call and pass:
//
//   forward  y[n,t,c]  = act(b[c] + sum_{k,i} x[n, t*s + k*d - pad, g*ci_g+i] * W[k,i,c])
//   dx       dx[n,u,i] = sum_{k,o: t*s + k*d - pad = u} dz[n,t,g*co_g+o] * W[k,i,g*co_g+o]
//
// with channels-last activations (N, T, C), weights (K, C_in/groups, C_out)
// (the JAX layout, read as a (K*C_in/groups, C_out) matrix), zero padding,
// g the group of output channel c, act(z) = z >= 0 ? z : slope*z (slope 1
// is no activation), and either the stride s or the dilation d equal to 1.
// The forward adds the bias in fp32 and rounds after the activation; dz is
// formed where it is loaded from the saved output, in the cotangent's type
// as the Pallas backward forms it (:140-143):
//
//   dz = round(dy * (y >= 0 ? 1 : slope_r))     slope_r = slope rounded to that type,
//
// and dx is summed in fp32 and rounded to the input's type. The weight and
// bias gradients are PyTorch products in the wrapper, as they are XLA
// einsums outside the Pallas call in JAX.
//
// What bounds it: arithmetic. A V1 MSD traversal at B=16 x 8192 samples is
// ~7.1e10 FLOP a pass for ~0.2 GB of activations, far above the H100's
// bytes-per-FLOP ridge; the distillation's convs (k3 at 4-1092 channels)
// likewise.
//
// Design (simple and correct first; mma/wgmma and TMA are later work): the
// per-layer implicit GEMM of csrc/conv_stack.cu, copied and given a
// dilation and a dtype-rounded dz:
// - a 256-thread block computes a BM x BN output tile with 4x4 per thread,
//   BN in {16, 32, 64} from the group width (BM = 4096 / BN), the groups on
//   grid z, walking the reduction 16 slots at a time through shared memory;
//   the operand loaders read the unfolded input with bounds checks (taps,
//   stride, dilation, zero padding, groups);
// - dx is taken per output phase: rows u of one phase (u + pad) mod s meet
//   only the taps k = phase + s*q, so a strided conv's dx does no work on
//   the taps it skips; at stride 1 the one phase meets every tap, d apart.
// - The TPU kernel's phase folding into (B, G, U, s*C'), group
//   densification and weight-block tiling are VMEM devices and are not
//   carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;            // reduction slots per shared-memory step
constexpr int kAStride = kBK + 1;  // padded row of the staged A tile
constexpr int kInvalid = -(1 << 30);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

template <int BN>
struct Tile {
  static constexpr int TX = BN / 4;              // threads across the tile's columns
  static constexpr int BM = (kThreads / TX) * 4;  // tile rows
  static constexpr int BNP = BN + 4;             // padded row of the staged B tile
  static constexpr int KPT = BM / 64;            // reduction slots a loader takes per row
  static constexpr int LPR = kBK / KPT;          // loaders per A row
  static constexpr int RPP = kThreads / LPR;     // A rows per loading pass (4 passes)
};

struct Geom {
  int n, t_in, c_in, t_out, c_out, k, s, d, groups, pad_l;
  int ci_g, co_g;
  float slope;
};

// acc[i][j] += sum_kk As[row i][kk] * Bs[kk][col j] over one staged step
template <int BN>
__device__ __forceinline__ void mac_step(const float* As, const float* Bs, float (&acc)[4][4],
                                         int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 b = *reinterpret_cast<const float4*>(Bs + kk * Tile<BN>::BNP + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = As[(ty * 4 + i) * kAStride + kk];
      acc[i][0] = fmaf(a, b.x, acc[i][0]);
      acc[i][1] = fmaf(a, b.y, acc[i][1]);
      acc[i][2] = fmaf(a, b.z, acc[i][2]);
      acc[i][3] = fmaf(a, b.w, acc[i][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(N*T_out / BM), ceil(co_g / BN), groups)
// ---------------------------------------------------------------------------
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    msd_fwd_kernel(Geom G, const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y) {
  using TL = Tile<BN>;
  __shared__ __align__(16) float As[TL::BM * kAStride];
  __shared__ __align__(16) float Bs[kBK * TL::BNP];
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * BN, g = blockIdx.z;
  const int M = G.n * G.t_out, kdim = G.k * G.ci_g;
  const T* xg = x + (long)g * G.ci_g;

  const int slot0 = (tid % TL::LPR) * TL::KPT;
  int tin0[4];
  long xrow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / TL::LPR + j * TL::RPP;
    tin0[j] = kInvalid;
    xrow[j] = 0;
    if (m < M) {
      const int nb = m / G.t_out, t = m - nb * G.t_out;
      tin0[j] = t * G.s - G.pad_l;
      xrow[j] = (long)nb * G.t_in + tin0[j];
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < kdim; r0 += kBK) {
#pragma unroll
    for (int u = 0; u < TL::KPT; ++u) {
      const int slot = slot0 + u, r = r0 + slot;
      const bool rv = r < kdim;
      const int tap = rv ? r / G.ci_g : 0;
      const int ci = r - tap * G.ci_g;
      const int off = tap * G.d;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tin = tin0[j] + off;
        float v = 0.f;
        if (rv && tin >= 0 && tin < G.t_in) v = to_f(xg[(xrow[j] + off) * G.c_in + ci]);
        As[(tid / TL::LPR + j * TL::RPP) * kAStride + slot] = v;
      }
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int nn = e % BN, kk = e / BN, r = r0 + kk, o = n0 + nn;
      Bs[kk * TL::BNP + nn] =
          (r < kdim && o < G.co_g) ? to_f(w[(long)r * G.c_out + g * G.co_g + o]) : 0.f;
    }
    __syncthreads();
    mac_step<BN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx * 4 + j;
      if (o >= G.co_g) continue;
      const int c = g * G.co_g + o;
      const float z = acc[i][j] + (bias != nullptr ? bias[c] : 0.f);
      y[(long)m * G.c_out + c] = from_f<T>(fmaxf(z, 0.f) + G.slope * fminf(z, 0.f));
    }
  }
}

// ---------------------------------------------------------------------------
// dx: grid (ceil(N * ceil(T_in/s) / BM), ceil(ci_g / BN), groups * s).
// Rows u = ph + s*j of one phase ph meet taps k = k0 + s*q, k0 = (ph+pad) mod s,
// at output rows t = j + (ph + pad - k0)/s - q*d (s = 1 or d = 1).
// ---------------------------------------------------------------------------
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    msd_dx_kernel(Geom G, const T* __restrict__ dy, const T* __restrict__ y,
                  const T* __restrict__ w, T* __restrict__ dx) {
  using TL = Tile<BN>;
  __shared__ __align__(16) float As[TL::BM * kAStride];
  __shared__ __align__(16) float Bs[kBK * TL::BNP];
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int g = blockIdx.z / G.s, ph = blockIdx.z % G.s;
  const int J = ph < G.t_in ? (G.t_in - ph + G.s - 1) / G.s : 0;
  const int M = G.n * J;
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * BN;
  if (m0 >= M) return;
  const int k0 = (ph + G.pad_l) % G.s;
  const int nq = G.k > k0 ? (G.k - k0 + G.s - 1) / G.s : 0;
  const int tb_off = (ph + G.pad_l - k0) / G.s;
  const int kdim = nq * G.co_g;

  const int slot0 = (tid % TL::LPR) * TL::KPT;
  int tb[4];
  long dzrow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / TL::LPR + j * TL::RPP;
    tb[j] = kInvalid;
    dzrow[j] = 0;
    if (m < M) {
      const int nb = m / J;
      tb[j] = (m - nb * J) + tb_off;
      dzrow[j] = (long)nb * G.t_out + tb[j];
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int cg = g * G.co_g;
  for (int r0 = 0; r0 < kdim; r0 += kBK) {
#pragma unroll
    for (int u = 0; u < TL::KPT; ++u) {
      const int slot = slot0 + u, r = r0 + slot;
      const bool rv = r < kdim;
      const int q = rv ? r / G.co_g : 0;
      const int o = r - q * G.co_g;
      const int qd = q * G.d;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tb[j] - qd;
        float v = 0.f;
        if (rv && t >= 0 && t < G.t_out) {
          const long idx = (dzrow[j] - qd) * G.c_out + cg + o;
          float dz = to_f(dy[idx]);
          if (G.slope != 1.f && to_f(y[idx]) < 0.f) dz = rnd<T>(dz * G.slope);
          v = dz;
        }
        As[(tid / TL::LPR + j * TL::RPP) * kAStride + slot] = v;
      }
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int kk = e % kBK, nn = e / kBK, r = r0 + kk, i = n0 + nn;
      float v = 0.f;
      if (r < kdim && i < G.ci_g) {
        const int q = r / G.co_g, o = r - q * G.co_g;
        v = to_f(w[((long)(k0 + G.s * q) * G.ci_g + i) * G.c_out + cg + o]);
      }
      Bs[kk * TL::BNP + nn] = v;
    }
    __syncthreads();
    mac_step<BN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int nb = m / J;
    const long row = (long)nb * G.t_in + ph + (long)G.s * (m - nb * J);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx * 4 + j;
      if (ci < G.ci_g) dx[row * G.c_in + g * G.ci_g + ci] = from_f<T>(acc[i][j]);
    }
  }
}

int pick_bn(int cols) { return cols >= 64 ? 64 : (cols >= 32 ? 32 : 16); }

Geom make_geom(int n, int t_in, int c_in, int t_out, int c_out, int k, int s, int d, int groups,
               int pad_l, float slope) {
  Geom G;
  G.n = n;
  G.t_in = t_in;
  G.c_in = c_in;
  G.t_out = t_out;
  G.c_out = c_out;
  G.k = k;
  G.s = s;
  G.d = d;
  G.groups = groups;
  G.pad_l = pad_l;
  G.ci_g = groups > 0 ? c_in / groups : 0;
  G.co_g = groups > 0 ? c_out / groups : 0;
  G.slope = slope;
  return G;
}

bool geom_ok(const Geom& G) {
  return G.n > 0 && G.t_in > 0 && G.t_out > 0 && G.k > 0 && G.s > 0 && G.d > 0 &&
         (G.s == 1 || G.d == 1) && G.groups > 0 && G.pad_l >= 0 && G.c_in % G.groups == 0 &&
         G.c_out % G.groups == 0 && G.ci_g > 0 && G.co_g > 0 &&
         (long)(G.t_out - 1) * G.s + (long)(G.k - 1) * G.d - G.pad_l < (1L << 30);
}

unsigned cdiv(long a, long b) { return static_cast<unsigned>((a + b - 1) / b); }

template <typename T, int BN>
int fwd_launch(const Geom& G, const void* x, const void* w, const float* bias, void* y,
               cudaStream_t st) {
  const dim3 grid(cdiv((long)G.n * G.t_out, Tile<BN>::BM), cdiv(G.co_g, BN), G.groups);
  msd_fwd_kernel<T, BN><<<grid, kThreads, 0, st>>>(G, static_cast<const T*>(x),
                                                   static_cast<const T*>(w), bias,
                                                   static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int dx_launch(const Geom& G, const void* dy, const void* y, const void* w, void* dx,
              cudaStream_t st) {
  const dim3 grid(cdiv((long)G.n * cdiv(G.t_in, G.s), Tile<BN>::BM), cdiv(G.ci_g, BN),
                  G.groups * G.s);
  msd_dx_kernel<T, BN><<<grid, kThreads, 0, st>>>(G, static_cast<const T*>(dy),
                                                  static_cast<const T*>(y),
                                                  static_cast<const T*>(w), static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

#define DISPATCH(dtype, bn, CALL)                                         \
  do {                                                                    \
    if ((dtype) == 0) {                                                   \
      if ((bn) == 64) return CALL(float, 64);                             \
      if ((bn) == 32) return CALL(float, 32);                             \
      return CALL(float, 16);                                             \
    }                                                                     \
    if ((dtype) == 1) {                                                   \
      if ((bn) == 64) return CALL(__nv_bfloat16, 64);                     \
      if ((bn) == 32) return CALL(__nv_bfloat16, 32);                     \
      return CALL(__nv_bfloat16, 16);                                     \
    }                                                                     \
    return static_cast<int>(cudaErrorInvalidValue);                       \
  } while (0)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launch.
// x (n, t_in, c_in), w (k, c_in/groups, c_out), bias (c_out,) fp32 or null,
// y (n, t_out, c_out), all contiguous, in the working type but bias.
int hifigan_msd_fwd(int dtype, const void* x, const void* w, const float* bias, void* y, int n,
                    int t_in, int c_in, int t_out, int c_out, int k, int s, int d, int groups,
                    int pad_l, float slope, void* stream) {
  const Geom G = make_geom(n, t_in, c_in, t_out, c_out, k, s, d, groups, pad_l, slope);
  if (!geom_ok(G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(T, BN) fwd_launch<T, BN>(G, x, w, bias, y, st)
  DISPATCH(dtype, pick_bn(G.co_g), FWD);
#undef FWD
}

// dx (n, t_in, c_in) in the working type <- the input gradient for the output
// cotangent dy and the saved output y (both (n, t_out, c_out)); slope is the
// leaky-ReLU slope rounded to the working type (1 = no activation).
int hifigan_msd_dx(int dtype, const void* dy, const void* y, const void* w, void* dx, int n,
                   int t_in, int c_in, int t_out, int c_out, int k, int s, int d, int groups,
                   int pad_l, float slope, void* stream) {
  const Geom G = make_geom(n, t_in, c_in, t_out, c_out, k, s, d, groups, pad_l, slope);
  if (!geom_ok(G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DX(T, BN) dx_launch<T, BN>(G, dy, y, w, dx, st)
  DISPATCH(dtype, pick_bn(G.ci_g), DX);
#undef DX
}

}  // extern "C"
