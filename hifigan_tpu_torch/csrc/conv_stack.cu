// Grouped, strided conv1d + bias + leaky-ReLU layers of the multi-scale
// discriminator (MSD layers 1-6 and conv_post), forward and backward, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces hifigan_tpu/ops/pallas/conv_stack.py::fused_conv_stack (:973):
// the forward kernel _fwd_kernel (:317, Pallas call :407) and the fused
// backward _bwd_kernel (:427, Pallas call :685). The stack is driven layer by
// layer from hifigan_tpu_torch/ops/conv_stack.py; every layer's
// post-activation is an output of the function, so each layer is one launch
// per pass:
//
//   forward  y[n,t,c]   = lrelu(b[c] + sum_{k,i} x[n, t*s+k-pad, g*ci_g+i] * W[k,i,c])
//   dx       da[n,u,ci] = sum_{k,o: t*s+k-pad = u} dz[n,t,g*co_g+o] * W[k,i,g*co_g+o]
//   dW, db   dW[k,i,c]  = sum_{n,t} x[n, t*s+k-pad, g*ci_g+i] * dz[n,t,c],
//            db[c]      = sum_{n,t} dz[n,t,c]
//
// with channels-last activations (N, T, C), weights (K, C_in/groups, C_out)
// (the JAX layout, read as a (K*C_in/groups, C_out) matrix), zero padding
// and g the group of output channel c. The cotangent of the pre-activation
// is formed where it is loaded, from the saved post-activation y:
//
//   dz = (dy + up) * (y >= 0 ? 1 : slope)      in fp32,
//
// up being the fp32 input-cotangent of the layer above (kept in fp32 between
// layers, as the Pallas backward keeps it inside a chunk). db sums that fp32
// dz; the products (dx, dW) take dz rounded to the working type (:560). The
// weight gradient is reduced over N*T in per-block partials and a second
// pass that sums them in a fixed order: no float atomics, so two runs of the
// same step give identical gradients.
//
// What bounds it: arithmetic. At V1 (B=16, 8192 samples) one traversal of
// layers 1-6 + conv_post at scale 0 is ~7.1e10 FLOP and a GAN train step
// runs ~1.1e12 FLOP through these kernels, against a few hundred MB of
// activations: far above the H100's bytes-per-FLOP ridge.
//
// Design (simple and correct first; mma/wgmma and TMA are later work):
// - Each pass is an implicit GEMM per group on CUDA cores in fp32 FMA:
//   a 256-thread block computes a BM x BN output tile with 4x4 per thread,
//   BN in {16, 32, 64} chosen from the group width (BM = 4096 / BN), and
//   walks the reduction 16 at a time through shared memory. The operand
//   loaders do the im2col (taps, stride, zero padding, groups) on the fly.
// - dx is a transposed conv computed per output phase: rows u of one phase
//   (u + pad) mod s meet only the taps k = phase + s*q, so a block takes
//   rows of one phase and a dense (q, o) reduction, with no work on the
//   taps that a strided conv skips.
// - The TPU kernel's zone layout, lane folding, group densification, small-T
//   tail batching, backward chunking and XLA weight-grad split are VMEM
//   devices and are not carried over.

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

// Layer geometry, shared by the three passes.
struct Geom {
  int n, t_in, c_in, t_out, c_out, k, s, groups, pad_l;
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

// The fp32 pre-activation cotangent at flat index idx of (N, T_out, C_out).
template <typename T>
__device__ __forceinline__ float dz_raw(const T* dy, const float* up, const T* y, long idx,
                                        float slope) {
  float v = 0.f;
  if (dy != nullptr) v += to_f(dy[idx]);
  if (up != nullptr) v += up[idx];
  if (slope != 1.f && to_f(y[idx]) < 0.f) v *= slope;
  return v;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(N*T_out / BM), ceil(co_g / BN), groups)
// ---------------------------------------------------------------------------
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_fwd_kernel(Geom G, const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y) {
  using TL = Tile<BN>;
  __shared__ __align__(16) float As[TL::BM * kAStride];
  __shared__ __align__(16) float Bs[kBK * TL::BNP];
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * BN, g = blockIdx.z;
  const int M = G.n * G.t_out, kdim = G.k * G.ci_g;
  const T* xg = x + (long)g * G.ci_g;

  const int slot0 = (tid % TL::LPR) * TL::KPT;
  int xrow[4], tin0[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / TL::LPR + j * TL::RPP;
    tin0[j] = kInvalid;
    xrow[j] = 0;
    if (m < M) {
      const int nb = m / G.t_out, t = m - nb * G.t_out;
      tin0[j] = t * G.s - G.pad_l;
      xrow[j] = nb * G.t_in + tin0[j];
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tin = tin0[j] + tap;
        float v = 0.f;
        if (rv && tin >= 0 && tin < G.t_in) v = to_f(xg[(long)(xrow[j] + tap) * G.c_in + ci]);
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
// dx: grid (ceil(N * ceil(T_in/s) / BM), ceil(ci_g / BN), groups * s)
// Rows u = ph + s*j of one phase ph meet taps k = k0 + s*q, k0 = (ph+pad) mod s,
// at output rows t = j + (ph + pad - k0)/s - q.
// ---------------------------------------------------------------------------
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_dx_kernel(Geom G, const T* __restrict__ dy, const float* __restrict__ up,
                   const T* __restrict__ y, const T* __restrict__ w, float* __restrict__ da) {
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
  int tb[4], dzrow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / TL::LPR + j * TL::RPP;
    tb[j] = kInvalid;
    dzrow[j] = 0;
    if (m < M) {
      const int nb = m / J;
      tb[j] = (m - nb * J) + tb_off;
      dzrow[j] = nb * G.t_out + tb[j];
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tb[j] - q;
        float v = 0.f;
        if (rv && t >= 0 && t < G.t_out)
          v = rnd<T>(dz_raw(dy, up, y, (long)(dzrow[j] - q) * G.c_out + cg + o, G.slope));
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
    const long row = (long)nb * G.t_in + ph + G.s * (m - nb * J);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx * 4 + j;
      if (ci < G.ci_g) da[row * G.c_in + g * G.ci_g + ci] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dW partials: grid (ceil(K*ci_g / BM), ceil(co_g / BN), groups * splits).
// Block (rows r = (k, i), cols o) sums over m = (n, t) in its split's range
// and writes partial[split][r][g*co_g + o]; the blocks of row tile 0 also
// write the split's bias-gradient partial pdb[split][c].
// ---------------------------------------------------------------------------
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    conv_dw_kernel(Geom G, const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ up, const T* __restrict__ y, int split_rows,
                   float* __restrict__ partial, float* __restrict__ pdb) {
  using TL = Tile<BN>;
  __shared__ __align__(16) float As[TL::BM * kAStride];
  __shared__ __align__(16) float Bs[kBK * TL::BNP];
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int g = blockIdx.z % G.groups, split = blockIdx.z / G.groups;
  const int r0t = blockIdx.x * TL::BM, n0 = blockIdx.y * BN;
  const int kdim = G.k * G.ci_g;
  const int M = G.n * G.t_out;
  const int m_begin = split * split_rows;
  const int m_end = min(M, m_begin + split_rows);

  // A^T loader: one row r (tap, channel) per thread, several m per step
  const int rr = tid % TL::BM;
  const int kk_first = tid / TL::BM, kk_step = kThreads / TL::BM;
  const int r = r0t + rr;
  const bool rv = r < kdim;
  const int tap = rv ? r / G.ci_g : 0;
  const int ci = r - tap * G.ci_g;
  const T* xg = x + (long)g * G.ci_g + ci;
  // B loader (dz): one column per thread
  const int nn = tid % BN;
  const int o = n0 + nn;
  const bool cv = o < G.co_g;
  const int c = g * G.co_g + o;
  float db_acc = 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int nc = m_begin / G.t_out, tc = m_begin - nc * G.t_out;  // (n, t) of the step's first m
  for (int mc = m_begin; mc < m_end; mc += kBK) {
    for (int kk = kk_first; kk < kBK; kk += kk_step) {
      int t = tc + kk, nb = nc;
      while (t >= G.t_out) {
        t -= G.t_out;
        ++nb;
      }
      const int tin = t * G.s + tap - G.pad_l;
      float v = 0.f;
      if (rv && mc + kk < m_end && tin >= 0 && tin < G.t_in)
        v = to_f(xg[((long)nb * G.t_in + tin) * G.c_in]);
      As[rr * kAStride + kk] = v;
    }
    for (int kk = tid / BN; kk < kBK; kk += kThreads / BN) {
      float v = 0.f;
      if (cv && mc + kk < m_end) v = dz_raw(dy, up, y, (long)(mc + kk) * G.c_out + c, G.slope);
      db_acc += v;
      Bs[kk * TL::BNP + nn] = rnd<T>(v);
    }
    __syncthreads();
    mac_step<BN>(As, Bs, acc, tx, ty);
    __syncthreads();
    tc += kBK;
    while (tc >= G.t_out) {
      tc -= G.t_out;
      ++nc;
    }
  }

  float* out = partial + (long)split * kdim * G.c_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0t + ty * 4 + i;
    if (row >= kdim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int oo = n0 + tx * 4 + j;
      if (oo < G.co_g) out[(long)row * G.c_out + g * G.co_g + oo] = acc[i][j];
    }
  }
  if (blockIdx.x == 0) {
    // the block's column sums in a fixed order: threads nn, nn + BN, ...
    As[tid] = db_acc;
    __syncthreads();
    if (tid < BN && n0 + tid < G.co_g) {
      float s = 0.f;
      for (int q = tid; q < kThreads; q += BN) s += As[q];
      pdb[(long)split * G.c_out + g * G.co_g + n0 + tid] = s;
    }
  }
}

// dW[e] = sum over splits of partial[split][e] (rounded to the working type),
// db[c] = sum over splits of pdb[split][c] (fp32), in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ pdb,
                     long wsize, int c_out, int splits, T* __restrict__ dw, float* __restrict__ db) {
  const long total = wsize + c_out;
  for (long e = blockIdx.x * (long)kThreads + threadIdx.x; e < total;
       e += (long)gridDim.x * kThreads) {
    float s = 0.f;
    if (e < wsize) {
      for (int sp = 0; sp < splits; ++sp) s += partial[sp * wsize + e];
      dw[e] = from_f<T>(s);
    } else {
      const long cc = e - wsize;
      for (int sp = 0; sp < splits; ++sp) s += pdb[sp * (long)c_out + cc];
      db[cc] = s;
    }
  }
}

int pick_bn(int cols) { return cols >= 64 ? 64 : (cols >= 32 ? 32 : 16); }

Geom make_geom(int n, int t_in, int c_in, int t_out, int c_out, int k, int s, int groups,
               int pad_l, float slope) {
  Geom G;
  G.n = n;
  G.t_in = t_in;
  G.c_in = c_in;
  G.t_out = t_out;
  G.c_out = c_out;
  G.k = k;
  G.s = s;
  G.groups = groups;
  G.pad_l = pad_l;
  G.ci_g = c_in / groups;
  G.co_g = c_out / groups;
  G.slope = slope;
  return G;
}

bool geom_ok(const Geom& G) {
  return G.n > 0 && G.t_in > 0 && G.t_out > 0 && G.k > 0 && G.s > 0 && G.groups > 0 &&
         G.pad_l >= 0 && G.c_in % G.groups == 0 && G.c_out % G.groups == 0 && G.ci_g > 0 &&
         G.co_g > 0;
}

unsigned cdiv(long a, long b) { return static_cast<unsigned>((a + b - 1) / b); }

template <typename T, int BN>
int fwd_launch(const Geom& G, const void* x, const void* w, const float* bias, void* y,
               cudaStream_t st) {
  const dim3 grid(cdiv((long)G.n * G.t_out, Tile<BN>::BM), cdiv(G.co_g, BN), G.groups);
  conv_fwd_kernel<T, BN><<<grid, kThreads, 0, st>>>(G, static_cast<const T*>(x),
                                                    static_cast<const T*>(w), bias,
                                                    static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int dx_launch(const Geom& G, const void* dy, const float* up, const void* y, const void* w,
              float* da, cudaStream_t st) {
  const dim3 grid(cdiv((long)G.n * cdiv(G.t_in, G.s), Tile<BN>::BM), cdiv(G.ci_g, BN),
                  G.groups * G.s);
  conv_dx_kernel<T, BN><<<grid, kThreads, 0, st>>>(G, static_cast<const T*>(dy), up,
                                                   static_cast<const T*>(y),
                                                   static_cast<const T*>(w), da);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int dw_launch(const Geom& G, const void* x, const void* dy, const float* up, const void* y,
              int splits, int split_rows, float* partial, float* pdb, void* dw, float* db,
              cudaStream_t st) {
  const dim3 grid(cdiv((long)G.k * G.ci_g, Tile<BN>::BM), cdiv(G.co_g, BN), G.groups * splits);
  conv_dw_kernel<T, BN><<<grid, kThreads, 0, st>>>(
      G, static_cast<const T*>(x), static_cast<const T*>(dy), up, static_cast<const T*>(y),
      split_rows, partial, pdb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long wsize = (long)G.k * G.ci_g * G.c_out;
  const unsigned blocks = cdiv(wsize + G.c_out, kThreads);
  const unsigned rgrid = blocks < 4096u ? blocks : 4096u;
  dw_reduce_kernel<T><<<rgrid, kThreads, 0, st>>>(partial, pdb, wsize, G.c_out, splits,
                                                  static_cast<T*>(dw), db);
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

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launches.
// x (n, t_in, c_in), w (k, c_in/groups, c_out), bias (c_out,) fp32 or null,
// y (n, t_out, c_out), all contiguous, in the working type but bias.
int hifigan_conv_fwd(int dtype, const void* x, const void* w, const float* bias, void* y, int n,
                     int t_in, int c_in, int t_out, int c_out, int k, int s, int groups,
                     int pad_l, float slope, void* stream) {
  const Geom G = make_geom(n, t_in, c_in, t_out, c_out, k, s, groups, pad_l, slope);
  if (!geom_ok(G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(T, BN) fwd_launch<T, BN>(G, x, w, bias, y, st)
  DISPATCH(dtype, pick_bn(G.co_g), FWD);
#undef FWD
}

// da (n, t_in, c_in) fp32 <- the input cotangent of one layer; dz is formed
// from dy (working type, or null), up (fp32, or null) and the saved y.
int hifigan_conv_dx(int dtype, const void* dy, const float* up, const void* y, const void* w,
                    float* da, int n, int t_in, int c_in, int t_out, int c_out, int k, int s,
                    int groups, int pad_l, float slope, void* stream) {
  const Geom G = make_geom(n, t_in, c_in, t_out, c_out, k, s, groups, pad_l, slope);
  if (!geom_ok(G) || (dy == nullptr && up == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DX(T, BN) dx_launch<T, BN>(G, dy, up, y, w, da, st)
  DISPATCH(dtype, pick_bn(G.ci_g), DX);
#undef DX
}

// dw (k, c_in/groups, c_out) in the working type and db (c_out,) fp32; partial
// (splits, k*c_in/groups, c_out) and pdb (splits, c_out) are fp32 scratch.
// Split sp sums rows m = n*t_out + t in [sp*split_rows, (sp+1)*split_rows).
int hifigan_conv_dw(int dtype, const void* x, const void* dy, const float* up, const void* y,
                    float* partial, float* pdb, void* dw, float* db, int n, int t_in, int c_in,
                    int t_out, int c_out, int k, int s, int groups, int pad_l, float slope,
                    int splits, int split_rows, void* stream) {
  const Geom G = make_geom(n, t_in, c_in, t_out, c_out, k, s, groups, pad_l, slope);
  if (!geom_ok(G) || (dy == nullptr && up == nullptr) || splits < 1 || split_rows < 1 ||
      (long)splits * split_rows < (long)n * t_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DW(T, BN) dw_launch<T, BN>(G, x, dy, up, y, splits, split_rows, partial, pdb, dw, db, st)
  DISPATCH(dtype, pick_bn(G.co_g), DW);
#undef DW
}

}  // extern "C"
