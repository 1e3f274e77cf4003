// One segment of a stream graph (a DAG of narrow conv1d ops over sample-space
// levels) forward and backward, for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces hifigan_tpu/ops/pallas/stream_graph.py::fused_stream_graph (:786):
// the forward kernel _fwd_kernel (:331, Pallas call :428) and the fused
// backward _bwd_kernel (:449, Pallas call :678). The segment is driven op by
// op from hifigan_tpu_torch/ops/stream_graph.py, one launch per op and pass.
//
// A level is an activation (t, c) of each batch element, stored time-major
// and channel-last; an edge reads its source level as (t*c / c_in, c_in), so
// conv_rech's rechannel and roll's period reshape are views of the same
// memory. Batch element b belongs to ensemble member m = b / n_per, whose
// weights are the m-th slice of each stacked table (M, K, c_in, c_out).
// One op computes, in fp32 from its bias:
//
//   z[b,t,o] = bias[m,o] + sum_e sum_{k,i} src_e[b, t*s_e - pad_e + k*d_e, i] W_e[m,k,i,o]
//              (+ res[b,t,o])
//   y = act(z) rounded to the working type, act in {none, lrelu, tanh, square, log1e5}
//
// with zero padding at each source level's own sequence edge (a branch
// shorter than the op's input length reads zeros past its end, as the
// interpreter's pad-then-concat does). The backward forms the cotangent of the
// pre-activation where it is loaded, from the op's fp32 output cotangent da
// and its saved output y (Pallas _act_vjp_mask, :309):
//
//   lrelu: dz = da * (y >= 0 ? 1 : slope)     tanh:   dz = da * (1 - y^2)
//   square: dz = da * 2 * res_src             log1e5: dz = y > log(1e-5) ? da * exp(-y) : 0
//
// dx adds, for every source level that needs a cotangent, the transposed conv
// of dz rounded to the working type (and, for a residual source, dz itself in
// fp32) into that level's fp32 cotangent; dW sums src x round(dz) over the
// member's rows in per-block partials and a second kernel reduces them in
// split order, with db from the unrounded dz: no float atomics anywhere.
//
// What bounds it: arithmetic, at SIMT fp32 rates. A production all-in-one
// member (configs/distill.json) is ~59 ops and ~0.6 GFLOP per 43,680-sample
// element forward, against ~175 KB per element per level; a distill step
// runs ~1.7e11 FLOP through these kernels.
//
// Design (simple and right first; tensor cores and one launch per segment are
// later work):
// - Every pass is an implicit GEMM on CUDA cores in fp32 FMA (the scheme of
//   csrc/conv_stack.cu): a 256-thread block computes a BM x BN tile with 4x4
//   outputs a thread, BN in {8, 16, 32, 64} from the column count, walking the
//   reduction 16 slots at a time through shared memory; the loaders do the
//   im2col (taps, stride, dilation, padding, the channel view) on the fly.
// - The forward sums an op's edges into one accumulator (a conv over a
//   channel concat is a sum of per-branch convs) and applies residual, bias
//   and activation in the epilogue; levels live in device memory between ops
//   (a member's level is ~175 KB per element; the batch's fit the 50 MB L2
//   only partly).
// - dx is one launch per op over "jobs", one per target level, each summing
//   the op's edges from that level (and its residual). A strided edge
//   (d == 1) is taken per output phase, as conv_stack's dx: rows of one phase
//   meet only every s-th tap, so no work goes to taps a strided conv skips.
// - The three ensemble members share every launch: grid z carries the member.
// - The TPU kernel's time-folded lanes, banded per-tap tables, zones, leads,
//   guards and zone_grouped_layer are VMEM/lane devices and are not carried
//   over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;            // reduction slots per shared-memory step
constexpr int kAStride = kBK + 1;  // padded row of the staged A tile
constexpr int kMaxEdges = 4;       // edges of one op / jobs of one launch
constexpr int kInvalid = -(1 << 30);

enum Act { kNone = 0, kLrelu = 1, kTanh = 2, kSquare = 3, kLog = 4 };

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
  static constexpr int TX = BN / 4;               // threads across the tile's columns
  static constexpr int BM = (kThreads / TX) * 4;  // tile rows
  static constexpr int BNP = BN + 4;              // padded row of the staged B tile
  static constexpr int KPT = BM / 64;             // reduction slots a loader takes per row
  static constexpr int LPR = kBK / KPT;           // loaders per A row
  static constexpr int RPP = kThreads / LPR;      // A rows per loading pass (4 passes)
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

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ float act_fwd(float z, int act, float slope) {
  switch (act) {
    case kLrelu: return fmaxf(z, 0.f) + slope * fminf(z, 0.f);
    case kTanh: return tanhf(z);
    case kSquare: return z * z;
    case kLog: return logf(fmaxf(z, 1e-5f));
    default: return z;
  }
}

// The op's output side, shared by the backward passes: the fp32 cotangent of
// its output, its saved output and (square) the residual source it squared.
template <typename T>
struct OutSide {
  const float* da;  // (B, t_out, c_out) fp32
  const T* y;       // (B, t_out, c_out)
  const T* sq;      // square: residual source, element stride sq_estride; else null
  int sq_estride;
  int t_out, c_out, act;
  float slope;

  // fp32 pre-activation cotangent at (element b, row t, channel o)
  __device__ __forceinline__ float dz(long b, int t, int o) const {
    const long idx = (b * t_out + t) * c_out + o;
    const float g = da[idx];
    switch (act) {
      case kLrelu: return to_f(y[idx]) >= 0.f ? g : g * slope;
      case kTanh: {
        const float v = to_f(y[idx]);
        return g * (1.f - v * v);
      }
      case kSquare: return g * 2.f * to_f(sq[b * sq_estride + (long)t * c_out + o]);
      case kLog: {
        const float v = to_f(y[idx]);
        return v > logf(1e-5f) ? g * expf(-v) : 0.f;
      }
      default: return g;
    }
  }
};

// ---------------------------------------------------------------------------
// forward: grid (ceil(n_per * t_out / BM), ceil(c_out / BN), members)
// ---------------------------------------------------------------------------
struct FwdP {
  const void* src[kMaxEdges];
  const void* w[kMaxEdges];
  int t_src[kMaxEdges], c_src[kMaxEdges], k[kMaxEdges], s[kMaxEdges], d[kMaxEdges],
      pad[kMaxEdges];
  int n_edges;
  const float* bias;  // (M, c_out) or null
  const void* res;    // residual source viewed with c_out channels, or null
  int res_estride;
  void* out;
  int t_out, c_out, act;
  float slope;
  int n_per;
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads) sg_fwd_kernel(FwdP P) {
  using TL = Tile<BN>;
  __shared__ __align__(16) float As[TL::BM * kAStride];
  __shared__ __align__(16) float Bs[kBK * TL::BNP];
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * BN, mem = blockIdx.z;
  const int M = P.n_per * P.t_out;
  const long b0 = (long)mem * P.n_per;
  const int slot0 = (tid % TL::LPR) * TL::KPT;

  float acc[4][4];
  zero(acc);

  for (int e = 0; e < P.n_edges; ++e) {
    const T* src = static_cast<const T*>(P.src[e]);
    const T* w = static_cast<const T*>(P.w[e]) + (long)mem * P.k[e] * P.c_src[e] * P.c_out;
    const int cs = P.c_src[e], ts = P.t_src[e], sd = P.d[e];
    const int kdim = P.k[e] * cs;
    long xrow[4];
    int tin0[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tid / TL::LPR + j * TL::RPP;
      tin0[j] = kInvalid;
      xrow[j] = 0;
      if (m < M) {
        const int nb = m / P.t_out, t = m - nb * P.t_out;
        tin0[j] = t * P.s[e] - P.pad[e];
        xrow[j] = (b0 + nb) * ts + tin0[j];
      }
    }
    for (int r0 = 0; r0 < kdim; r0 += kBK) {
#pragma unroll
      for (int u = 0; u < TL::KPT; ++u) {
        const int slot = slot0 + u, r = r0 + slot;
        const bool rv = r < kdim;
        const int tap = rv ? r / cs : 0;
        const int ci = r - tap * cs;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tin = tin0[j] + tap * sd;
          float v = 0.f;
          if (rv && tin >= 0 && tin < ts) v = to_f(src[(xrow[j] + tap * sd) * cs + ci]);
          As[(tid / TL::LPR + j * TL::RPP) * kAStride + slot] = v;
        }
      }
      for (int q = tid; q < kBK * BN; q += kThreads) {
        const int nn = q % BN, kk = q / BN, r = r0 + kk, o = n0 + nn;
        Bs[kk * TL::BNP + nn] = (r < kdim && o < P.c_out) ? to_f(w[(long)r * P.c_out + o]) : 0.f;
      }
      __syncthreads();
      mac_step<BN>(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }

  const T* res = static_cast<const T*>(P.res);
  T* out = static_cast<T*>(P.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int nb = m / P.t_out, t = m - nb * P.t_out;
    const long b = b0 + nb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + tx * 4 + j;
      if (o >= P.c_out) continue;
      float z = acc[i][j];
      if (P.bias != nullptr) z += P.bias[(long)mem * P.c_out + o];
      if (res != nullptr) z += to_f(res[b * P.res_estride + (long)t * P.c_out + o]);
      out[(b * P.t_out + t) * P.c_out + o] = from_f<T>(act_fwd(z, P.act, P.slope));
    }
  }
}

// ---------------------------------------------------------------------------
// dx: grid (ceil(n_per * max ceil(t_tgt / s) / BM), ceil(c_tgt_max / BN),
//           members * n_jobs * s_max)
// A job adds into one target level's fp32 cotangent da_tgt (t_tgt, c_tgt): the
// transposed convs of its edges (all of stride s) and, for the residual
// source, dz itself. Rows u = ph + s*j of phase ph meet taps k = k0 + s*q,
// k0 = (ph + pad) mod s, at output rows t = j + (ph + pad - k0)/s - q (s > 1,
// d == 1); with s == 1 the taps are k = q at t = u + pad - q*d.
// ---------------------------------------------------------------------------
struct DxJob {
  float* da;
  int t_tgt, c_tgt, s, n_edges, res;
  const void* w[kMaxEdges];
  int k[kMaxEdges], d[kMaxEdges], pad[kMaxEdges];
};

struct DxP {
  DxJob job[kMaxEdges];
  int n_jobs, s_max, n_per;
  const float* da_out;
  const void* y;
  const void* sq;
  int sq_estride, t_out, c_out, act;
  float slope;
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads) sg_dx_kernel(DxP P) {
  using TL = Tile<BN>;
  __shared__ __align__(16) float As[TL::BM * kAStride];
  __shared__ __align__(16) float Bs[kBK * TL::BNP];
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int z = blockIdx.z;
  const int ph = z % P.s_max, jb = (z / P.s_max) % P.n_jobs, mem = z / (P.s_max * P.n_jobs);
  const DxJob& J = P.job[jb];
  if (ph >= J.s || ph >= J.t_tgt) return;
  const int R = (J.t_tgt - ph + J.s - 1) / J.s;  // rows of this phase per element
  const int M = P.n_per * R;
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * BN;
  if (m0 >= M || n0 >= J.c_tgt) return;
  const long b0 = (long)mem * P.n_per;
  const OutSide<T> O{P.da_out, static_cast<const T*>(P.y), static_cast<const T*>(P.sq),
                     P.sq_estride, P.t_out, P.c_out, P.act, P.slope};
  const int slot0 = (tid % TL::LPR) * TL::KPT;

  float acc[4][4];
  zero(acc);

  for (int e = 0; e < J.n_edges; ++e) {
    const T* w = static_cast<const T*>(J.w[e]) + (long)mem * J.k[e] * J.c_tgt * P.c_out;
    int k0, nq, tb_off, dq;
    if (J.s == 1) {
      k0 = 0;
      nq = J.k[e];
      tb_off = J.pad[e];
      dq = J.d[e];
    } else {
      k0 = (ph + J.pad[e]) % J.s;
      nq = J.k[e] > k0 ? (J.k[e] - k0 + J.s - 1) / J.s : 0;
      tb_off = (ph + J.pad[e] - k0) / J.s;
      dq = 1;
    }
    const int kdim = nq * P.c_out;
    int tb[4];
    long eb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tid / TL::LPR + j * TL::RPP;
      tb[j] = kInvalid;
      eb[j] = 0;
      if (m < M) {
        const int nb = m / R;
        tb[j] = (m - nb * R) + tb_off;
        eb[j] = b0 + nb;
      }
    }
    for (int r0 = 0; r0 < kdim; r0 += kBK) {
#pragma unroll
      for (int u = 0; u < TL::KPT; ++u) {
        const int slot = slot0 + u, r = r0 + slot;
        const bool rv = r < kdim;
        const int q = rv ? r / P.c_out : 0;
        const int o = r - q * P.c_out;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = tb[j] - q * dq;
          float v = 0.f;
          if (rv && t >= 0 && t < P.t_out) v = rnd<T>(O.dz(eb[j], t, o));
          As[(tid / TL::LPR + j * TL::RPP) * kAStride + slot] = v;
        }
      }
      for (int q2 = tid; q2 < kBK * BN; q2 += kThreads) {
        const int kk = q2 % kBK, nn = q2 / kBK, r = r0 + kk, i = n0 + nn;
        float v = 0.f;
        if (r < kdim && i < J.c_tgt) {
          const int q = r / P.c_out, o = r - q * P.c_out;
          v = to_f(w[((long)(k0 + J.s * q) * J.c_tgt + i) * P.c_out + o]);
        }
        Bs[kk * TL::BNP + nn] = v;
      }
      __syncthreads();
      mac_step<BN>(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int nb = m / R;
    const int u = ph + J.s * (m - nb * R);
    const long b = b0 + nb;
    float* row = J.da + (b * J.t_tgt + u) * J.c_tgt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx * 4 + j;
      if (ci >= J.c_tgt) continue;
      float v = acc[i][j];
      if (J.res && u < P.t_out) v += O.dz(b, u, ci);
      row[ci] += v;
    }
  }
}

// ---------------------------------------------------------------------------
// dW partials: grid (ceil(kdim_max / BM), ceil(c_out / BN), members * n_jobs * splits),
// or (ceil(outputs / kThreads), 1, ...) for few outputs (dw_small).
// Block (rows r = (k, i), cols o) sums over the member's rows m = (n, t) in
// its split and writes partial[mem][split][r][o]; the blocks of row tile 0 of
// job 0 also write the split's bias partial pdb[mem][split][o].
// ---------------------------------------------------------------------------
struct DwJob {
  const void* src;
  float* partial;  // (M, splits, k * c_src, c_out); null: a bias-only job
  int t_src, c_src, k, s, d, pad;
};

struct DwP {
  DwJob job[kMaxEdges];
  int n_jobs, n_per, splits, split_rows, small;
  float* pdb;  // (M, splits, c_out) or null
  const float* da_out;
  const void* y;
  const void* sq;
  int sq_estride, t_out, c_out, act;
  float slope;
};

// Few outputs (a head's 3*c x 1, the before conv's 33 x 1; small = (kdim+1) *
// c_out <= kSmallOut): a GEMM tile would leave most of its threads idle, so
// each thread takes one output (r, o) of its job (or one db column), lanes of
// threads splitting the split's rows (kThreads / outputs of the block, at
// least 1), summed over lanes in a fixed order. grid.x covers the outputs in
// chunks of kThreads. The row loop keeps four rows' loads in flight.
constexpr int kSmallOut = 4 * kThreads;

template <typename T>
__device__ void dw_small(const DwP& P, const DwJob& J, int kdim, bool do_db, int mem, int split,
                         float* red) {
  const int tid = threadIdx.x;
  const int n_w = kdim * P.c_out;
  const int total = n_w + (do_db ? P.c_out : 0);
  const int first = blockIdx.x * kThreads;  // the block's first output
  if (first >= total) return;
  const int here = min(total - first, kThreads);
  const int lanes = kThreads / here;
  const int lane = tid / here;
  const int idx = first + tid % here;
  const int M = P.n_per * P.t_out;
  const int m_begin = split * P.split_rows;
  const int m_end = min(M, m_begin + P.split_rows);
  const long b0 = (long)mem * P.n_per;
  const T* src = static_cast<const T*>(J.src);
  const OutSide<T> O{P.da_out, static_cast<const T*>(P.y), static_cast<const T*>(P.sq),
                     P.sq_estride, P.t_out, P.c_out, P.act, P.slope};
  const bool is_w = idx < n_w;
  const int r = is_w ? idx / P.c_out : 0;
  const int o = is_w ? idx - r * P.c_out : idx - n_w;
  const int tap = r / J.c_src, ci = r - tap * J.c_src;
  const int t_src = J.t_src, c_src = J.c_src, s = J.s, off = tap * J.d - J.pad;
  float acc = 0.f;
  if (lane < lanes) {
#pragma unroll 4
    for (int m = m_begin + lane; m < m_end; m += lanes) {
      const int nb = m / P.t_out, t = m - nb * P.t_out;
      const long b = b0 + nb;
      const float g = O.dz(b, t, o);
      if (is_w) {
        const int tin = t * s + off;
        if (tin >= 0 && tin < t_src) acc += to_f(src[(b * t_src + tin) * c_src + ci]) * rnd<T>(g);
      } else {
        acc += g;
      }
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < here) {
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += red[l * here + tid];
    if (is_w)
      J.partial[((long)mem * P.splits + split) * n_w + idx] = sum;
    else
      P.pdb[((long)mem * P.splits + split) * P.c_out + o] = sum;
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads) sg_dw_kernel(DwP P) {
  using TL = Tile<BN>;
  __shared__ __align__(16) float As[TL::BM * kAStride];
  __shared__ __align__(16) float Bs[kBK * TL::BNP];
  __shared__ long rb[kBK];  // element of each staged row (-1: past the split)
  __shared__ int rt[kBK];   // its time step
  const int tid = threadIdx.x, tx = tid % TL::TX, ty = tid / TL::TX;
  const int z = blockIdx.z;
  const int split = z % P.splits, jb = (z / P.splits) % P.n_jobs, mem = z / (P.splits * P.n_jobs);
  const DwJob& J = P.job[jb];
  const int kdim = J.partial != nullptr ? J.k * J.c_src : 0;
  const int r0t = blockIdx.x * TL::BM, n0 = blockIdx.y * BN;
  if (P.small) {
    dw_small<T>(P, J, kdim, P.pdb != nullptr && jb == 0, mem, split, As);
    return;
  }
  const bool do_db = P.pdb != nullptr && jb == 0 && blockIdx.x == 0;
  if (r0t >= kdim && !do_db) return;
  const int M = P.n_per * P.t_out;
  const int m_begin = split * P.split_rows;
  const int m_end = min(M, m_begin + P.split_rows);
  const long b0 = (long)mem * P.n_per;
  const T* src = static_cast<const T*>(J.src);
  const OutSide<T> O{P.da_out, static_cast<const T*>(P.y), static_cast<const T*>(P.sq),
                     P.sq_estride, P.t_out, P.c_out, P.act, P.slope};
  float db_acc = 0.f;

  float acc[4][4];
  zero(acc);

  for (int mc = m_begin; mc < m_end; mc += kBK) {
    if (tid < kBK) {
      const int m = mc + tid;
      rb[tid] = -1;
      rt[tid] = 0;
      if (m < m_end) {
        const int nb = m / P.t_out;
        rb[tid] = b0 + nb;
        rt[tid] = m - nb * P.t_out;
      }
    }
    __syncthreads();
    for (int q = tid; q < TL::BM * kBK; q += kThreads) {
      const int rr = q % TL::BM, kk = q / TL::BM, r = r0t + rr;
      float v = 0.f;
      if (r < kdim && rb[kk] >= 0) {
        const int tap = r / J.c_src, ci = r - tap * J.c_src;
        const int tin = rt[kk] * J.s + tap * J.d - J.pad;
        if (tin >= 0 && tin < J.t_src) v = to_f(src[(rb[kk] * J.t_src + tin) * J.c_src + ci]);
      }
      As[rr * kAStride + kk] = v;
    }
    for (int q = tid; q < kBK * BN; q += kThreads) {
      const int nn = q % BN, kk = q / BN, o = n0 + nn;
      float v = 0.f;
      if (o < P.c_out && rb[kk] >= 0) v = O.dz(rb[kk], rt[kk], o);
      db_acc += v;
      Bs[kk * TL::BNP + nn] = rnd<T>(v);
    }
    __syncthreads();
    mac_step<BN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  if (kdim > 0) {
    float* out = J.partial + ((long)mem * P.splits + split) * kdim * P.c_out;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0t + ty * 4 + i;
      if (row >= kdim) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oo = n0 + tx * 4 + j;
        if (oo < P.c_out) out[(long)row * P.c_out + oo] = acc[i][j];
      }
    }
  }
  if (do_db) {
    // the block's column sums in a fixed order: threads nn, nn + BN, ...
    __syncthreads();
    As[tid] = db_acc;
    __syncthreads();
    if (tid < BN && n0 + tid < P.c_out) {
      float s = 0.f;
      for (int q = tid; q < kThreads; q += BN) s += As[q];
      P.pdb[((long)mem * P.splits + split) * P.c_out + n0 + tid] = s;
    }
  }
}

// dW[job][mem][e] = sum over splits of partial (rounded to the working type);
// db[mem][o] = sum over splits of pdb (fp32). grid (blocks, n_jobs + 1).
struct RedP {
  const float* partial[kMaxEdges];
  void* dw[kMaxEdges];
  long size[kMaxEdges];  // k * c_src * c_out
  int n_jobs, members, splits, c_out;
  const float* pdb;
  float* db;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) sg_reduce_kernel(RedP P) {
  const int jb = blockIdx.y;
  const bool bias = jb == P.n_jobs;
  if (bias && P.pdb == nullptr) return;
  const long size = bias ? P.c_out : P.size[jb];
  const float* part = bias ? P.pdb : P.partial[jb];
  const long total = size * P.members;
  for (long e = blockIdx.x * (long)kThreads + threadIdx.x; e < total;
       e += (long)gridDim.x * kThreads) {
    const long mem = e / size, i = e - mem * size;
    const float* p = part + mem * P.splits * size + i;
    float s = 0.f;
    for (int sp = 0; sp < P.splits; ++sp) s += p[sp * size];
    if (bias)
      P.db[e] = s;
    else
      static_cast<T*>(P.dw[jb])[e] = from_f<T>(s);
  }
}

int pick_bn(int cols) {
  return cols >= 64 ? 64 : (cols >= 32 ? 32 : (cols >= 16 ? 16 : 8));
}

unsigned cdiv(long a, long b) { return static_cast<unsigned>((a + b - 1) / b); }

#define DISPATCH(dtype, bn, CALL)                              \
  do {                                                         \
    if ((dtype) == 0) {                                        \
      if ((bn) == 64) return CALL(float, 64);                  \
      if ((bn) == 32) return CALL(float, 32);                  \
      if ((bn) == 16) return CALL(float, 16);                  \
      return CALL(float, 8);                                   \
    }                                                          \
    if ((dtype) == 1) {                                        \
      if ((bn) == 64) return CALL(__nv_bfloat16, 64);          \
      if ((bn) == 32) return CALL(__nv_bfloat16, 32);          \
      if ((bn) == 16) return CALL(__nv_bfloat16, 16);          \
      return CALL(__nv_bfloat16, 8);                           \
    }                                                          \
    return static_cast<int>(cudaErrorInvalidValue);            \
  } while (0)

template <typename T, int BN>
int fwd_launch(const FwdP& P, int members, cudaStream_t st) {
  const dim3 grid(cdiv((long)P.n_per * P.t_out, Tile<BN>::BM), cdiv(P.c_out, BN), members);
  sg_fwd_kernel<T, BN><<<grid, kThreads, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int dx_launch(const DxP& P, int members, int rows_max, int cols_max, cudaStream_t st) {
  const dim3 grid(cdiv((long)P.n_per * rows_max, Tile<BN>::BM), cdiv(cols_max, BN),
                  members * P.n_jobs * P.s_max);
  sg_dx_kernel<T, BN><<<grid, kThreads, 0, st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int dw_launch(const DwP& P, RedP R, int members, int kdim_max, cudaStream_t st) {
  const dim3 grid(P.small ? cdiv((long)(kdim_max + 1) * P.c_out, kThreads)
                          : cdiv(kdim_max > 0 ? kdim_max : 1, Tile<BN>::BM),
                  P.small ? 1 : cdiv(P.c_out, BN), members * P.n_jobs * P.splits);
  sg_dw_kernel<T, BN><<<grid, kThreads, 0, st>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long biggest = P.c_out;
  for (int j = 0; j < R.n_jobs; ++j) biggest = R.size[j] > biggest ? R.size[j] : biggest;
  const unsigned blocks = cdiv(biggest * members, kThreads);
  const dim3 rgrid(blocks < 2048u ? blocks : 2048u, R.n_jobs + 1);
  sg_reduce_kernel<T><<<rgrid, kThreads, 0, st>>>(R);
  return static_cast<int>(cudaGetLastError());
}

// ints of one edge in the host arrays: t_src, c_src, k, s, d, pad
constexpr int kEdgeInts = 6;

bool edge_ok(const int* g) {
  return g[0] > 0 && g[1] > 0 && g[2] > 0 && g[3] > 0 && g[4] > 0 && g[5] >= 0 &&
         (g[3] == 1 || g[4] == 1);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 none, 1 lrelu, 2 tanh, 3 square,
// 4 log1e5. Each returns the cudaError_t of its launches (cudaErrorInvalidValue
// for arguments it does not take). Levels and tables are contiguous in the
// working type; a table is (members, k, c_src, c_out), bias (members, c_out)
// fp32 or null, res a level read with c_out channels (element stride
// res_estride) or null. Batch element b uses member b / n_per.
int hifigan_sg_fwd(int dtype, int n_edges, const void* const* srcs, const void* const* ws,
                   const int* geom, const float* bias, const void* res, int res_estride,
                   void* out, int t_out, int c_out, int act, float slope, int members, int n_per,
                   void* stream) {
  if (n_edges < 0 || n_edges > kMaxEdges || t_out < 1 || c_out < 1 || members < 1 || n_per < 1 ||
      (n_edges == 0 && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdP P{};
  P.n_edges = n_edges;
  for (int e = 0; e < n_edges; ++e) {
    const int* g = geom + e * kEdgeInts;
    if (!edge_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
    P.src[e] = srcs[e];
    P.w[e] = ws[e];
    P.t_src[e] = g[0];
    P.c_src[e] = g[1];
    P.k[e] = g[2];
    P.s[e] = g[3];
    P.d[e] = g[4];
    P.pad[e] = g[5];
  }
  P.bias = bias;
  P.res = res;
  P.res_estride = res_estride;
  P.out = out;
  P.t_out = t_out;
  P.c_out = c_out;
  P.act = act;
  P.slope = slope;
  P.n_per = n_per;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(T, BN) fwd_launch<T, BN>(P, members, st)
  DISPATCH(dtype, pick_bn(c_out), FWD);
#undef FWD
}

// One launch adds every job's contribution into its target's fp32 cotangent.
// Job j: da[j] (B, t_tgt, c_tgt) fp32; jgeom[j] = t_tgt, c_tgt, s, n_edges,
// res; its edges' tables in ws[4*j + e] and egeom[(4*j + e)*3] = k, d, pad.
// da_out is the op's output cotangent (B, t_out, c_out) fp32, y its saved
// output; sq (square only) the residual source, element stride sq_estride.
int hifigan_sg_dx(int dtype, int n_jobs, float* const* da, const int* jgeom,
                  const void* const* ws, const int* egeom, const float* da_out, const void* y,
                  const void* sq, int sq_estride, int t_out, int c_out, int act, float slope,
                  int members, int n_per, void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxEdges || t_out < 1 || c_out < 1 || members < 1 || n_per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DxP P{};
  P.n_jobs = n_jobs;
  P.s_max = 1;
  int rows_max = 1, cols_max = 1;
  for (int j = 0; j < n_jobs; ++j) {
    const int* g = jgeom + j * 5;
    DxJob& J = P.job[j];
    J.da = da[j];
    J.t_tgt = g[0];
    J.c_tgt = g[1];
    J.s = g[2];
    J.n_edges = g[3];
    J.res = g[4];
    if (J.t_tgt < 1 || J.c_tgt < 1 || J.s < 1 || J.n_edges < 0 || J.n_edges > kMaxEdges ||
        (J.n_edges == 0 && !J.res) || (J.res && (J.s != 1 || J.c_tgt != c_out)))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int e = 0; e < J.n_edges; ++e) {
      const int* eg = egeom + (j * kMaxEdges + e) * 3;
      J.w[e] = ws[j * kMaxEdges + e];
      J.k[e] = eg[0];
      J.d[e] = eg[1];
      J.pad[e] = eg[2];
      if (J.k[e] < 1 || J.d[e] < 1 || J.pad[e] < 0 || (J.s > 1 && J.d[e] != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    P.s_max = J.s > P.s_max ? J.s : P.s_max;
    const int rows = (J.t_tgt + J.s - 1) / J.s;  // rows of phase 0, the most of any phase
    rows_max = rows > rows_max ? rows : rows_max;
    cols_max = J.c_tgt > cols_max ? J.c_tgt : cols_max;
  }
  P.n_per = n_per;
  P.da_out = da_out;
  P.y = y;
  P.sq = sq;
  P.sq_estride = sq_estride;
  P.t_out = t_out;
  P.c_out = c_out;
  P.act = act;
  P.slope = slope;
  if (act == kSquare && sq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((long)members * n_jobs * P.s_max > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DX(T, BN) dx_launch<T, BN>(P, members, rows_max, cols_max, st)
  DISPATCH(dtype, pick_bn(cols_max), DX);
#undef DX
}

// Weight and bias gradients of one op. Job j (an edge): src[j] with
// jgeom[j*6] = t_src, c_src, k, s, d, pad; partial[j] (members, splits,
// k*c_src, c_out) fp32 scratch; dw[j] (members, k, c_src, c_out) in the
// working type. pdb (members, splits, c_out) scratch and db (members, c_out)
// fp32, or both null. n_jobs may be 0 when only db is wanted. Split sp sums
// the member's rows m = n*t_out + t in [sp*split_rows, (sp+1)*split_rows).
int hifigan_sg_dw(int dtype, int n_jobs, const void* const* srcs, const int* jgeom,
                  float* const* partial, void* const* dw, float* pdb, float* db,
                  const float* da_out, const void* y, const void* sq, int sq_estride, int t_out,
                  int c_out, int act, float slope, int members, int n_per, int splits,
                  int split_rows, void* stream) {
  if (n_jobs < 0 || n_jobs > kMaxEdges || (n_jobs == 0 && db == nullptr) || t_out < 1 ||
      c_out < 1 || members < 1 || n_per < 1 || splits < 1 || split_rows < 1 ||
      (long)splits * split_rows < (long)n_per * t_out || (db == nullptr) != (pdb == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DwP P{};
  RedP R{};
  P.n_jobs = n_jobs > 0 ? n_jobs : 1;
  int kdim_max = 0;
  for (int j = 0; j < n_jobs; ++j) {
    const int* g = jgeom + j * kEdgeInts;
    if (!edge_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
    DwJob& J = P.job[j];
    J.src = srcs[j];
    J.partial = partial[j];
    J.t_src = g[0];
    J.c_src = g[1];
    J.k = g[2];
    J.s = g[3];
    J.d = g[4];
    J.pad = g[5];
    const int kdim = J.k * J.c_src;
    kdim_max = kdim > kdim_max ? kdim : kdim_max;
    R.partial[j] = partial[j];
    R.dw[j] = dw[j];
    R.size[j] = (long)kdim * c_out;
  }
  P.n_per = n_per;
  P.splits = splits;
  P.split_rows = split_rows;
  P.small = (long)(kdim_max + 1) * c_out <= kSmallOut;
  P.pdb = pdb;
  P.da_out = da_out;
  P.y = y;
  P.sq = sq;
  P.sq_estride = sq_estride;
  P.t_out = t_out;
  P.c_out = c_out;
  P.act = act;
  P.slope = slope;
  R.n_jobs = n_jobs;
  R.members = members;
  R.splits = splits;
  R.c_out = c_out;
  R.pdb = pdb;
  R.db = db;
  if (act == kSquare && sq == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if ((long)members * P.n_jobs * splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DW(T, BN) dw_launch<T, BN>(P, R, members, kdim_max, st)
  DISPATCH(dtype, pick_bn(c_out), DW);
#undef DW
}

}  // extern "C"
