// One implicit-GEMM conv1d core on the tensor cores for Hopper (sm_90a),
// shared by csrc/conv_stack.cu (the MSD conv stack, forward, dx, dW) and
// csrc/msd_conv.cu (one conv + bias + leaky ReLU, forward and dx).
//
// Layouts: activations channels-last (N, T, C); weights (K, C_in/groups,
// C_out), the JAX layout, read as a (K*ci_g, C_out) matrix; dx reads them
// transposed, (K, C_out, ci_g), which its wrapper prepares. g is the group
// of an output column; ci_g, co_g the channels of one group.
//
//   forward  y[n,t,c]  = act(b[c] + sum_{k,i} x[n, t*s + k*d - pad, g*ci_g+i] * W[k,i,c])
//   dx       dx[n,u,i] = sum_{k,o: t*s + k*d - pad = u} dz[n,t,g*co_g+o] * W[k,i,g*co_g+o]
//   dW       dW[k,i,c] = sum_{n,t} x[n, t*s + k*d - pad, g*ci_g+i] * dz[n,t,c]
//
// Precision. bf16: mma.sync.m16n8k16 with bf16 operands and fp32
// accumulators (the products are exact; only the order of the sum moves).
// fp32: 3xTF32 on mma.sync.m16n8k8: each operand is split once, as its
// fragment is loaded from shared memory, into hi = rna_tf32(a) and
// lo = rna_tf32(a - hi), and the accumulator takes lo*hi + hi*lo + hi*hi,
// which keeps fp32-class error where one TF32 product would not.
//
// Tiles. A 256-thread block owns BM output rows x BN output columns of one
// group (BM 64 or 128, BN 16, 32 or 64; 8 warps in WARPS_M x WARPS_N).
// - Forward and dx stage the input WINDOW their rows need once, for a
//   chunk of up to 64 (fp32) or 128 (bf16) reduction channels, and read
//   every tap's operand from it by a row offset: a window row is loaded
//   once, not once a tap.
//   Rows are "virtual": row m = (n, t) of the output starts at
//   v(m) = n * Lv + t * S (Lv = rows * S + E, E a multiple of S covering the
//   receptive field), so a tile may run across two batch rows. With a
//   stride S > 1 the window is stored as S planes (virtual row mod S), so a
//   tap reads consecutive rows of one plane; planes no tap reads are not
//   staged. Zero padding, channels past the group and rows past the batch
//   are zeros in the window.
// - The weights stream through a 3-stage cp.async ring of WK reduction
//   rows, so copies overlap the mma; a second window buffer takes the next
//   channel chunk while the last one is in use.
// - dx runs per output phase: rows u of phase (u + pad) mod s meet only the
//   taps k0 + s*q, a dense (q, o) reduction over a stride-1 window of dz.
// - dW: M = (tap, channel) rows, N = co_g columns, reduced over (n, t) in
//   chunks of kDwRows rows, each chunk's x window and dz rows a ring stage;
//   splits of (n, t) write fp32 partials that a second kernel sums in a
//   fixed order (no float atomics).
// - fp32 sums each ring stage into a zeroed partial and adds it to the
//   accumulator with IEEE adds (see promote()).
// - Narrow edges (one input or output channel per group, or a reduction
//   shorter than one mma k-step) take a SIMT kernel, 1 or 32 threads an
//   output, chosen by the host planner.
// Every shared-memory size is computed by the same formula here and in
// ops/conv_stack.py::plan_conv; an entry point refuses any other value.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_core {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kDwRows = 64;  // dW: reduction rows (n, t) a ring stage
constexpr int kSmemLimit = 232448;  // shared memory one block may use (227 KB)

template <typename T> struct Prec;
template <> struct Prec<float> {
  static constexpr int KSTEP = 8, WK = 32;  // mma k-step; weight-ring rows a stage
};
template <> struct Prec<bf16> {
  static constexpr int KSTEP = 16, WK = 64;
};

struct Geom {
  int n, t_in, c_in, t_out, c_out, k, s, d, groups, pad_l;
  int ci_g, co_g;
  float slope;
  // a partial last row (group time-fold): with lane_period > 0 the last
  // output row of every element keeps only channels c with
  // c % lane_period < lane_valid; the forward stores zeros in the others
  int lane_period = 0, lane_valid = 0;
};

inline Geom make_geom(int n, int t_in, int c_in, int t_out, int c_out, int k, int s, int d,
                      int groups, int pad_l, float slope) {
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

inline bool geom_ok(const Geom& G) {
  return G.n > 0 && G.t_in > 0 && G.t_out > 0 && G.k > 0 && G.s > 0 && G.d > 0 &&
         (G.s == 1 || G.d == 1) && G.groups > 0 && G.pad_l >= 0 && G.c_in % G.groups == 0 &&
         G.c_out % G.groups == 0 && G.ci_g > 0 && G.co_g > 0 && G.lane_valid >= 0 &&
         G.lane_valid <= G.lane_period &&
         (long)(G.t_out - 1) * G.s + (long)(G.k - 1) * G.d - G.pad_l < (1L << 30) &&
         (long)G.n * ((long)G.t_out * G.s + (long)G.k * G.d + G.t_in) < (1L << 30);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int round8(int v) { return (v + 7) & ~7; }
// whether output (row m = n * t_out + t, channel c) is a fold-padding lane
// of a partial last row, which the forward zeroes
__host__ __device__ inline bool lane_cut(const Geom& G, long m, int c) {
  return G.lane_period > 0 && m % G.t_out == G.t_out - 1 && c % G.lane_period >= G.lane_valid;
}
// v (a multiple of 8) padded to 8 mod 16 elements: conflict-free ldmatrix
// rows in bf16, and conflict-free (k, n) fragment reads in fp32
__host__ __device__ inline int pad816(int v) { return v % 16 == 0 ? v + 8 : v + 16; }
// the receptive field's extra virtual rows, a multiple of the step S
__host__ __device__ inline int extra_rows(int k, int s, int d) {
  const int e = imax((k - 1) * d + 1 - s, 0);
  return cdiv(e, s) * s;
}

// ---------------------------------------------------------------------------
// Plans (host and device compute the same numbers)
// ---------------------------------------------------------------------------
struct WinPlan {
  int S, E, ntaps, rows, ch, kc, chunks, nb, wr, npl, pr, p, win, wb, groups8, smem;
};

// A chunk width the window ring takes: a multiple of 8 up to 64 (fp32) or
// 128 (bf16), and with several chunks every block's chunk spans two ring
// stages or more (the next chunk's window is issued two stages ahead into
// the other buffer).
__host__ __device__ inline bool kc_ok(const Geom& G, bool dx, bool f32, int kc) {
  const int kcmax = f32 ? 64 : 128, wk = f32 ? 32 : 64;
  const int ch = dx ? G.co_g : G.ci_g;
  const int taps = dx ? (G.s == 1 ? G.k : 1) : G.k;  // a dx phase may meet one tap
  return kc >= 8 && kc % 8 == 0 && kc <= kcmax && kc <= round8(ch) &&
         (cdiv(ch, kc) == 1 || taps * kc > wk);
}

// Forward (dx = false) or dx (dx = true) with a BM x BN tile and reduction
// channel chunks of kc. dx sizes for its widest phase: ceil(k / s) taps, at
// least floor(t_in / s) rows a batch row.
__host__ __device__ inline WinPlan win_plan(const Geom& G, bool dx, bool f32, int bm, int bn,
                                            int kc) {
  WinPlan P;
  const int wk = f32 ? 32 : 64, esize = f32 ? 4 : 2;
  if (!dx) {
    P.S = G.s;
    P.ch = G.ci_g;
    P.ntaps = G.k;
    P.E = extra_rows(G.k, G.s, G.d);
    P.rows = G.t_out;
  } else {
    P.S = 1;
    P.ch = G.co_g;
    P.ntaps = cdiv(G.k, G.s);
    P.E = (P.ntaps - 1) * G.d;
    P.rows = imax(1, G.t_in / G.s);
  }
  P.kc = kc;
  P.chunks = cdiv(P.ch, P.kc);
  P.nb = imin(G.n - 1, cdiv(bm - 1, P.rows));
  P.wr = (bm - 1) * P.S + P.nb * P.E + (P.ntaps - 1) * G.d + 1;
  P.npl = P.S == 1 ? 1 : imin(P.S, P.ntaps);
  P.pr = cdiv(P.wr, P.S);
  P.p = f32 ? P.kc + 4 : pad816(P.kc);
  P.win = round8(P.npl * P.pr * P.p);
  P.wb = P.chunks == 1 ? 1 : 2;
  P.groups8 = P.ntaps * P.kc / 8;
  P.smem = round8(P.groups8 + 1) * 4 + (P.wb * P.win + kStages * wk * pad816(bn)) * esize;
  return P;
}

struct DwPlan {
  int kc, nt, ntt, chunks, mtiles, S, E, bkt, nb, wr, npl, pr, p, win, stage, smem;
};

// dW with a 128 x BN tile of (tap, channel) rows x output columns; kc (a
// power of two, 8 to 128) channels of a tap per tile row group
__host__ __device__ inline DwPlan dw_plan(const Geom& G, bool f32, int bn, int kc) {
  DwPlan P;
  const int esize = f32 ? 4 : 2;
  P.kc = kc;
  P.nt = 128 / P.kc;
  P.ntt = cdiv(G.k, P.nt);
  P.chunks = cdiv(G.ci_g, P.kc);
  P.mtiles = P.chunks * P.ntt;
  P.S = G.s;
  P.E = extra_rows(G.k, G.s, G.d);
  P.bkt = kDwRows;
  P.nb = imin(G.n - 1, cdiv(P.bkt - 1, G.t_out));
  const int taps = imin(P.nt, G.k);
  P.wr = (P.bkt - 1) * P.S + P.nb * P.E + (taps - 1) * G.d + 1;
  P.npl = P.S == 1 ? 1 : imin(P.S, taps);
  P.pr = cdiv(P.wr, P.S);
  P.p = pad816(P.kc);
  P.win = round8(P.npl * P.pr * P.p);
  P.stage = P.win + P.bkt * pad816(bn);
  P.smem = kStages * P.stage * esize + kStages * P.bkt * 4;
  return P;
}

// ---------------------------------------------------------------------------
// Division by a divisor fixed for a block: a multiply-high and a shift
// (n >= 0 below 2^31), for the staging loops' per-element index arithmetic
// ---------------------------------------------------------------------------
struct FastDiv {
  int d;
  uint32_t mul, shr;
  __device__ explicit FastDiv(int div) : d(div), mul(0), shr(0) {
    if (div > 1) {
      const uint32_t l = 32 - __clz(div - 1);  // ceil(log2 div)
      mul = static_cast<uint32_t>(((1ull << (31 + l)) + div - 1) / div);
      shr = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >> shr);
  }
};

// ---------------------------------------------------------------------------
// Element helpers and PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte copy; src_bytes < 16 zero-fills the rest (0: all zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
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
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// Warp tiling
// ---------------------------------------------------------------------------
template <int BM, int BN>
struct Warps {
  static constexpr int WARPS_M = (BN / (8 / (BM / 32)) >= 16) ? BM / 32 : BM / 16;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WARPS_M * WARPS_N == 8 && MT >= 1 && NT % 2 == 0, "unsupported tile");
};

// ---------------------------------------------------------------------------
// Staging: every copy is 16 bytes by cp.async where the rows are 16-byte
// aligned, else element by element (synchronous stores into the same slot)
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src, const T* any, int valid,
                                           bool aligned) {
  constexpr int VE = 16 / sizeof(T);
  if (aligned) {
    const int nv = valid <= 0 ? 0 : (valid >= VE ? VE : valid);
    cp_async16(dst, nv > 0 ? static_cast<const void*>(src) : static_cast<const void*>(any),
               nv * static_cast<int>(sizeof(T)));
  } else {
#pragma unroll
    for (int e = 0; e < VE; ++e) dst[e] = e < valid ? src[e] : from_f<T>(0.f);
  }
}

// The window of virtual rows [v0, v0 + wr): row w of batch row n = w / Lv
// reads source row (w mod Lv) + shift of channels [ch0, ch0 + valid) of a
// (n_batch, t_src, c_src) tensor, kc channels wide (zeros past valid and
// outside the source). Local row l goes to plane l mod S, index l / S;
// planes >= npl are not staged. vpr divides by kc / VE, S by S, Lv by Lv.
template <typename T>
__device__ void stage_window(T* dst, int p, int pr, const FastDiv& S, int npl, int wr, int v0,
                             const FastDiv& Lv, int shift, const T* src, int n_batch, int t_src,
                             int c_src, int ch0, int valid, const FastDiv& vpr, bool aligned) {
  constexpr int VE = 16 / sizeof(T);
  for (int e = threadIdx.x; e < wr * vpr.d; e += kThreads) {
    const int l = vpr.div(e), vi = e - l * vpr.d;
    const int li = S.div(l), plane = l - li * S.d;
    if (plane >= npl) continue;
    const int w = v0 + l;
    const int nb = Lv.div(w), row = w - nb * Lv.d + shift;
    const bool ok = nb < n_batch && row >= 0 && row < t_src;
    const T* s = src + ((long)nb * t_src + row) * c_src + ch0 + vi * VE;
    copy_piece<T>(dst + (plane * pr + li) * p + vi * VE, s, src, ok ? valid - vi * VE : 0,
                  aligned);
  }
}

// A (rows x BN) ring tile: row r's columns start at row_ptr(r); rows with
// row_ok(r) false and columns past valid_cols are zeros.
template <typename T, int BN, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, int pb, int rows, RowFn row_src,
                                           const T* any, int valid_cols, bool aligned) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int VPR = BN / VE;
  for (int e = threadIdx.x; e < rows * VPR; e += kThreads) {
    const int r = e / VPR, vi = e - r * VPR;
    const T* s = row_src(r);
    copy_piece<T>(dst + r * pb + vi * VE, s == nullptr ? any : s + vi * VE, any,
                  s == nullptr ? 0 : valid_cols - vi * VE, aligned);
  }
}

// ---------------------------------------------------------------------------
// Fragment products of one ring stage
// ---------------------------------------------------------------------------
// B fragments of k-step kk from a row-major (k, n) stage, split as loaded
template <int NT>
__device__ __forceinline__ void b_frags_f32(uint32_t (&bh)[NT][2], uint32_t (&bl)[NT][2],
                                            const float* B, int pb, int kk, int wn0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(B[(kk + t) * pb + wn0 + j * 8 + g], bh[j][0], bl[j][0]);
    split_tf32(B[(kk + t + 4) * pb + wn0 + j * 8 + g], bh[j][1], bl[j][1]);
  }
}
template <int NT>
__device__ __forceinline__ void b_frags_bf16(uint32_t (&bf)[NT / 2][4], const bf16* B, int pb,
                                             int kk, int wn0, int lane) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
    ldsm_x4_t(bf[np], B + (kk + (lane & 15)) * pb + wn0 + np * 16 + (lane >> 4) * 8);
}
template <int MT, int NT>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4], const uint32_t (&ah)[MT][4],
                                     const uint32_t (&al)[MT][4], const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
      mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
      mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
    }
}
// The tensor cores' fp32 accumulation inside an mma is not rounded to
// nearest, and its bias grows with the number of mma steps a sum takes. The
// fp32 bodies therefore sum each ring stage into a zeroed partial and add
// the partials into the accumulator with IEEE adds.
template <int MT, int NT>
__device__ __forceinline__ void zero(float (&a)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) a[i][j][v] = 0.f;
}
template <int MT, int NT>
__device__ __forceinline__ void promote(float (&acc)[MT][NT][4], const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
}
template <int MT, int NT>
__device__ __forceinline__ void mma_b(float (&acc)[MT][NT][4], const uint32_t (&af)[MT][4],
                                      const uint32_t (&bf)[NT / 2][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);
}

// Forward / dx stage: A[m][k] = win[rowA(m) + goff(k / 8) + k % 8], the
// k-steps of ring rows [0, steps * KSTEP) against the (k, n) slot B. fp32
// operands are split into hi and lo once, as their fragment is loaded.
template <int BM, int BN>
__device__ __forceinline__ void tap_stage(float (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4],
                                          const float* win, const int* goff, int steps,
                                          const float* B, int pb,
                                          const int (&rowA)[Warps<BM, BN>::MT][2], int wn0,
                                          int lane) {
  using W = Warps<BM, BN>;
  const int t = lane & 3;
  float part[W::MT][W::NT][4];
  zero<W::MT, W::NT>(part);
#pragma unroll
  for (int ks = 0; ks < Prec<float>::WK / 8; ++ks) {
    if (ks >= steps) break;
    const int go = goff[ks] + t;
    uint32_t ah[W::MT][4], al[W::MT][4];
#pragma unroll
    for (int i = 0; i < W::MT; ++i) {
      split_tf32(win[rowA[i][0] + go], ah[i][0], al[i][0]);
      split_tf32(win[rowA[i][1] + go], ah[i][1], al[i][1]);
      split_tf32(win[rowA[i][0] + go + 4], ah[i][2], al[i][2]);
      split_tf32(win[rowA[i][1] + go + 4], ah[i][3], al[i][3]);
    }
    uint32_t bh[W::NT][2], bl[W::NT][2];
    b_frags_f32<W::NT>(bh, bl, B, pb, ks * 8, wn0, lane);
    mma3<W::MT, W::NT>(part, ah, al, bh, bl);
  }
  promote<W::MT, W::NT>(acc, part);
}
template <int BM, int BN>
__device__ __forceinline__ void tap_stage(float (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4],
                                          const bf16* win, const int* goff, int steps,
                                          const bf16* B, int pb,
                                          const int (&rowA)[Warps<BM, BN>::MT][2], int wn0,
                                          int lane) {
  using W = Warps<BM, BN>;
#pragma unroll
  for (int ks = 0; ks < Prec<bf16>::WK / 16; ++ks) {
    if (ks >= steps) break;
    const int go = goff[2 * ks + (lane >> 4)];
    uint32_t af[W::MT][4];
#pragma unroll
    for (int i = 0; i < W::MT; ++i) ldsm_x4(af[i], win + rowA[i][0] + go);
    uint32_t bf[W::NT / 2][4];
    b_frags_bf16<W::NT>(bf, B, pb, ks * 16, wn0, lane);
    mma_b<W::MT, W::NT>(acc, af, bf);
  }
}

// dW stage: A[m][k] = win[roff[k] * p + goffm(m / 8) + m % 8], k over the
// stage's kDwRows reduction rows.
template <int BN>
__device__ __forceinline__ void dw_stage(float (&acc)[Warps<128, BN>::MT][Warps<128, BN>::NT][4],
                                         const float* win, const int* roff, int p,
                                         const float* B, int pb,
                                         const int (&goffm)[Warps<128, BN>::MT][2], int wn0,
                                         int lane) {
  using W = Warps<128, BN>;
  const int g = lane >> 2, t = lane & 3;
  float part[W::MT][W::NT][4];
  zero<W::MT, W::NT>(part);
#pragma unroll
  for (int kk = 0; kk < kDwRows; kk += 8) {
    const int ra = roff[kk + t] * p + g, rb = roff[kk + t + 4] * p + g;
    uint32_t ah[W::MT][4], al[W::MT][4];
#pragma unroll
    for (int i = 0; i < W::MT; ++i) {
      split_tf32(win[ra + goffm[i][0]], ah[i][0], al[i][0]);
      split_tf32(win[ra + goffm[i][1]], ah[i][1], al[i][1]);
      split_tf32(win[rb + goffm[i][0]], ah[i][2], al[i][2]);
      split_tf32(win[rb + goffm[i][1]], ah[i][3], al[i][3]);
    }
    uint32_t bh[W::NT][2], bl[W::NT][2];
    b_frags_f32<W::NT>(bh, bl, B, pb, kk, wn0, lane);
    mma3<W::MT, W::NT>(part, ah, al, bh, bl);
  }
  promote<W::MT, W::NT>(acc, part);
}
template <int BN>
__device__ __forceinline__ void dw_stage(float (&acc)[Warps<128, BN>::MT][Warps<128, BN>::NT][4],
                                         const bf16* win, const int* roff, int p,
                                         const bf16* B, int pb,
                                         const int (&goffm)[Warps<128, BN>::MT][2], int wn0,
                                         int lane) {
  using W = Warps<128, BN>;
  const int jj = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kDwRows; kk += 16) {
    const int krow = kk + (jj >> 1) * 8 + r;
    const int base = roff[krow] * p;
    uint32_t af[W::MT][4];
#pragma unroll
    for (int i = 0; i < W::MT; ++i) ldsm_x4_t(af[i], win + base + goffm[i][jj & 1]);
    uint32_t bf[W::NT / 2][4];
    b_frags_bf16<W::NT>(bf, B, pb, kk, wn0, lane);
    mma_b<W::MT, W::NT>(acc, af, bf);
  }
}

// The output element (i, j, v) of a warp's fragments: row and column in the tile
template <int BM, int BN>
__device__ __forceinline__ int frag_row(int i, int v) {
  using W = Warps<BM, BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / W::WARPS_N) * W::WM + i * 16 + (lane >> 2) + (v / 2) * 8;
}
template <int BM, int BN>
__device__ __forceinline__ int frag_col(int j, int v) {
  using W = Warps<BM, BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % W::WARPS_N) * W::WN + j * 8 + (lane & 3) * 2 + (v % 2);
}

// ---------------------------------------------------------------------------
// Forward and dx: one windowed conv over taps
// ---------------------------------------------------------------------------
struct TapArgs {
  // the window's source: (n, t_src, c_src), the group's channels from ch_base
  const void* src;
  int t_src, c_src, ch_base;
  int rows;   // output rows per batch row
  int M;      // n * rows
  int Lv, shift;
  int ntaps;  // taps of this block (dx: its phase's)
  int tap_dir;  // +1: tap q reads row offset q*d (forward); -1: (ntaps-1-q)*d (dx)
  // the weights: B row (tap q, channel ch) = w + ((tap_base + tap_step*q) * rows_per_tap
  // + row_off + ch) * ld + col0, columns < valid_cols
  const void* w;
  int tap_base, tap_step, rows_per_tap, row_off, ld, col0, valid_cols;
  bool a_aligned, b_aligned;
};

// acc <- the BM x BN tile at output rows [m0, m0 + BM) (rows past M read
// a valid window row and are dropped by the caller).
template <typename T, int BM, int BN>
__device__ void tap_conv(float (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4], const Geom& G,
                         const WinPlan& P, const TapArgs& a, int m0, unsigned char* smem) {
  using W = Warps<BM, BN>;
  constexpr int WK = Prec<T>::WK, KSTEP = Prec<T>::KSTEP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / W::WARPS_N) * W::WM, wn0 = (warp % W::WARPS_N) * W::WN;
  const int pb = pad816(BN);
  int* goff = reinterpret_cast<int*>(smem);
  T* win0 = reinterpret_cast<T*>(smem + round8(P.groups8 + 1) * 4);
  T* ring = win0 + P.wb * P.win;
  const T* src = static_cast<const T*>(a.src);
  const T* w = static_cast<const T*>(a.w);

  zero<W::MT, W::NT>(acc);

  // (tap, 8 channels) group -> element offset in the window; past the end: 0
  const int g8 = a.ntaps * P.kc / 8;
  for (int e = threadIdx.x; e < round8(P.groups8 + 1); e += kThreads) {
    int off = 0;
    if (e < g8) {
      const int q = (e * 8) / P.kc, ch0 = e * 8 - q * P.kc;
      const int tap = (a.tap_dir > 0 ? q : a.ntaps - 1 - q) * G.d;
      off = ((tap % P.S) * P.pr + tap / P.S) * P.p + ch0;
    }
    goff[e] = off;
  }
  // window row (element offset) of each of this thread's fragment rows
  const int nb0 = m0 / a.rows, v0 = nb0 * a.Lv + (m0 - nb0 * a.rows) * P.S;
  // the window rows the tile reads: past a batch boundary only if it crosses one
  const int mlast = imin(m0 + BM, a.M) - 1, nbl = mlast / a.rows;
  const int wr = imin(P.wr, nbl * a.Lv + (mlast - nbl * a.rows) * P.S - v0 +
                                (a.ntaps - 1) * G.d + 1);
  const int estep = P.E / P.S;
  int rowA[W::MT][2];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sizeof(T) == 4 ? wm0 + i * 16 + (lane >> 2) + h * 8 : wm0 + i * 16 + (lane & 15);
      const int m = m0 + r;
      rowA[i][h] = m < a.M ? (r + (m / a.rows - nb0) * estep) * P.p : 0;
    }

  const int span = a.ntaps * P.kc;
  const int sub = cdiv(span, WK);
  const int nq = P.chunks * sub;
  const FastDiv fS(P.S), fLv(a.Lv), fvpr(P.kc / (16 / static_cast<int>(sizeof(T)))), fkc(P.kc);
  auto issue = [&](int q) {
    if (q < nq) {
      const int c = q / sub, j = q - c * sub;
      const int ch0 = c * P.kc;
      if (j == 0)
        stage_window<T>(win0 + (c % P.wb) * P.win, P.p, P.pr, fS, P.npl, wr, v0, fLv, a.shift,
                        src, G.n, a.t_src, a.c_src, a.ch_base + ch0, imin(P.kc, P.ch - ch0), fvpr,
                        a.a_aligned);
      const int r0 = j * WK;
      stage_rows<T, BN>(
          ring + (q % kStages) * WK * pb, pb, WK,
          [&](int r) -> const T* {
            const int rr = r0 + r;
            const int tq = fkc.div(rr), ch = ch0 + rr - tq * P.kc;
            if (tq >= a.ntaps || ch >= P.ch) return nullptr;
            return w + ((long)(a.tap_base + a.tap_step * tq) * a.rows_per_tap + a.row_off + ch) *
                           a.ld + a.col0;
          },
          w, a.valid_cols, a.b_aligned);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage q landed for all; the slot of q - 1 is free
    issue(q + kStages - 1);
    const int c = q / sub, j = q - c * sub;
    const int rem = span - j * WK;
    const int steps = cdiv(rem < WK ? rem : WK, KSTEP);
    tap_stage<BM, BN>(acc, win0 + (c % P.wb) * P.win, goff + j * WK / 8, steps,
                      ring + (q % kStages) * WK * pb, pb, rowA, wn0, lane);
  }
  cp_async_wait<0>();
}

// Forward: grid (ceil(n * t_out / BM), ceil(co_g / BN), groups)
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(Geom G, int kc, const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  using W = Warps<BM, BN>;
  const WinPlan P = win_plan(G, false, sizeof(T) == 4, BM, BN, kc);
  const int grp = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  constexpr int VE = 16 / sizeof(T);
  TapArgs a;
  a.src = x;
  a.t_src = G.t_in;
  a.c_src = G.c_in;
  a.ch_base = grp * G.ci_g;
  a.rows = G.t_out;
  a.M = G.n * G.t_out;
  a.Lv = G.t_out * P.S + P.E;
  a.shift = -G.pad_l;
  a.ntaps = G.k;
  a.tap_dir = 1;
  a.w = w;
  a.tap_base = 0;
  a.tap_step = 1;
  a.rows_per_tap = G.ci_g;
  a.row_off = 0;
  a.ld = G.c_out;
  a.col0 = grp * G.co_g + n0;
  a.valid_cols = G.co_g - n0;
  a.a_aligned = G.c_in % VE == 0 && G.ci_g % VE == 0;
  a.b_aligned = G.c_out % VE == 0 && G.co_g % VE == 0;
  float acc[W::MT][W::NT][4];
  tap_conv<T, BM, BN>(acc, G, P, a, m0, smem);
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + frag_row<BM, BN>(i, v), o = n0 + frag_col<BM, BN>(j, v);
        if (m >= a.M || o >= G.co_g) continue;
        const int c = grp * G.co_g + o;
        const float z = acc[i][j][v] + (bias != nullptr ? bias[c] : 0.f);
        const float act = lane_cut(G, m, c) ? 0.f : fmaxf(z, 0.f) + G.slope * fminf(z, 0.f);
        y[(long)m * G.c_out + c] = from_f<T>(act);
      }
}

// dx from a formed dz (n, t_out, c_out) and the transposed weights
// wt (k, c_out, ci_g): grid (ceil(n * ceil(t_in / s) / BM), ceil(ci_g / BN),
// groups * s). Rows u = ph + s*j of phase ph meet taps k0 + s*q, k0 =
// (ph + pad) mod s, at dz rows j + (ph + pad - k0) / s - q*d.
template <typename T, typename OutT, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(Geom G, int kc, const T* __restrict__ dz, const T* __restrict__ wt,
              OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  using W = Warps<BM, BN>;
  const WinPlan P = win_plan(G, true, sizeof(T) == 4, BM, BN, kc);
  const int grp = blockIdx.z / G.s, ph = blockIdx.z % G.s;
  const int J = ph < G.t_in ? (G.t_in - ph + G.s - 1) / G.s : 0;
  const int M = G.n * J;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= M) return;
  const int k0 = (ph + G.pad_l) % G.s;
  const int nq = G.k > k0 ? (G.k - k0 + G.s - 1) / G.s : 0;
  float acc[W::MT][W::NT][4];
  if (nq > 0) {
    constexpr int VE = 16 / sizeof(T);
    TapArgs a;
    a.src = dz;
    a.t_src = G.t_out;
    a.c_src = G.c_out;
    a.ch_base = grp * G.co_g;
    a.rows = J;
    a.M = M;
    a.Lv = J + P.E;
    a.shift = (ph + G.pad_l - k0) / G.s - (nq - 1) * G.d;
    a.ntaps = nq;
    a.tap_dir = -1;
    a.w = wt;
    a.tap_base = k0;
    a.tap_step = G.s;
    a.rows_per_tap = G.c_out;
    a.row_off = grp * G.co_g;
    a.ld = G.ci_g;
    a.col0 = n0;
    a.valid_cols = G.ci_g - n0;
    a.a_aligned = G.c_out % VE == 0 && G.co_g % VE == 0;
    a.b_aligned = G.ci_g % VE == 0;
    tap_conv<T, BM, BN>(acc, G, P, a, m0, smem);
  } else {
    zero<W::MT, W::NT>(acc);  // a phase that meets no tap
  }
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + frag_row<BM, BN>(i, v), ci = n0 + frag_col<BM, BN>(j, v);
        if (m >= M || ci >= G.ci_g) continue;
        const int nb = m / J;
        const long row = (long)nb * G.t_in + ph + (long)G.s * (m - nb * J);
        out[row * G.c_in + grp * G.ci_g + ci] = from_f<OutT>(acc[i][j][v]);
      }
}

// ---------------------------------------------------------------------------
// dW partials: grid (mtiles, ceil(co_g / BN), groups * splits). Block
// (chunk, tap tile) x columns sums over reduction rows m = (n, t) of its
// split and writes partial[split][tap * ci_g + i][g * co_g + o].
// ---------------------------------------------------------------------------
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(Geom G, const T* __restrict__ x, const T* __restrict__ dz, int kc, int split_rows,
              float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  using W = Warps<128, BN>;
  constexpr int VE = 16 / sizeof(T);
  const DwPlan P = dw_plan(G, sizeof(T) == 4, BN, kc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / W::WARPS_N) * W::WM, wn0 = (warp % W::WARPS_N) * W::WN;
  const int grp = blockIdx.z % G.groups, split = blockIdx.z / G.groups;
  const int chunk = blockIdx.x / P.ntt, tap0 = (blockIdx.x - chunk * P.ntt) * P.nt;
  const int ch0 = chunk * P.kc, n0 = blockIdx.y * BN;
  const int M = G.n * G.t_out;
  const int mb = split * split_rows, me = imin(M, mb + split_rows);
  const int pb = pad816(BN);
  const int Lv = G.t_out * P.S + P.E, estep = P.E / P.S;
  T* stages = reinterpret_cast<T*>(smem);
  int* roffs = reinterpret_cast<int*>(smem + kStages * P.stage * sizeof(T));
  const bool xa = G.c_in % VE == 0 && G.ci_g % VE == 0;
  const bool za = G.c_out % VE == 0 && G.co_g % VE == 0;

  // window offset of each fragment row group (tap0 + tap, 8 channels)
  int goffm[W::MT][2];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mrow = wm0 + i * 16 + h * 8;
      int tq = mrow / P.kc;
      const int c8 = mrow - tq * P.kc;
      if (tap0 + tq >= G.k) tq = 0;
      const int off = tq * G.d;
      goffm[i][h] = ((off % P.S) * P.pr + off / P.S) * P.p + c8;
    }
  float acc[W::MT][W::NT][4];
  zero<W::MT, W::NT>(acc);

  const int nq = me > mb ? cdiv(me - mb, P.bkt) : 0;
  const FastDiv fS(P.S), fLv(Lv), fvpr(P.kc / VE), ft(G.t_out);
  auto issue = [&](int q) {
    if (q < nq) {
      const int mc = mb + q * P.bkt;
      T* st = stages + (q % kStages) * P.stage;
      int* roff = roffs + (q % kStages) * P.bkt;
      const int nbc = ft.div(mc);
      const int vc = nbc * Lv + (mc - nbc * G.t_out) * P.S;
      for (int r = threadIdx.x; r < P.bkt; r += kThreads) {
        const int m = mc + r;
        roff[r] = m < me ? r + (ft.div(m) - nbc) * estep : 0;
      }
      const int mlast = imin(mc + P.bkt, me) - 1, nbl = ft.div(mlast);
      const int wr = imin(P.wr, nbl * Lv + (mlast - nbl * G.t_out) * P.S - vc +
                                    (imin(P.nt, G.k - tap0) - 1) * G.d + 1);
      stage_window<T>(st, P.p, P.pr, fS, P.npl, wr, vc + tap0 * G.d, fLv, -G.pad_l, x, G.n,
                      G.t_in, G.c_in, grp * G.ci_g + ch0, imin(P.kc, G.ci_g - ch0), fvpr, xa);
      stage_rows<T, BN>(
          st + P.win, pb, P.bkt,
          [&](int r) -> const T* {
            const int m = mc + r;
            return m < me ? dz + (long)m * G.c_out + grp * G.co_g + n0 : nullptr;
          },
          dz, G.co_g - n0, za);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(q + kStages - 1);
    const T* st = stages + (q % kStages) * P.stage;
    dw_stage<BN>(acc, st, roffs + (q % kStages) * P.bkt, P.p, st + P.win, pb, goffm, wn0, lane);
  }
  cp_async_wait<0>();

  const int kdim = G.k * G.ci_g;
  float* outp = partial + (long)split * kdim * G.c_out;
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int mrow = frag_row<128, BN>(i, v), o = n0 + frag_col<128, BN>(j, v);
        const int tq = mrow / P.kc, tap = tap0 + tq, ci = ch0 + mrow - tq * P.kc;
        if (tap >= G.k || ci >= G.ci_g || o >= G.co_g) continue;
        outp[((long)tap * G.ci_g + ci) * G.c_out + grp * G.co_g + o] = acc[i][j][v];
      }
}

// dW[e] = sum over splits of partial[split][e] in split order (rounded to
// the working type; partial null: none), db[c] = sum over row blocks of
// pdb[rb][c] in order (fp32).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ partial, int splits, long wsize, T* __restrict__ dw,
                  const float* __restrict__ pdb, int nrb, int c_out, float* __restrict__ db) {
  const long wn = partial != nullptr ? wsize : 0;
  for (long e = blockIdx.x * (long)kThreads + threadIdx.x; e < wn + c_out;
       e += (long)gridDim.x * kThreads) {
    float s = 0.f;
    if (e < wn) {
      for (int sp = 0; sp < splits; ++sp) s += partial[sp * wsize + e];
      dw[e] = from_f<T>(s);
    } else {
      const long c = e - wn;
      for (int rb = 0; rb < nrb; ++rb) s += pdb[rb * (long)c_out + c];
      db[c] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Narrow edges: `lanes` (1 or 32) threads an output, a fixed-order
// butterfly across them
// ---------------------------------------------------------------------------
__device__ __forceinline__ float lanes_sum(float s, int lanes) {
  if (lanes > 1)
    for (int off = lanes / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    simt_fwd_kernel(Geom G, const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y, int lanes) {
  const long gid = blockIdx.x * (long)kThreads + threadIdx.x;
  const long out = gid / lanes;
  const int lane = static_cast<int>(gid - out * lanes);
  const long total = (long)G.n * G.t_out * G.c_out;
  float s = 0.f;
  if (out < total) {
    const long m = out / G.c_out;
    const int c = static_cast<int>(out - m * G.c_out), grp = c / G.co_g;
    const int nb = static_cast<int>(m / G.t_out), t = static_cast<int>(m - (long)nb * G.t_out);
    const T* xg = x + (long)nb * G.t_in * G.c_in + grp * G.ci_g;
    for (int r = lane; r < G.k * G.ci_g; r += lanes) {
      const int tap = r / G.ci_g, ci = r - tap * G.ci_g;
      const int tin = t * G.s + tap * G.d - G.pad_l;
      if (tin >= 0 && tin < G.t_in) s = fmaf(to_f(xg[(long)tin * G.c_in + ci]), to_f(w[(long)r * G.c_out + c]), s);
    }
  }
  s = lanes_sum(s, lanes);
  if (out < total && lane == 0) {
    const int c = static_cast<int>(out % G.c_out);
    const float z = s + (bias != nullptr ? bias[c] : 0.f);
    const float act = lane_cut(G, out / G.c_out, c) ? 0.f : fmaxf(z, 0.f) + G.slope * fminf(z, 0.f);
    y[out] = from_f<T>(act);
  }
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
    simt_dx_kernel(Geom G, const T* __restrict__ dz, const T* __restrict__ w,
                   OutT* __restrict__ out, int lanes) {
  const long gid = blockIdx.x * (long)kThreads + threadIdx.x;
  const long e = gid / lanes;
  const int lane = static_cast<int>(gid - e * lanes);
  const long total = (long)G.n * G.t_in * G.c_in;
  float s = 0.f;
  if (e < total) {
    const long row = e / G.c_in;
    const int c = static_cast<int>(e - row * G.c_in), grp = c / G.ci_g, i = c - grp * G.ci_g;
    const int nb = static_cast<int>(row / G.t_in), u = static_cast<int>(row - (long)nb * G.t_in);
    for (int r = lane; r < G.k * G.co_g; r += lanes) {
      const int tap = r / G.co_g, o = r - tap * G.co_g;
      const int num = u + G.pad_l - tap * G.d;
      if (num < 0 || num % G.s) continue;
      const int t = num / G.s;
      if (t >= G.t_out) continue;
      const int cc = grp * G.co_g + o;
      s = fmaf(to_f(dz[((long)nb * G.t_out + t) * G.c_out + cc]),
               to_f(w[((long)tap * G.ci_g + i) * G.c_out + cc]), s);
    }
  }
  s = lanes_sum(s, lanes);
  if (e < total && lane == 0) out[e] = from_f<OutT>(s);
}

// dW (k, ci_g, c_out) written directly in the working type
template <typename T>
__global__ void __launch_bounds__(kThreads)
    simt_dw_kernel(Geom G, const T* __restrict__ x, const T* __restrict__ dz, T* __restrict__ dw,
                   int lanes) {
  const long gid = blockIdx.x * (long)kThreads + threadIdx.x;
  const long e = gid / lanes;
  const int lane = static_cast<int>(gid - e * lanes);
  const long total = (long)G.k * G.ci_g * G.c_out;
  float s = 0.f;
  if (e < total) {
    const int c = static_cast<int>(e % G.c_out);
    const long r = e / G.c_out;
    const int tap = static_cast<int>(r / G.ci_g), ci = static_cast<int>(r % G.ci_g);
    const int grp = c / G.co_g;
    const long M = (long)G.n * G.t_out;
    for (long m = lane; m < M; m += lanes) {
      const int nb = static_cast<int>(m / G.t_out), t = static_cast<int>(m - (long)nb * G.t_out);
      const int tin = t * G.s + tap * G.d - G.pad_l;
      if (tin < 0 || tin >= G.t_in) continue;
      s = fmaf(to_f(x[((long)nb * G.t_in + tin) * G.c_in + grp * G.ci_g + ci]),
               to_f(dz[m * G.c_out + c]), s);
    }
  }
  s = lanes_sum(s, lanes);
  if (e < total && lane == 0) dw[e] = from_f<T>(s);
}

// ---------------------------------------------------------------------------
// Host launchers. body: 0 = SIMT (lanes threads an output), 1 = tensor cores
// with a bm x bn tile whose shared memory must equal smem.
// ---------------------------------------------------------------------------
inline unsigned ucdiv(long a, long b) { return static_cast<unsigned>((a + b - 1) / b); }

#define CONV_CORE_TILES(CALL, T, ...)                                                 \
  do {                                                                                \
    if (bm == 128 && bn == 64) return CALL(T, 128, 64, __VA_ARGS__);                  \
    if (bm == 128 && bn == 32) return CALL(T, 128, 32, __VA_ARGS__);                  \
    if (bm == 128 && bn == 16) return CALL(T, 128, 16, __VA_ARGS__);                  \
    if (bm == 64 && bn == 64) return CALL(T, 64, 64, __VA_ARGS__);                    \
    if (bm == 64 && bn == 32) return CALL(T, 64, 32, __VA_ARGS__);                    \
    return static_cast<int>(cudaErrorInvalidValue);                                   \
  } while (0)

template <typename T, int BM, int BN>
int fwd_tile(const Geom& G, int kc, const void* x, const void* w, const float* bias, void* y,
             int smem, cudaStream_t st) {
  auto kern = fwd_kernel<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ucdiv((long)G.n * G.t_out, BM), ucdiv(G.co_g, BN), G.groups);
  kern<<<grid, kThreads, smem, st>>>(G, kc, static_cast<const T*>(x), static_cast<const T*>(w),
                                     bias, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}
#define CONV_CORE_FWD(T, BM, BN, ...) fwd_tile<T, BM, BN>(__VA_ARGS__)

template <typename T>
int launch_fwd(const Geom& G, const void* x, const void* w, const float* bias, void* y, int body,
               int bm, int bn, int kc, int smem, int lanes, cudaStream_t st) {
  if (body == 0) {
    if (lanes != 1 && lanes != 32) return static_cast<int>(cudaErrorInvalidValue);
    const long threads = (long)G.n * G.t_out * G.c_out * lanes;
    simt_fwd_kernel<T><<<ucdiv(threads, kThreads), kThreads, 0, st>>>(
        G, static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(y), lanes);
    return static_cast<int>(cudaGetLastError());
  }
  if (!kc_ok(G, false, sizeof(T) == 4, kc) ||
      smem != win_plan(G, false, sizeof(T) == 4, bm, bn, kc).smem || smem > kSmemLimit ||
      G.groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CONV_CORE_TILES(CONV_CORE_FWD, T, G, kc, x, w, bias, y, smem, st);
}

template <typename T, typename OutT, int BM, int BN>
int dx_tile(const Geom& G, int kc, const void* dz, const void* wt, void* out, int smem,
            cudaStream_t st) {
  auto kern = dx_kernel<T, OutT, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ucdiv((long)G.n * cdiv(G.t_in, G.s), BM), ucdiv(G.ci_g, BN), G.groups * G.s);
  kern<<<grid, kThreads, smem, st>>>(G, kc, static_cast<const T*>(dz),
                                     static_cast<const T*>(wt), static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

// dx from dz; the SIMT body reads the weights in their (k, ci_g, c_out)
// layout (w), the tensor-core body transposed (wt).
template <typename T, typename OutT>
int launch_dx(const Geom& G, const void* dz, const void* w, const void* wt, void* out, int body,
              int bm, int bn, int kc, int smem, int lanes, cudaStream_t st) {
  if (body == 0) {
    if (lanes != 1 && lanes != 32) return static_cast<int>(cudaErrorInvalidValue);
    const long threads = (long)G.n * G.t_in * G.c_in * lanes;
    simt_dx_kernel<T, OutT><<<ucdiv(threads, kThreads), kThreads, 0, st>>>(
        G, static_cast<const T*>(dz), static_cast<const T*>(w), static_cast<OutT*>(out), lanes);
    return static_cast<int>(cudaGetLastError());
  }
  if (wt == nullptr || !kc_ok(G, true, sizeof(T) == 4, kc) ||
      smem != win_plan(G, true, sizeof(T) == 4, bm, bn, kc).smem || smem > kSmemLimit ||
      (long)G.groups * G.s > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define CONV_CORE_DX(T, BM, BN, ...) dx_tile<T, OutT, BM, BN>(__VA_ARGS__)
  CONV_CORE_TILES(CONV_CORE_DX, T, G, kc, dz, wt, out, smem, st);
#undef CONV_CORE_DX
}

template <typename T, int BN>
int dw_tile(const Geom& G, const void* x, const void* dz, int kc, int splits, int split_rows,
            float* partial, int smem, cudaStream_t st) {
  auto kern = dw_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwPlan P = dw_plan(G, sizeof(T) == 4, BN, kc);
  const dim3 grid(P.mtiles, ucdiv(G.co_g, BN), G.groups * splits);
  kern<<<grid, kThreads, smem, st>>>(G, static_cast<const T*>(x), static_cast<const T*>(dz), kc,
                                     split_rows, partial);
  return static_cast<int>(cudaGetLastError());
}

// dW (and db from pdb): the tensor-core body writes fp32 partials per
// split, then the fixed-order reduction; the SIMT body writes dW itself.
template <typename T>
int launch_dw(const Geom& G, const void* x, const void* dz, const float* pdb, int nrb,
              float* partial, void* dw, float* db, int body, int bn, int kc, int splits,
              int split_rows, int smem, int lanes, cudaStream_t st) {
  const long wsize = (long)G.k * G.ci_g * G.c_out;
  if (body == 0) {
    if (lanes != 1 && lanes != 32) return static_cast<int>(cudaErrorInvalidValue);
    const long threads = wsize * lanes;
    simt_dw_kernel<T><<<ucdiv(threads, kThreads), kThreads, 0, st>>>(
        G, static_cast<const T*>(x), static_cast<const T*>(dz), static_cast<T*>(dw), lanes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    partial = nullptr;
  } else {
    if (partial == nullptr || splits < 1 || split_rows < 1 ||
        (long)splits * split_rows < (long)G.n * G.t_out || (long)G.groups * splits > 65535 ||
        kc < 8 || kc > 128 || (kc & (kc - 1)) != 0 ||
        smem != dw_plan(G, sizeof(T) == 4, bn, kc).smem || smem > kSmemLimit)
      return static_cast<int>(cudaErrorInvalidValue);
    int rc;
    if (bn == 64)
      rc = dw_tile<T, 64>(G, x, dz, kc, splits, split_rows, partial, smem, st);
    else if (bn == 32)
      rc = dw_tile<T, 32>(G, x, dz, kc, splits, split_rows, partial, smem, st);
    else if (bn == 16)
      rc = dw_tile<T, 16>(G, x, dz, kc, splits, split_rows, partial, smem, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    if (rc != 0) return rc;
  }
  const long total = (partial != nullptr ? wsize : 0) + G.c_out;
  const unsigned blocks = ucdiv(total, kThreads);
  reduce_kernel<T><<<blocks < 4096u ? blocks : 4096u, kThreads, 0, st>>>(
      partial, splits, wsize, static_cast<T*>(dw), pdb, nrb, G.c_out, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv_core
