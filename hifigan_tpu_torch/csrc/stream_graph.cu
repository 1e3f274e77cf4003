// One segment of a stream graph (a DAG of narrow conv1d ops over sample-space
// levels) forward and backward, for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces hifigan_tpu/ops/pallas/stream_graph.py::fused_stream_graph (:786):
// the forward kernel _fwd_kernel (:331, Pallas call :428) and the fused
// backward _bwd_kernel (:449, Pallas call :678). As there, a whole segment
// runs in one launch per pass: forward, dx, dW + db.
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
// with zero padding at each source level's own sequence edge. The backward
// forms the cotangent of the pre-activation where it is staged, from the op's
// fp32 output cotangent da and its saved output y (Pallas _act_vjp_mask, :309):
//
//   lrelu: dz = da * (y >= 0 ? 1 : slope)     tanh:   dz = da * (1 - y^2)
//   square: dz = da * 2 * res_src             log1e5: dz = y > log(1e-5) ? da * exp(-y) : 0
//
// dx adds, for every source level that needs a cotangent, the transposed conv
// of dz rounded to the working type (and, for a residual source, dz itself in
// fp32) into that level's fp32 cotangent; dW sums src x round(dz) over the
// member's rows in split partials that the same launch then sums in split
// order, db from the unrounded dz: no float atomics, so two runs give the
// same bits.
//
// What bounds it: arithmetic at SIMT fp32 rates (67 TFLOP/s) in principle, a
// production member being 10 segments of 59 ops and ~1.5e10 FLOP a pass at
// 12 elements x 3 members (configs/distill.json); measured on the H100, the
// latency of each phase (its staging rounds, its grid barrier) bounds it,
// more so at small batch, and on the narrow ops (1 to 5 channels on the
// 43,680-sample levels) the shared-memory loads that feed each multiply-add.
//
// Design:
// - One persistent cooperative launch per segment and pass
//   (cudaLaunchCooperativeKernel, the grid capped at the co-resident blocks,
//   as csrc/resblock_tail.cu's bf16 body). The host plans the launch
//   (hifigan_tpu_torch/ops/stream_graph.py: forward_schedule, dx_schedule,
//   dw_schedule) as units in phases; a unit is one op's forward, one dx job
//   (a target level) or one dW edge / db of an op. The blocks share each
//   phase's tiles, and a grid barrier ends the phase. Forward: an op runs one
//   phase after the ops producing what it reads. dx: an op runs after every
//   op adding into its output's cotangent and after every later op adding
//   into a level it adds into, so each cotangent sums in reverse op order;
//   the launch first sets every cotangent slot (dy, or zero) and ends by
//   rounding the inputs' cotangents. dW: every unit in one phase writing
//   split partials, then the partials summed in split order.
// - The segment's description (levels, edges, ops, units, pointers) is one
//   by-value __grid_constant__ parameter struct, at most 4 KB.
// - Tiles are shaped by the op: a thread computes TM = 4 rows by TN columns,
//   TN = c_out for c_out <= 4 (no padding column; 1024 rows a tile), else 4
//   with up to 16 threads across at most 64 columns. A tile stages each
//   edge's input window once in shared memory, a chunk of channels at a time
//   (dense: every source row the taps span, so a K-tap conv reads each staged
//   value K times; compact when receptive fields do not overlap, (K-1)d < s:
//   each output row's K taps), and the chunk's weights; the products run from
//   shared memory with no barrier inside. dx stages a window of the rounded
//   dz per stride phase of the target (rows of one phase meet every s-th
//   tap) and the transposed weights, and is the forward's product with taps
//   reversed; a strided edge whose taps do not overlap (K <= s) takes one
//   tile for every tap instead ("compact": dz rows by (tap, channel)
//   columns, each scattered to its one target row). A fwd/dx unit with too
//   few tiles to fill the card (the heads on short levels) takes fewer rows
//   a tile and splits each staged chunk's channels over thread groups
//   ("lanes"), summed in lane order. dW takes (tap, channel) rows of the
//   table by columns, lanes splitting the split's rows; few outputs and long
//   rows (the narrow ops) take many lanes and many splits, so one wave fills
//   the card; db takes tiles of at most 32 columns.
// - The TPU kernel's time-folded lanes, banded per-tap tables, zones, leads
//   and guards are VMEM/lane devices and are not carried over.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;          // rows of a thread's micro-tile
constexpr int kWinCap = 8192;   // fp32 slots of the staged window
constexpr int kWCap = 8192;     // fp32 slots of the staged weights (dW: dz)
constexpr int kSmemBytes = (kWinCap + kWCap) * 4;
constexpr int kMaxLevels = 16, kMaxEdges = 12, kMaxOps = 10, kMaxUnits = 20, kMaxPhases = 20;
constexpr int kMaxOpEdges = 4;
constexpr int kUnitInts = 21;  // ints of one unit in the host array

enum Act { kNone = 0, kLrelu = 1, kTanh = 2, kSquare = 3, kLog = 4 };
enum Pass { kFwd = 0, kDx = 1, kDw = 2 };

struct Lv {
  const void* y;  // the level's values (B, t, c) in the working type
  float* da;      // its fp32 cotangent slot (B, t, c), or null
  void* dyx;      // produced level: its dy or null; input level: its dx out or null
  int t, c, is_in;
};

struct Ed {
  const void* w;  // (M, k, c_in, c_out)
  int src, c_in, t_src, k, s, d, pad;
};

struct OpD {
  const float* bias;  // (M, c_out) fp32 or null
  float slope;
  int out, res, act, e0, ne;
};

struct Unit {
  void* out;    // dW: the table's gradient (working type); db: (M, c_out) fp32
  float* part;  // dW, db: partials (M, splits, rows, c_out)
  int op, tn, tx, ty, cw, tiles, rt, ct, tgt, s, res, ne;
  int e[kMaxOpEdges];
  int lanes, rc, splits, split_rows, compact;
};

struct SegP {
  Lv lv[kMaxLevels];
  Ed ed[kMaxEdges];
  OpD op[kMaxOps];
  Unit u[kMaxUnits];
  int ph_end[kMaxPhases];
  int n_lv, n_ed, n_op, n_u, n_ph, batch, members, n_per;
};
static_assert(sizeof(SegP) <= 4000, "the launch's description must stay a small kernel parameter");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float act_fwd(float z, int act, float slope) {
  switch (act) {
    case kLrelu: return fmaxf(z, 0.f) + slope * fminf(z, 0.f);
    case kTanh: return tanhf(z);
    case kSquare: return z * z;
    case kLog: return logf(fmaxf(z, 1e-5f));
    default: return z;
  }
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Window of an edge for `rows` consecutive output rows: output row r, tap k
// reads staged row r * step + k * kstep (csrc mirror of ops/stream_graph.py
// window()).
struct Win {
  int rows, step, kstep;
  bool compact;
};

__host__ __device__ inline Win window_of(int rows, int k, int s, int d) {
  const int span = (k - 1) * d + 1;
  if (span <= s) return {rows * k, k, 1, true};
  return {(rows - 1) * s + span, s, d, false};
}

// The op's output side, shared by the backward passes: the fp32 cotangent of
// its output, its saved output and (square) the residual source it squared.
template <typename T>
struct OutSide {
  const float* da;  // (B, t_out, c_out) fp32
  const T* y;       // (B, t_out, c_out)
  const T* sq;      // square: residual source, element stride sq_estride; else null
  long sq_estride;
  int t_out, c_out, act;
  float slope;

  __device__ OutSide(const SegP& P, const OpD& op) {
    const Lv& ol = P.lv[op.out];
    da = ol.da;
    y = static_cast<const T*>(ol.y);
    sq = nullptr;
    sq_estride = 0;
    if (op.act == kSquare) {
      sq = static_cast<const T*>(P.lv[op.res].y);
      sq_estride = (long)P.lv[op.res].t * P.lv[op.res].c;
    }
    t_out = ol.t;
    c_out = ol.c;
    act = op.act;
    slope = op.slope;
  }

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

template <int TN>
__device__ __forceinline__ void load_cols(const float* p, float (&b)[TN]) {
  if constexpr (TN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    b[0] = v.x;
    b[1] = v.y;
    b[2] = v.z;
    b[3] = v.w;
  } else if constexpr (TN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x;
    b[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = p[j];
  }
}

// Stage n values into shared memory: value(q, &at) returns element q and
// the shared slot it goes to. Each thread starts kStage loads before it
// stores any, so a staging round waits for one memory latency, not kStage.
constexpr int kStage = 8;

template <typename Value>
__device__ __forceinline__ void stage(float* dst, int n, Value value) {
  for (int q0 = threadIdx.x; q0 < n; q0 += kStage * kThreads) {
    float v[kStage];
    int at[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int q = q0 + j * kThreads;
      at[j] = -1;
      v[j] = q < n ? value(q, at[j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j)
      if (at[j] >= 0) dst[at[j]] = v[j];
  }
}

// dst(i, src(i)) for i < n over the whole grid, kStage loads in flight a thread.
template <typename Src, typename Dst>
__device__ __forceinline__ void grid_copy(long n, Src src, Dst dst) {
  const long first = (long)blockIdx.x * kThreads + threadIdx.x, stride = (long)gridDim.x * kThreads;
  for (long i0 = first; i0 < n; i0 += kStage * stride) {
    float v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const long i = i0 + j * stride;
      v[j] = i < n ? src(i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const long i = i0 + j * stride;
      if (i < n) dst(i, v[j]);
    }
  }
}

// Stage edge e's input window for output rows [t0, t0 + rows) of one
// element (x: its source level viewed (t_src, c_in)), channels
// [ch0, ch0 + cw), cip floats a staged row, zero outside the level.
template <typename T>
__device__ __forceinline__ Win stage_window(float* win, const T* x, const Ed& e, int t0, int rows,
                                            int ch0, int cw, int cip) {
  const Win g = window_of(rows, e.k, e.s, e.d);
  stage(win, g.rows * cw, [&](int q, int& at) {
    const int wr = q / cw, ci = q - wr * cw;
    int src;
    if (g.compact) {
      const int rr = wr / e.k;
      src = (t0 + rr) * e.s - e.pad + (wr - rr * e.k) * e.d;
    } else {
      src = t0 * e.s - e.pad + wr;
    }
    at = wr * cip + ci;
    return (src >= 0 && src < e.t_src) ? to_f(x[(long)src * e.c_in + ch0 + ci]) : 0.f;
  });
  return g;
}

template <int TN>
__device__ __forceinline__ void zero(float (&acc)[kTM][TN]) {
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;
}

// acc[r][j] += sum_{k < K, c < cw} win[(row_r * step + k * kstep) * cip + c] * wsm[(k * cw + c) * bn + tx * TN + j]
// for the thread's rows row_r = ty + r * ty_n below `rows` (others read row 0
// and are discarded by the caller); a lane takes channels c0, c0 + dc, ...
template <int TN>
__device__ __forceinline__ void mac_window(const float* win, int cip, int step, int kstep,
                                           const float* wsm, int bn, int K, int cw, int ty,
                                           int ty_n, int tx, int rows, float (&acc)[kTM][TN],
                                           int c0 = 0, int dc = 1) {
  int ro[kTM];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int lr = ty + r * ty_n;
    ro[r] = lr < rows ? lr * step * cip : 0;
  }
  for (int k = 0; k < K; ++k) {
    const float* wk = win + k * kstep * cip;
    const float* bk = wsm + k * cw * bn + tx * TN;
#pragma unroll 4
    for (int c = c0; c < cw; c += dc) {
      float a[kTM], b[TN];
#pragma unroll
      for (int r = 0; r < kTM; ++r) a[r] = wk[ro[r] + c];
      load_cols<TN>(bk + c * bn, b);
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
  }
}

// The lanes' sums, added in lane order, into lane 0's acc (red: lanes *
// tx_n * ty_n * TM * TN floats of shared memory, free to overwrite).
template <int TN>
__device__ __forceinline__ void sum_lanes(float* red, int lanes, int grp, int lane, int gi,
                                          float (&acc)[kTM][TN]) {
  __syncthreads();
  if (lane < lanes) {
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) red[((lane * grp + gi) * kTM + r) * TN + j] = acc[r][j];
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float sum = 0.f;
        for (int l = 0; l < lanes; ++l) sum += red[((l * grp + gi) * kTM + r) * TN + j];
        acc[r][j] = sum;
      }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward tile: element b, output rows [t0, t0 + TM * ty_n), columns
// [n0, n0 + TN * tx_n) of one op; `lanes` thread groups split each staged
// chunk's channels (as in the dx tiles). idx = ((b * rt) + row tile) * ct +
// column tile.
// ---------------------------------------------------------------------------
template <typename T, int TN>
__device__ void fwd_tile(const SegP& P, const Unit& U, int idx, float* win, float* wsm) {
  const OpD& op = P.op[U.op];
  const Lv& ol = P.lv[op.out];
  const int t_out = ol.t, c_out = ol.c;
  const int tx_n = U.tx, ty_n = U.ty, bm = kTM * ty_n, bn = TN * tx_n;
  const int c = idx % U.ct;
  idx /= U.ct;
  const int t0 = (idx % U.rt) * bm, b = idx / U.rt;
  const int n0 = c * bn, rows = min(bm, t_out - t0), mem = b / P.n_per;
  const int grp = tx_n * ty_n, lane = threadIdx.x / grp, gi = threadIdx.x - lane * grp;
  const int tx = gi % tx_n, ty = gi / tx_n;
  const bool active = lane < U.lanes;
  float acc[kTM][TN];
  zero(acc);
  for (int q = 0; q < op.ne; ++q) {
    const Ed& e = P.ed[op.e0 + q];
    const T* x = static_cast<const T*>(P.lv[e.src].y) + (long)b * e.t_src * e.c_in;
    const T* w = static_cast<const T*>(e.w) + (long)mem * e.k * e.c_in * c_out;
    for (int i0 = 0; i0 < e.c_in; i0 += U.cw) {
      const int cw = min(U.cw, e.c_in - i0), cip = cw | 1;
      const Win g = stage_window(win, x, e, t0, rows, i0, cw, cip);
      stage(wsm, e.k * cw * bn, [&](int q, int& at) {
        const int n = q % bn, kc = q / bn, kk = kc / cw, ci = kc - kk * cw, o = n0 + n;
        at = q;
        return o < c_out ? to_f(w[((long)kk * e.c_in + i0 + ci) * c_out + o]) : 0.f;
      });
      __syncthreads();
      if (active)
        mac_window<TN>(win, cip, g.step, g.kstep, wsm, bn, e.k, cw, ty, ty_n, tx, rows, acc, lane,
                       U.lanes);
      __syncthreads();
    }
  }
  if (U.lanes > 1) sum_lanes<TN>(win, U.lanes, grp, lane, gi, acc);
  if (lane != 0) return;
  const float* bias = op.bias != nullptr ? op.bias + (long)mem * c_out : nullptr;
  const T* res = nullptr;
  if (op.res >= 0) res = static_cast<const T*>(P.lv[op.res].y) + (long)b * P.lv[op.res].t * P.lv[op.res].c;
  T* y = static_cast<T*>(const_cast<void*>(ol.y)) + (long)b * t_out * c_out;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int lr = ty + r * ty_n;
    if (lr >= rows) continue;
    const int t = t0 + lr;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = n0 + tx * TN + j;
      if (o >= c_out) continue;
      float z = acc[r][j];
      if (bias != nullptr) z += bias[o];
      if (res != nullptr) z += to_f(res[(long)t * c_out + o]);
      y[(long)t * c_out + o] = from_f<T>(act_fwd(z, op.act, op.slope));
    }
  }
}

// ---------------------------------------------------------------------------
// dx tile: one job (target level read with c_tgt channels, its edges all of
// stride s), stride phase ph, element b, phase rows [j0, j0 + TM * ty_n)
// (target rows u = ph + s * j), target channels [n0, n0 + TN * tx_n).
// idx = (((ph * batch + b) * rt) + row tile) * ct + column tile. Rows u of
// phase ph meet taps k = k0 + s*q, k0 = (ph + pad) mod s, at output rows
// t = j + (ph + pad - k0)/s - q (s > 1, d == 1); with s == 1 the taps are
// k = q at t = u + pad - q*d.
// ---------------------------------------------------------------------------
template <typename T, int TN>
__device__ void dx_tile(const SegP& P, const Unit& U, int idx, float* win, float* wsm) {
  const OpD& op = P.op[U.op];
  const Lv& tl = P.lv[U.tgt];
  const OutSide<T> O(P, op);
  const int t_out = O.t_out, c_out = O.c_out, s = U.s;
  const int c_tgt = U.ne > 0 ? P.ed[U.e[0]].c_in : c_out;
  const int t_tgt = tl.t * tl.c / c_tgt;
  const int tx_n = U.tx, ty_n = U.ty, bm = kTM * ty_n, bn = TN * tx_n;
  const int c = idx % U.ct;
  idx /= U.ct;
  const int j0 = (idx % U.rt) * bm;
  idx /= U.rt;
  const int b = idx % P.batch, ph = idx / P.batch;
  if (ph >= t_tgt) return;
  const int R = (t_tgt - ph + s - 1) / s;  // rows of this phase per element
  if (j0 >= R) return;
  const int rows = min(bm, R - j0), n0 = c * bn, mem = b / P.n_per;
  const int grp = tx_n * ty_n, lane = threadIdx.x / grp, gi = threadIdx.x - lane * grp;
  const int tx = gi % tx_n, ty = gi / tx_n;
  const bool active = lane < U.lanes;
  float acc[kTM][TN];
  zero(acc);
  for (int q = 0; q < U.ne; ++q) {
    const Ed& e = P.ed[U.e[q]];
    const T* w = static_cast<const T*>(e.w) + (long)mem * e.k * c_tgt * c_out;
    int k0, nq, tb_off, dq;
    if (s == 1) {
      k0 = 0;
      nq = e.k;
      tb_off = e.pad;
      dq = e.d;
    } else {
      k0 = (ph + e.pad) % s;
      nq = e.k > k0 ? (e.k - k0 + s - 1) / s : 0;
      tb_off = (ph + e.pad - k0) / s;
      dq = 1;
    }
    if (nq == 0) continue;
    const int rows_w = rows + (nq - 1) * dq;
    const int base = j0 + tb_off - (nq - 1) * dq;  // output row of staged row 0
    for (int o0 = 0; o0 < c_out; o0 += U.cw) {
      const int cw = min(U.cw, c_out - o0), cip = cw | 1;
      stage(win, rows_w * cw, [&](int q, int& at) {
        const int wr = q / cw, o = q - wr * cw, t = base + wr;
        at = wr * cip + o;
        return (t >= 0 && t < t_out) ? rnd<T>(O.dz(b, t, o0 + o)) : 0.f;
      });
      // staged tap kq holds tap k0 + s * (nq - 1 - kq), transposed to (o, i)
      stage(wsm, nq * bn * cw, [&](int q, int& at) {
        const int o = q % cw, rest = q / cw, n = rest % bn, kq = rest / bn, i = n0 + n;
        at = (kq * cw + o) * bn + n;
        return i < c_tgt ? to_f(w[((long)(k0 + s * (nq - 1 - kq)) * c_tgt + i) * c_out + o0 + o])
                         : 0.f;
      });
      __syncthreads();
      if (active)
        mac_window<TN>(win, cip, 1, dq, wsm, bn, nq, cw, ty, ty_n, tx, rows, acc, lane, U.lanes);
      __syncthreads();
    }
  }
  if (U.lanes > 1) sum_lanes<TN>(win, U.lanes, grp, lane, gi, acc);
  if (lane != 0) return;
  float* dat = tl.da + (long)b * tl.t * tl.c;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int lr = ty + r * ty_n;
    if (lr >= rows) continue;
    const int u = ph + s * (j0 + lr);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int i = n0 + tx * TN + j;
      if (i >= c_tgt) continue;
      float v = acc[r][j];
      if (U.res && u < t_out) v += O.dz(b, u, i);
      dat[(long)u * c_tgt + i] += v;
    }
  }
}

// ---------------------------------------------------------------------------
// compact dx tile: one edge of stride s > 1 with K <= s, so target row
// u = t*s - pad + k is tap k of output row t alone. Element b, output rows
// [t0, t0 + TM * ty_n), columns n = k * c_tgt + i in [n0, n0 + TN * tx_n):
// the rounded dz rows times the (k, i) columns of the table, added at u.
// idx = ((b * rt) + row tile) * ct + column tile.
// ---------------------------------------------------------------------------
template <typename T, int TN>
__device__ void dx_compact_tile(const SegP& P, const Unit& U, int idx, float* win, float* wsm) {
  const OpD& op = P.op[U.op];
  const Lv& tl = P.lv[U.tgt];
  const Ed& e = P.ed[U.e[0]];
  const OutSide<T> O(P, op);
  const int t_out = O.t_out, c_out = O.c_out, c_tgt = e.c_in, s = U.s;
  const int t_tgt = tl.t * tl.c / c_tgt, ncols = e.k * c_tgt;
  const int tx_n = U.tx, ty_n = U.ty, bm = kTM * ty_n, bn = TN * tx_n;
  const int c = idx % U.ct;
  idx /= U.ct;
  const int t0 = (idx % U.rt) * bm, b = idx / U.rt;
  const int rows = min(bm, t_out - t0), n0 = c * bn, mem = b / P.n_per;
  const int grp = tx_n * ty_n, lane = threadIdx.x / grp, gi = threadIdx.x - lane * grp;
  const int tx = gi % tx_n, ty = gi / tx_n;
  const bool active = lane < U.lanes;
  const T* w = static_cast<const T*>(e.w) + (long)mem * ncols * c_out;
  float acc[kTM][TN];
  zero(acc);
  for (int o0 = 0; o0 < c_out; o0 += U.cw) {
    const int cw = min(U.cw, c_out - o0), cip = cw | 1;
    stage(win, rows * cw, [&](int q, int& at) {
      const int wr = q / cw, o = q - wr * cw;
      at = wr * cip + o;
      return rnd<T>(O.dz(b, t0 + wr, o0 + o));
    });
    stage(wsm, cw * bn, [&](int q, int& at) {
      const int o = q % cw, n = q / cw;
      at = o * bn + n;
      return n0 + n < ncols ? to_f(w[(long)(n0 + n) * c_out + o0 + o]) : 0.f;
    });
    __syncthreads();
    if (active) mac_window<TN>(win, cip, 1, 0, wsm, bn, 1, cw, ty, ty_n, tx, rows, acc, lane, U.lanes);
    __syncthreads();
  }
  if (U.lanes > 1) sum_lanes<TN>(win, U.lanes, grp, lane, gi, acc);
  if (lane != 0) return;
  float* dat = tl.da + (long)b * tl.t * tl.c;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int lr = ty + r * ty_n;
    if (lr >= rows) continue;
    const int t = t0 + lr;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= ncols) continue;
      const int k = n / c_tgt, i = n - k * c_tgt, u = t * s - e.pad + k;
      if (u >= 0 && u < t_tgt) dat[(long)u * c_tgt + i] += acc[r][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dW tile: member m, split sp (the member's rows mf = n * t_out + t in
// [sp * split_rows, (sp + 1) * split_rows)), table rows r = k * c_in + i in
// [r0, r0 + TM * ty_n), columns [n0, n0 + TN * tx_n). idx = ((m * splits +
// sp) * rt + row tile) * ct + column tile. Lane l of the block's thread
// groups takes every lanes-th row of each staged chunk; the lanes' sums are
// added in lane order, and the split's partial written.
// ---------------------------------------------------------------------------
template <typename T, int TN>
__device__ void dw_tile(const SegP& P, const Unit& U, int idx, float* win, float* dzs) {
  const OpD& op = P.op[U.op];
  const Ed& e = P.ed[U.e[0]];
  const OutSide<T> O(P, op);
  const int t_out = O.t_out, c_out = O.c_out, c_in = e.c_in, R = e.k * c_in;
  const int tx_n = U.tx, ty_n = U.ty, bn = TN * tx_n, bmo = kTM * ty_n;
  const int c = idx % U.ct;
  idx /= U.ct;
  const int r0 = (idx % U.rt) * bmo;
  idx /= U.rt;
  const int sp = idx % U.splits, m = idx / U.splits;
  const int r1 = min(R, r0 + bmo), n0 = c * bn;
  const int ka = r0 / c_in, kb = (r1 - 1) / c_in;
  const int ch_lo = ka == kb ? r0 - ka * c_in : 0, span = ka == kb ? r1 - r0 : c_in;
  const int cip = span | 1;
  const int tid = threadIdx.x, grp = tx_n * ty_n, lane = tid / grp, gi = tid - lane * grp;
  const int tx = gi % tx_n, ty = gi / tx_n;
  const bool active = lane < U.lanes;
  const Win g1 = window_of(1, e.k, e.s, e.d);
  int off[kTM];
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int row = r0 + ty + r * ty_n;
    const int k = row / c_in;
    off[r] = row < r1 ? k * g1.kstep * cip + (row - k * c_in - ch_lo) : 0;
  }
  float acc[kTM][TN];
  zero(acc);
  const int rows_m = P.n_per * t_out;
  const int m_beg = sp * U.split_rows, m_end = min(rows_m, m_beg + U.split_rows);
  for (int mf = m_beg; mf < m_end;) {
    const int n = mf / t_out, ta = mf - n * t_out;
    const int nr = min(min(U.rc, t_out - ta), m_end - mf);
    const long b = (long)m * P.n_per + n;
    const T* x = static_cast<const T*>(P.lv[e.src].y) + b * e.t_src * c_in;
    const Win g = stage_window(win, x, e, ta, nr, ch_lo, span, cip);
    stage(dzs, nr * bn, [&](int q, int& at) {
      const int tt = q / bn, o = n0 + q - tt * bn;
      at = q;
      return o < c_out ? rnd<T>(O.dz(b, ta + tt, o)) : 0.f;
    });
    __syncthreads();
    if (active) {
      for (int tt = lane; tt < nr; tt += U.lanes) {
        const float* wt = win + tt * g.step * cip;
        float a[kTM], bv[TN];
#pragma unroll
        for (int r = 0; r < kTM; ++r) a[r] = wt[off[r]];
        load_cols<TN>(dzs + tt * bn + tx * TN, bv);
#pragma unroll
        for (int r = 0; r < kTM; ++r)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(a[r], bv[j], acc[r][j]);
      }
    }
    __syncthreads();
    mf += nr;
  }
  sum_lanes<TN>(win, U.lanes, grp, lane, gi, acc);  // win reused: <= 4096 floats
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int row = r0 + ty + r * ty_n;
    if (row >= r1) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = n0 + tx * TN + j;
      if (o < c_out) U.part[((long)(m * U.splits + sp) * R + row) * c_out + o] = acc[r][j];
    }
  }
}

// db tile: member m, split sp, columns [c * tx, (c + 1) * tx); lanes threads
// to a column sum every lanes-th row of the split, added in lane order.
// idx = (m * splits + sp) * ct + column tile.
template <typename T>
__device__ void db_tile(const SegP& P, const Unit& U, int idx, float* red) {
  const OpD& op = P.op[U.op];
  const OutSide<T> O(P, op);
  const int t_out = O.t_out, c_out = O.c_out, bn = U.tx;
  const int c = idx % U.ct;
  idx /= U.ct;
  const int sp = idx % U.splits, m = idx / U.splits;
  const int tid = threadIdx.x, lane = tid / bn, col = tid - lane * bn, o = c * bn + col;
  const int rows_m = P.n_per * t_out;
  const int m_beg = sp * U.split_rows, m_end = min(rows_m, m_beg + U.split_rows);
  float acc = 0.f;
  if (lane < U.lanes && o < c_out) {
#pragma unroll 4
    for (int mf = m_beg + lane; mf < m_end; mf += U.lanes) {
      const int n = mf / t_out;
      acc += O.dz((long)m * P.n_per + n, mf - n * t_out, o);
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (lane == 0 && o < c_out) {
    float sum = 0.f;
    for (int l = 0; l < U.lanes; ++l) sum += red[l * bn + col];
    U.part[(long)(m * U.splits + sp) * c_out + o] = sum;
  }
  __syncthreads();
}

__device__ __forceinline__ int phase_tiles(const SegP& P, int u0, int u1) {
  int n = 0;
  for (int u = u0; u < u1; ++u) n += P.u[u].tiles;
  return n;
}

// the unit of the phase's `idx`-th tile; idx becomes the tile's index in it
__device__ __forceinline__ int unit_of(const SegP& P, int u, int& idx) {
  while (idx >= P.u[u].tiles) idx -= P.u[u].tiles, ++u;
  return u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) sg_fwd_kernel(const __grid_constant__ SegP P) {
  extern __shared__ __align__(16) float smem[];
  float *win = smem, *wsm = smem + kWinCap;
  cg::grid_group grid = cg::this_grid();
  int u0 = 0;
  for (int ph = 0; ph < P.n_ph; ++ph) {
    const int u1 = P.ph_end[ph], total = phase_tiles(P, u0, u1);
    for (int item = blockIdx.x; item < total; item += gridDim.x) {
      int idx = item;
      const Unit& U = P.u[unit_of(P, u0, idx)];
      switch (U.tn) {
        case 1: fwd_tile<T, 1>(P, U, idx, win, wsm); break;
        case 2: fwd_tile<T, 2>(P, U, idx, win, wsm); break;
        case 3: fwd_tile<T, 3>(P, U, idx, win, wsm); break;
        default: fwd_tile<T, 4>(P, U, idx, win, wsm); break;
      }
    }
    u0 = u1;
    if (ph + 1 < P.n_ph) grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) sg_dx_kernel(const __grid_constant__ SegP P) {
  extern __shared__ __align__(16) float smem[];
  float *win = smem, *wsm = smem + kWinCap;
  cg::grid_group grid = cg::this_grid();
  for (int l = 0; l < P.n_lv; ++l) {
    const Lv& L = P.lv[l];
    if (L.da == nullptr) continue;
    const long n = (long)P.batch * L.t * L.c;
    const T* dy = L.is_in ? nullptr : static_cast<const T*>(L.dyx);
    float* da = L.da;
    if (dy != nullptr)
      grid_copy(n, [&](long i) { return to_f(dy[i]); }, [&](long i, float v) { da[i] = v; });
    else
      grid_copy(n, [](long) { return 0.f; }, [&](long i, float v) { da[i] = v; });
  }
  grid.sync();
  int u0 = 0;
  for (int ph = 0; ph < P.n_ph; ++ph) {
    const int u1 = P.ph_end[ph], total = phase_tiles(P, u0, u1);
    for (int item = blockIdx.x; item < total; item += gridDim.x) {
      int idx = item;
      const Unit& U = P.u[unit_of(P, u0, idx)];
      if (U.compact) {
        switch (U.tn) {
          case 1: dx_compact_tile<T, 1>(P, U, idx, win, wsm); break;
          case 2: dx_compact_tile<T, 2>(P, U, idx, win, wsm); break;
          case 3: dx_compact_tile<T, 3>(P, U, idx, win, wsm); break;
          default: dx_compact_tile<T, 4>(P, U, idx, win, wsm); break;
        }
        continue;
      }
      switch (U.tn) {
        case 1: dx_tile<T, 1>(P, U, idx, win, wsm); break;
        case 2: dx_tile<T, 2>(P, U, idx, win, wsm); break;
        case 3: dx_tile<T, 3>(P, U, idx, win, wsm); break;
        default: dx_tile<T, 4>(P, U, idx, win, wsm); break;
      }
    }
    u0 = u1;
    grid.sync();
  }
  for (int l = 0; l < P.n_lv; ++l) {
    const Lv& L = P.lv[l];
    if (!L.is_in || L.da == nullptr || L.dyx == nullptr) continue;
    const float* da = L.da;
    T* dx = static_cast<T*>(L.dyx);
    grid_copy((long)P.batch * L.t * L.c, [&](long i) { return da[i]; },
              [&](long i, float v) { dx[i] = from_f<T>(v); });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) sg_dw_kernel(const __grid_constant__ SegP P) {
  extern __shared__ __align__(16) float smem[];
  float *win = smem, *dzs = smem + kWinCap;
  cg::grid_group grid = cg::this_grid();
  const int total = phase_tiles(P, 0, P.n_u);
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int idx = item;
    const Unit& U = P.u[unit_of(P, 0, idx)];
    if (U.ne == 0) {
      db_tile<T>(P, U, idx, win);
      continue;
    }
    switch (U.tn) {
      case 1: dw_tile<T, 1>(P, U, idx, win, dzs); break;
      case 2: dw_tile<T, 2>(P, U, idx, win, dzs); break;
      case 3: dw_tile<T, 3>(P, U, idx, win, dzs); break;
      default: dw_tile<T, 4>(P, U, idx, win, dzs); break;
    }
  }
  grid.sync();
  // every gradient: its splits' partials summed in split order
  const long first = (long)blockIdx.x * kThreads + threadIdx.x, stride = (long)gridDim.x * kThreads;
  for (int u = 0; u < P.n_u; ++u) {
    const Unit& U = P.u[u];
    const int c_out = P.lv[P.op[U.op].out].c;
    const long size = U.ne == 0 ? c_out : (long)P.ed[U.e[0]].k * P.ed[U.e[0]].c_in * c_out;
    const long n = size * P.members;
    for (long i = first; i < n; i += stride) {
      const long mm = i / size, k = i - mm * size;
      const float* p = U.part + mm * U.splits * size + k;
      float sum = 0.f;
#pragma unroll 8
      for (int sp = 0; sp < U.splits; ++sp) sum += p[sp * size];
      if (U.ne == 0)
        static_cast<float*>(U.out)[i] = sum;
      else
        static_cast<T*>(U.out)[i] = from_f<T>(sum);
    }
  }
}

const void* kernel_for(int dtype, int pass) {
  if (dtype == 0) {
    if (pass == kFwd) return reinterpret_cast<const void*>(sg_fwd_kernel<float>);
    if (pass == kDx) return reinterpret_cast<const void*>(sg_dx_kernel<float>);
    if (pass == kDw) return reinterpret_cast<const void*>(sg_dw_kernel<float>);
  } else if (dtype == 1) {
    if (pass == kFwd) return reinterpret_cast<const void*>(sg_fwd_kernel<__nv_bfloat16>);
    if (pass == kDx) return reinterpret_cast<const void*>(sg_dx_kernel<__nv_bfloat16>);
    if (pass == kDw) return reinterpret_cast<const void*>(sg_dw_kernel<__nv_bfloat16>);
  }
  return nullptr;
}

cudaError_t configure(const void* fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

// ---------------------------------------------------------------------------
// host: read and check the plan (ops/stream_graph.py mirrors these rules)
// ---------------------------------------------------------------------------

bool fits_window(int rows, int k, int s, int d, int cw) {
  return (long)window_of(rows, k, s, d).rows * (cw | 1) <= kWinCap;
}

bool fwd_unit_ok(const SegP& P, const Unit& U) {
  const OpD& op = P.op[U.op];
  const Lv& ol = P.lv[op.out];
  const int bm = kTM * U.ty, bn = U.tn * U.tx, rows = bm < ol.t ? bm : ol.t;
  if (U.rt != cdiv(ol.t, bm) || U.ct != cdiv(ol.c, bn) || U.tiles != P.batch * U.rt * U.ct ||
      U.lanes < 1 || (long)U.lanes * U.tx * U.ty > kThreads)
    return false;
  if (op.ne > 0 && U.cw < 1) return false;
  for (int q = 0; q < op.ne; ++q) {
    const Ed& e = P.ed[op.e0 + q];
    if (!fits_window(rows, e.k, e.s, e.d, U.cw) || (long)e.k * U.cw * bn > kWCap) return false;
  }
  return true;
}

bool dx_unit_ok(const SegP& P, const Unit& U) {
  const OpD& op = P.op[U.op];
  const Lv& ol = P.lv[op.out];
  if (U.tgt < 0 || U.tgt >= P.n_lv || P.lv[U.tgt].da == nullptr || ol.da == nullptr) return false;
  if ((U.ne == 0 && !U.res) || U.lanes < 1 || (long)U.lanes * U.tx * U.ty > kThreads) return false;
  const int c_tgt = U.ne > 0 ? P.ed[U.e[0]].c_in : ol.c;
  const long size = (long)P.lv[U.tgt].t * P.lv[U.tgt].c;
  if (size % c_tgt != 0) return false;
  if (U.compact) {
    const Ed& e = P.ed[U.e[0]];
    const int bm = kTM * U.ty, bn = U.tn * U.tx, rows = bm < ol.t ? bm : ol.t;
    return U.ne == 1 && !U.res && U.s > 1 && e.s == U.s && e.k <= U.s && e.src == U.tgt &&
           U.e[0] >= op.e0 && U.e[0] < op.e0 + op.ne && U.cw >= 1 && U.rt == cdiv(ol.t, bm) &&
           U.ct == cdiv(e.k * c_tgt, bn) && U.tiles == P.batch * U.rt * U.ct &&
           (long)rows * (U.cw | 1) <= kWinCap && (long)U.cw * bn <= kWCap;
  }
  if (U.res && (U.s != 1 || c_tgt != ol.c || op.res != U.tgt)) return false;
  const int rows_ph = cdiv(static_cast<int>(size / c_tgt), U.s);
  const int bm = kTM * U.ty, bn = U.tn * U.tx, rows = bm < rows_ph ? bm : rows_ph;
  if (U.rt != cdiv(rows_ph, bm) || U.ct != cdiv(c_tgt, bn) ||
      U.tiles != U.s * P.batch * U.rt * U.ct)
    return false;
  if (U.ne > 0 && U.cw < 1) return false;
  for (int q = 0; q < U.ne; ++q) {
    const Ed& e = P.ed[U.e[q]];
    if (U.e[q] < op.e0 || U.e[q] >= op.e0 + op.ne || e.src != U.tgt || e.c_in != c_tgt ||
        e.s != U.s)
      return false;
    const int nq = U.s == 1 ? e.k : cdiv(e.k, U.s), dq = U.s == 1 ? e.d : 1;
    if ((long)(rows + (nq - 1) * dq) * (U.cw | 1) > kWinCap || (long)nq * U.cw * bn > kWCap)
      return false;
  }
  return true;
}

bool dw_unit_ok(const SegP& P, const Unit& U) {
  const OpD& op = P.op[U.op];
  const Lv& ol = P.lv[op.out];
  const int rows_m = P.n_per * ol.t;
  if (ol.da == nullptr || U.out == nullptr || U.part == nullptr || U.splits < 1 ||
      U.split_rows < 1 || (long)U.splits * U.split_rows < rows_m)
    return false;
  if (U.ne == 0) {  // db
    return U.tx >= 1 && U.tx <= kThreads && U.lanes >= 1 && U.lanes * U.tx <= kThreads &&
           U.ct == cdiv(ol.c, U.tx) && U.tiles == P.members * U.splits * U.ct;
  }
  if (U.ne != 1 || U.e[0] < op.e0 || U.e[0] >= op.e0 + op.ne || U.lanes < 1 || U.rc < 1 ||
      (long)U.lanes * U.tx * U.ty > kThreads)
    return false;
  const Ed& e = P.ed[U.e[0]];
  const int R = e.k * e.c_in, bmo = kTM * U.ty, bn = U.tn * U.tx;
  if (U.rt != cdiv(R, bmo) || U.ct != cdiv(ol.c, bn) ||
      U.tiles != P.members * U.splits * U.rt * U.ct || (long)U.rc * bn > kWCap)
    return false;
  for (int r0 = 0; r0 < R; r0 += bmo) {
    const int r1 = r0 + bmo < R ? r0 + bmo : R;
    const int span = r0 / e.c_in == (r1 - 1) / e.c_in ? r1 - r0 : e.c_in;
    if (!fits_window(U.rc, e.k, e.s, e.d, span)) return false;
  }
  return true;
}

// Fill P from the host arrays; false on anything the kernels do not take.
bool read_plan(SegP& P, int pass, const int* geo, const int* units, const float* slopes,
               const void* const* ptrs) {
  int at = 0;
  P.n_lv = geo[at++];
  P.n_ed = geo[at++];
  P.n_op = geo[at++];
  P.batch = geo[at++];
  P.members = geo[at++];
  P.n_per = geo[at++];
  if (P.n_lv < 1 || P.n_lv > kMaxLevels || P.n_ed < 0 || P.n_ed > kMaxEdges || P.n_op < 1 ||
      P.n_op > kMaxOps || P.members < 1 || P.n_per < 1 || P.batch != P.members * P.n_per)
    return false;
  int p = 0;
  for (int l = 0; l < P.n_lv; ++l) {
    Lv& L = P.lv[l];
    L.t = geo[at++];
    L.c = geo[at++];
    L.is_in = geo[at++];
    if (L.t < 1 || L.c < 1) return false;
  }
  for (int l = 0; l < P.n_lv; ++l) P.lv[l].y = ptrs[p++];
  for (int l = 0; l < P.n_lv; ++l) P.lv[l].da = static_cast<float*>(const_cast<void*>(ptrs[p++]));
  for (int l = 0; l < P.n_lv; ++l) P.lv[l].dyx = const_cast<void*>(ptrs[p++]);
  for (int i = 0; i < P.n_ed; ++i) {
    Ed& e = P.ed[i];
    e.src = geo[at++];
    e.c_in = geo[at++];
    e.t_src = geo[at++];
    e.k = geo[at++];
    e.s = geo[at++];
    e.d = geo[at++];
    e.pad = geo[at++];
    e.w = ptrs[p++];
    if (e.src < 0 || e.src >= P.n_lv || e.c_in < 1 || e.k < 1 || e.s < 1 || e.d < 1 ||
        e.pad < 0 || (e.s > 1 && e.d > 1) || e.w == nullptr ||
        (long)e.t_src * e.c_in != (long)P.lv[e.src].t * P.lv[e.src].c ||
        P.lv[e.src].y == nullptr)
      return false;
  }
  for (int i = 0; i < P.n_op; ++i) {
    OpD& op = P.op[i];
    op.out = geo[at++];
    op.res = geo[at++];
    op.act = geo[at++];
    op.e0 = geo[at++];
    op.ne = geo[at++];
    op.slope = slopes[i];
    op.bias = static_cast<const float*>(ptrs[p++]);
    if (op.out < 0 || op.out >= P.n_lv || P.lv[op.out].is_in || op.res < -1 ||
        op.res >= op.out || op.act < 0 || op.act > kLog || op.e0 < 0 || op.ne < 0 ||
        op.ne > kMaxOpEdges || op.e0 + op.ne > P.n_ed || (op.ne == 0 && op.res < 0) ||
        (op.act == kSquare && op.res < 0) || P.lv[op.out].y == nullptr)
      return false;
    for (int q = 0; q < op.ne; ++q)
      if (P.ed[op.e0 + q].src >= op.out) return false;
    if (op.res >= 0 && ((long)P.lv[op.res].t * P.lv[op.res].c <
                            (long)P.lv[op.out].t * P.lv[op.out].c ||
                        ((long)P.lv[op.res].t * P.lv[op.res].c) % P.lv[op.out].c != 0 ||
                        P.lv[op.res].y == nullptr))
      return false;
  }
  int ut = 0;
  P.n_u = units[ut++];
  P.n_ph = units[ut++];
  if (P.n_u < 0 || P.n_u > kMaxUnits || P.n_ph < 0 || P.n_ph > kMaxPhases ||
      (P.n_ph == 0) != (P.n_u == 0) || (pass == kDw && P.n_ph > 1))
    return false;
  for (int i = 0; i < P.n_ph; ++i) {
    P.ph_end[i] = units[ut++];
    if (P.ph_end[i] < (i > 0 ? P.ph_end[i - 1] : 0) || P.ph_end[i] > P.n_u) return false;
  }
  if (P.n_ph > 0 && P.ph_end[P.n_ph - 1] != P.n_u) return false;
  for (int i = 0; i < P.n_u; ++i) {
    Unit& U = P.u[i];
    const int* f = units + ut + i * kUnitInts;
    U.op = f[0];
    U.tn = f[1];
    U.tx = f[2];
    U.ty = f[3];
    U.cw = f[4];
    U.tiles = f[5];
    U.rt = f[6];
    U.ct = f[7];
    U.tgt = f[8];
    U.s = f[9];
    U.res = f[10];
    U.ne = f[11];
    for (int q = 0; q < kMaxOpEdges; ++q) U.e[q] = f[12 + q];
    U.lanes = f[16];
    U.rc = f[17];
    U.splits = f[18];
    U.split_rows = f[19];
    U.compact = f[20];
    U.out = const_cast<void*>(ptrs[p + i]);
    U.part = static_cast<float*>(const_cast<void*>(ptrs[p + P.n_u + i]));
    if (U.op < 0 || U.op >= P.n_op || U.tn < 1 || U.tn > 4 || U.tx < 1 || U.ty < 1 ||
        (long)U.tx * U.ty > kThreads || U.tiles < 0 || U.rt < 1 || U.ct < 1 || U.s < 1 ||
        U.ne < 0 || U.ne > kMaxOpEdges)
      return false;
    for (int q = 0; q < U.ne; ++q)
      if (U.e[q] < 0 || U.e[q] >= P.n_ed) return false;
    const bool ok = pass == kFwd ? fwd_unit_ok(P, U) : pass == kDx ? dx_unit_ok(P, U)
                                                                   : dw_unit_ok(P, U);
    if (!ok) return false;
  }
  if (pass != kFwd) {  // every op a unit runs reads its output's cotangent
    for (int i = 0; i < P.n_u; ++i)
      if (P.lv[P.op[P.u[i].op].out].da == nullptr) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Co-resident blocks per SM of pass `pass` (0 forward, 1 dx, 2 dW) in dtype
// (0 float32, 1 bfloat16) at the kernels' shared memory.
int hifigan_sg_blocks_per_sm(int dtype, int pass, int* out) {
  const void* fn = kernel_for(dtype, pass);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads, kSmemBytes);
  return static_cast<int>(err);
}

// One cooperative launch of pass `pass` over a segment, on `grid` blocks (at
// most the co-resident ones). geo: n_levels, n_edges, n_ops, batch, members,
// n_per, then per level t, c, is_input; per edge src, c_in, t_src, k, s, d,
// pad; per op out, res (-1: none), act, first edge, edges. units: n_units,
// n_phases, the phases' cumulative unit counts, then kUnitInts per unit (op,
// tn, tx, ty, cw, tiles, rt, ct, tgt, s, res, n_edges, 4 edge indices,
// lanes, rc, splits, split_rows, compact). slopes: per op. ptrs: per level its values,
// its fp32 cotangent slot, its dy (produced) or dx out (input); per edge its
// table; per op its bias; per unit its output and partials. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a plan it does not
// take).
int hifigan_sg_run(int dtype, int pass, const int* geo, const int* units, const float* slopes,
                   const void* const* ptrs, int grid, void* stream) {
  const void* fn = kernel_for(dtype, pass);
  static SegP P;  // host scratch: the launch copies it
  P = SegP{};
  if (fn == nullptr || grid < 1 || !read_plan(P, pass, geo, units, slopes, ptrs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure(fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&P};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params,
                                    static_cast<size_t>(kSmemBytes),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
