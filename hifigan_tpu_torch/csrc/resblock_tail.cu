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
// above the H100's ridge (~295 FLOP/byte in bf16, ~49 in fp32 as 3xTF32).
//
// Two bodies, chosen by the storage type (the wrapper passes it
// explicitly):
//
// fp32 -- the 3xTF32 body (hifigan_mrf_stage_f32): the bf16 body's schedule
// with the fp32 product of csrc/conv_core.cuh on the tensor cores.
// - Schedule: one persistent cooperative launch per stage. A first phase
//   writes lrelu(0.1)(x) to a plane of its own (with a folded upsampler:
//   lrelu of the stage input, then an upsampling phase that stores the
//   upsampled x and its lrelu). Phase j then computes conv j of every
//   resblock over the whole sequence (the widest kernels first), a
//   grid-wide barrier after each; then the fp32 mean over resblocks and,
//   with the post conv, one more barrier and phase. No halo is recomputed
//   and every SM gets work at B=1.
// - Every conv reads a plane that is already activated, so the core's
//   forward tile (conv_core::tap_conv) stages it as it is: 128 output rows
//   (a tile may cross batch rows) x 16, 32 or 64 columns; the input window
//   staged once per chunk of up to 64 channels for all taps, zero outside
//   the sequence ('same' padding) and past C (any width); the taps'
//   weights through a 3-stage cp.async ring of 32 reduction rows. 3xTF32:
//   hi/lo split as each fragment is loaded, each ring stage summed into a
//   zeroed partial and added with IEEE adds (conv_core::promote), since
//   V1 stage 0 reduces over 11 x 256 terms.
// - The epilogue adds the bias (and the residual at a pair's last conv)
//   and stores what the later phases read: the output's lrelu(0.1) into
//   the resblock's other activated plane and, at a pair's last conv, h in
//   place (each element read and written by one thread).
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

#include "conv_core.cuh"

// ---------------------------------------------------------------------------
// fp32 3xTF32 body
// ---------------------------------------------------------------------------
namespace {
namespace f32 {

namespace cc = conv_core;
namespace cg = cooperative_groups;

constexpr int kBM = 128;  // output rows of a conv tile (across batch rows)

struct Args {
  const float* x;       // (B, T, C), or (B, T_in, cin) with pre_w
  const float* w;       // every conv's (K, C, C) taps, concatenated
  const float* bias;    // (n_conv, C)
  const int* desc;      // per conv: k, dilation, offset of its taps in w
  const float* post_w;  // (7, C) or null
  const float* post_b;  // (1,)
  float* y;             // (B, T, C), or (B, T) with post
  float* scratch;       // see hifigan_mrf_stage_f32
  const float* pre_w;   // (u, taps, cin, C) phase-split upsampler taps, or null
  const float* pre_b;   // (C,)
  int batch, seq, C, n_rb, convs_per_rb, pair_size, kc;
  int cin, kc_in, stride, taps, pre_pad, seq_in;
};

// A scratch plane holds B*T*C floats, rounded up to 16 bytes
__host__ __device__ inline long plane_floats(int batch, int seq, int C) {
  return ((long)batch * seq * C + 3) & ~3L;
}

// The core's forward geometry of a stride-1 conv over (n, t, c_in) rows
__host__ __device__ inline cc::Geom geom(int n, int t, int c_in, int c_out, int k, int d, int pad) {
  cc::Geom G;
  G.n = n;
  G.t_in = t;
  G.c_in = c_in;
  G.t_out = t;
  G.c_out = c_out;
  G.k = k;
  G.s = 1;
  G.d = d;
  G.groups = 1;
  G.pad_l = pad;
  G.ci_g = c_in;
  G.co_g = c_out;
  G.slope = 1.f;
  return G;
}

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : v * slope; }

// acc <- the kBM x BN tile at rows [m0, m0 + kBM) of the n * t rows and
// columns [n0, n0 + BN): tap q of output row t reads source row t + q*d +
// shift of src (already activated), zeros outside [0, t) and past c_in.
template <int BN>
__device__ __forceinline__ void conv_tile(
    float (&acc)[cc::Warps<kBM, BN>::MT][cc::Warps<kBM, BN>::NT][4], const cc::Geom& G, int kc,
    const float* src, const float* w, int shift, int m0, int n0, unsigned char* smem) {
  const cc::WinPlan P = cc::win_plan(G, false, true, kBM, BN, kc);
  cc::TapArgs t;
  t.src = src;
  t.t_src = G.t_in;
  t.c_src = G.c_in;
  t.ch_base = 0;
  t.rows = G.t_out;
  t.M = G.n * G.t_out;
  t.Lv = G.t_out + P.E;
  t.shift = shift;
  t.ntaps = G.k;
  t.tap_dir = 1;
  t.w = w;
  t.tap_base = 0;
  t.tap_step = 1;
  t.rows_per_tap = G.c_in;
  t.row_off = 0;
  t.ld = G.c_out;
  t.col0 = n0;
  t.valid_cols = G.c_out - n0;
  t.a_aligned = G.c_in % 4 == 0;
  t.b_aligned = G.c_out % 4 == 0;
  __syncthreads();  // the block's previous tile is done with shared memory
  cc::tap_conv<float, kBM, BN>(acc, G, P, t, m0, smem);
}

// conv_post (k7, C -> 1) + tanh of one output sample, by one warp: the
// lrelu(0.01) of the mean m (B's (T, C) plane) at rows [g - 3, g + 3],
// zero outside the sequence.
__device__ __forceinline__ float post_sample(const float* pw, float pb, int C, int lane,
                                             const float* m, int g, int seq) {
  float s = 0.f;
  for (int idx = lane; idx < 7 * C; idx += 32) {
    const int tap = idx / C, c = idx - tap * C, gg = g + tap - 3;
    const float v = (gg >= 0 && gg < seq) ? lrelu(m[(long)gg * C + c], 0.01f) : 0.f;
    s = fmaf(v, pw[idx], s);
  }
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  return tanhf(s + pb);
}

// MINB blocks share an SM where the phases have the tiles for it (the host
// picks it, and a channel chunk whose shared memory lets them fit).
template <int BN, int MINB>
__global__ void __launch_bounds__(cc::kThreads, MINB) mrf_stage_f32_kernel(Args a) {
  using W = cc::Warps<kBM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int C = a.C, seq = a.seq, M = a.batch * seq;
  const long plane = plane_floats(a.batch, seq, C), n_el = (long)M * C;
  const long gtid = (long)blockIdx.x * cc::kThreads + threadIdx.x;
  const long gstride = (long)gridDim.x * cc::kThreads;
  const int n_tiles = cc::cdiv(C, BN);
  const bool pre = a.pre_w != nullptr, post = a.post_w != nullptr;
  float* ax = a.scratch;     // lrelu(0.1) of x
  float* rbs = ax + plane;   // per resblock: h, then its two activated planes
  float* mean = post ? rbs + 3L * a.n_rb * plane : a.y;
  float* up = rbs + (3L * a.n_rb + (post ? 1 : 0)) * plane;  // with pre: the upsampled x
  const float* x = pre ? up : a.x;

  if (pre) {
    // lrelu of the stage input, then output phase p of rows m*u + p
    float* xa = up + plane;
    const long n_in = (long)a.batch * a.seq_in * a.cin;
    for (long e = gtid; e < n_in; e += gstride) xa[e] = lrelu(a.x[e], 0.1f);
    grid.sync();
    const cc::Geom G = geom(a.batch, a.seq_in, a.cin, C, a.taps, 1, 0);
    const int m_in = a.batch * a.seq_in, per_phase = cc::cdiv(m_in, kBM) * n_tiles;
    for (int item = blockIdx.x; item < a.stride * per_phase; item += gridDim.x) {
      const int p = item / per_phase, rest = item - p * per_phase;
      const int m0 = (rest / n_tiles) * kBM, n0 = (rest % n_tiles) * BN;
      const int off = (p + a.pre_pad) / a.stride - (a.taps - 1);
      float acc[W::MT][W::NT][4];
      conv_tile<BN>(acc, G, a.kc_in, xa, a.pre_w + (long)p * a.taps * a.cin * C, off, m0, n0,
                    smem);
#pragma unroll
      for (int i = 0; i < W::MT; ++i)
#pragma unroll
        for (int j = 0; j < W::NT; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int m = m0 + cc::frag_row<kBM, BN>(i, v), col = n0 + cc::frag_col<kBM, BN>(j, v);
            if (m >= m_in || col >= C) continue;
            const int b = m / a.seq_in;
            const long idx = ((long)b * seq + (long)(m - b * a.seq_in) * a.stride + p) * C + col;
            const float val = acc[i][j][v] + a.pre_b[col];
            up[idx] = val;
            ax[idx] = lrelu(val, 0.1f);
          }
    }
  } else {
    for (long e = gtid; e < n_el; e += gstride) ax[e] = lrelu(a.x[e], 0.1f);
  }
  grid.sync();

  // phase j: conv j of every resblock. act: the activated plane conv j
  // reads (0 = ax, 1 or 2 = the resblock's); h_is_x: h is still x.
  int act = 0;
  bool h_is_x = true;
  const int per_rb = cc::cdiv(M, kBM) * n_tiles;
  for (int j = 0; j < a.convs_per_rb; ++j) {
    const bool last = j % a.pair_size == a.pair_size - 1, final_conv = j == a.convs_per_rb - 1;
    const int dst_act = act == 1 ? 2 : 1;
    for (int item = blockIdx.x; item < a.n_rb * per_rb; item += gridDim.x) {
      const int rb = a.n_rb - 1 - item / per_rb;  // the widest kernels first
      const int rest = item % per_rb;
      const int m0 = (rest / n_tiles) * kBM, n0 = (rest % n_tiles) * BN;
      const int* dsc = a.desc + 3 * (rb * a.convs_per_rb + j);
      const int k = dsc[0], d = dsc[1], r = (k - 1) * d / 2;
      float* h = rbs + 3L * rb * plane;
      const float* src = act == 0 ? ax : h + act * plane;
      float* dst = h + dst_act * plane;
      const float* res = h_is_x ? x : h;
      const float* bias = a.bias + (long)(rb * a.convs_per_rb + j) * C;
      float acc[W::MT][W::NT][4];
      conv_tile<BN>(acc, geom(a.batch, seq, C, C, k, d, r), a.kc, src, a.w + dsc[2], -r, m0, n0,
                    smem);
#pragma unroll
      for (int i = 0; i < W::MT; ++i)
#pragma unroll
        for (int jj = 0; jj < W::NT; ++jj)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int m = m0 + cc::frag_row<kBM, BN>(i, v), col = n0 + cc::frag_col<kBM, BN>(jj, v);
            if (m >= M || col >= C) continue;
            const long idx = (long)m * C + col;
            float val = acc[i][jj][v] + bias[col];
            if (last) {
              val = res[idx] + val;
              h[idx] = val;
              if (!final_conv) dst[idx] = lrelu(val, 0.1f);
            } else {
              dst[idx] = lrelu(val, 0.1f);
            }
          }
    }
    act = dst_act;
    if (last) h_is_x = false;
    grid.sync();
  }

  // mean over resblocks, in fp32 and resblock order
  const float n_rb = static_cast<float>(a.n_rb);
  for (long e = gtid; e < n_el; e += gstride) {
    float s = 0.f;
    for (int r = 0; r < a.n_rb; ++r) s += rbs[3L * r * plane + e];
    mean[e] = s / n_rb;
  }
  if (!post) return;
  grid.sync();
  const float pb = a.post_b[0];
  const int lane = threadIdx.x % 32;
  for (long row = gtid / 32; row < M; row += gstride / 32) {
    const long b = row / seq;
    const int t = static_cast<int>(row % seq);
    const float v = post_sample(a.post_w, pb, C, lane, mean + b * seq * C, t, seq);
    if (lane == 0) a.y[row] = v;
  }
}

// The column tile for width C (ops/resblock_tail.py::f32_tiling)
inline int tile_n(int C) { return C <= 16 ? 16 : C <= 32 ? 32 : 64; }

const void* kernel_for(int bn, int minb) {
  if (minb != 1 && minb != 2) return nullptr;
  switch (bn) {
    case 16:
      return minb == 1 ? reinterpret_cast<const void*>(mrf_stage_f32_kernel<16, 1>)
                       : reinterpret_cast<const void*>(mrf_stage_f32_kernel<16, 2>);
    case 32:
      return minb == 1 ? reinterpret_cast<const void*>(mrf_stage_f32_kernel<32, 1>)
                       : reinterpret_cast<const void*>(mrf_stage_f32_kernel<32, 2>);
    case 64:
      return minb == 1 ? reinterpret_cast<const void*>(mrf_stage_f32_kernel<64, 1>)
                       : reinterpret_cast<const void*>(mrf_stage_f32_kernel<64, 2>);
    default: return nullptr;
  }
}

// Shared memory (bytes) of the fp32 body: the most any of its convs' tiles
// needs (the core's forward window plan), or -1 where a conv's geometry or
// channel chunk is one the core does not take (ops/resblock_tail.py::f32_smem).
// desc_host: per conv (k, dilation, offset), as desc.
int stage_smem(int batch, int seq, int C, int kc, const int* desc_host, int n_conv, int cin,
               int kc_in, int taps, int seq_in) {
  const int bn = tile_n(C);
  int smem = 0;
  for (int i = 0; i <= n_conv; ++i) {
    cc::Geom G;
    int chunk = kc;
    if (i < n_conv) {
      const int k = desc_host[3 * i], d = desc_host[3 * i + 1];
      if (k < 1 || d < 1) return -1;
      G = geom(batch, seq, C, C, k, d, (k - 1) * d / 2);
    } else if (cin > 0) {
      G = geom(batch, seq_in, cin, C, taps, 1, 0);
      chunk = kc_in;
    } else {
      break;
    }
    if (!cc::geom_ok(G) || !cc::kc_ok(G, false, true, chunk)) return -1;
    const cc::WinPlan P = cc::win_plan(G, false, true, kBM, bn, chunk);
    smem = P.smem > smem ? P.smem : smem;
  }
  return smem;
}

}  // namespace f32
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

// The fp32 3xTF32 body, launched cooperatively: grid at most the
// co-resident blocks (else cudaErrorCooperativeLaunchTooLarge). desc_host
// is a host copy of desc; kc (and with pre_w, kc_in) the channels of a
// reduction chunk; minb (1 or 2) the blocks an SM the kernel is compiled
// for; smem must be f32::stage_smem's value. scratch holds
// (1 + 3 * n_rb + (post_w != null) + (pre_w != null)) planes of
// f32::plane_floats floats, then with pre_w batch * (seq / stride) * cin
// more. With pre_w (the folded upsampler's phase-split taps) x is
// (batch, seq / stride, cin). Returns the cudaError_t of the launch.
int hifigan_mrf_stage_f32(const void* x, const void* w, const void* bias, const int* desc,
                          const int* desc_host, const void* post_w, const void* post_b,
                          const void* pre_w, const void* pre_b, void* y, void* scratch, int batch,
                          int seq, int C, int n_rb, int convs_per_rb, int pair_size, int kc,
                          int minb, int grid, int smem, int cin, int kc_in, int stride, int taps,
                          int pre_pad, void* stream) {
  const bool pre = pre_w != nullptr;
  const void* fn = f32::kernel_for(f32::tile_n(C), minb);
  if (fn == nullptr || C < 1 || batch < 1 || seq < 1 || grid < 1 || n_rb < 1 || convs_per_rb < 1 ||
      pair_size < 1 || convs_per_rb % pair_size != 0 || desc_host == nullptr ||
      (pre && (cin < 1 || stride < 1 || seq % stride != 0 || taps < 1)) ||
      smem != f32::stage_smem(batch, seq, C, kc, desc_host, n_rb * convs_per_rb, pre ? cin : 0,
                              kc_in, taps, pre ? seq / stride : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  f32::Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.desc = desc;
  a.post_w = static_cast<const float*>(post_w);
  a.post_b = static_cast<const float*>(post_b);
  a.y = static_cast<float*>(y);
  a.scratch = static_cast<float*>(scratch);
  a.pre_w = static_cast<const float*>(pre_w);
  a.pre_b = static_cast<const float*>(pre_b);
  a.batch = batch;
  a.seq = seq;
  a.C = C;
  a.n_rb = n_rb;
  a.convs_per_rb = convs_per_rb;
  a.pair_size = pair_size;
  a.kc = kc;
  a.cin = pre ? cin : 0;
  a.kc_in = pre ? kc_in : 0;
  a.stride = pre ? stride : 1;
  a.taps = pre ? taps : 0;
  a.pre_pad = pre ? pre_pad : 0;
  a.seq_in = pre ? seq / stride : 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(conv_core::kThreads), params,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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

// Co-resident blocks per SM of the bf16 tensor-core kernel (f32_minb 0) or
// of the fp32 one compiled for f32_minb blocks an SM, for width C at this
// shared memory.
int hifigan_mrf_blocks_per_sm(int f32_minb, int C, int smem, int* out) {
  int bn, cpad, kc;
  tc_tiling(C, &bn, &cpad, &kc);
  const void* fn = f32_minb ? f32::kernel_for(f32::tile_n(C), f32_minb) : tc::kernel_for(bn, cpad);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = f32_minb ? conv_core::kThreads : tc::kThreads;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, smem);
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
