// Grouped, strided conv1d + bias + leaky-ReLU layers of the multi-scale
// discriminator (MSD layers 1-6 and conv_post), forward and backward, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces hifigan_tpu/ops/pallas/conv_stack.py::fused_conv_stack (:973):
// the forward _fwd_pallas (:374, Pallas call :407) and the fused backward
// _bwd_pallas (:596, Pallas call :685). The stack is driven layer by layer
// from hifigan_tpu_torch/ops/conv_stack.py; every layer's post-activation is
// an output of the function, so each layer is one entry call per pass.
//
// The backward forms the cotangent of the pre-activation ONCE per element
// and pass, in an elementwise kernel over the saved post-activation y:
//
//   dz = (dy + up) * (y >= 0 ? 1 : slope)      in fp32, stored rounded to the working type,
//
// up being the fp32 input-cotangent of the layer above; on a partial last
// row (a group time-fold's, lane_period > 0) dz is zeroed at the lanes the
// forward zeroed. db sums the fp32 dz
// per block of rows, and a second pass sums those partials in a fixed
// order; dx and dW read the rounded dz (the Pallas rounding point, :560).
// The dW entry forms dz and hands it to the dx entry of the same layer;
// a dx entry without it (no weight gradients) forms it itself.
//
// What bounds it: operations. A V1 train step (B=16, 8192 samples) runs
// ~1.1e12 FLOP through these kernels against a few hundred MB of
// activations: far above the H100's ridge, in fp32 and in bf16.
//
// Design: every pass is the implicit-GEMM core of conv_core.cuh on the
// tensor cores (3xTF32 in fp32, bf16 mma in bf16): the forward stages each
// tile's input window once and reads all 41 taps from it, the weights
// through a cp.async ring; dx per output phase over a window of dz; dW as
// a (tap, channel) x column GEMM reduced over (n, t) in a few large splits
// with a fixed-order sum. conv_post (one output channel) takes the core's
// SIMT path. The TPU kernel's lane folding, group densification, small-T
// tail batching and backward chunking are VMEM devices and are not carried
// over. Its zone form is: the host folds time into each group's lanes
// (ops/conv_stack.py::fold_group_zones) and hands these kernels banded
// grouped layers whose partial last row carries a lane mask (lane_period,
// lane_valid; conv_stack.py:97-114 and _apply_valid_mask :267), applied by
// the forward's epilogue and by dz.

#include "conv_core.cuh"

namespace {

using conv_core::bf16;
using conv_core::Geom;
using conv_core::from_f;
using conv_core::kThreads;
using conv_core::to_f;

// dz of rows [rb * rb_rows, ...) and columns [blockIdx.y * cw, ...): written
// rounded to the working type; with pdb, each column's fp32 sum over the
// block's rows at pdb[rb][c] (thread partials summed in a fixed order).
// Rows r with r % t_out == t_out - 1 keep dz only at the lanes c with
// c % lane_period < lane_valid when lane_period > 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dz_kernel(const T* __restrict__ dy, const float* __restrict__ up, const T* __restrict__ y,
              float slope, int rows, int C, int rb_rows, int t_out, int lane_period,
              int lane_valid, T* __restrict__ dz, float* __restrict__ pdb) {
  __shared__ float part[kThreads];
  const int cw = C < kThreads ? C : kThreads, nsub = kThreads / cw;
  const int tid = threadIdx.x, sub = tid / cw, col = blockIdx.y * cw + tid % cw;
  const bool active = sub < nsub && col < C;
  const bool cut_col = lane_period > 0 && col % lane_period >= lane_valid;
  const int r0 = blockIdx.x * rb_rows;
  const int r1 = r0 + rb_rows < rows ? r0 + rb_rows : rows;
  float acc = 0.f;
  if (active) {
    for (int r = r0 + sub; r < r1; r += nsub) {
      const long idx = (long)r * C + col;
      float v = 0.f;
      if (dy != nullptr) v += to_f(dy[idx]);
      if (up != nullptr) v += up[idx];
      if (slope != 1.f && to_f(y[idx]) < 0.f) v *= slope;
      if (cut_col && r % t_out == t_out - 1) v = 0.f;
      dz[idx] = from_f<T>(v);
      acc += v;
    }
  }
  if (pdb == nullptr) return;
  part[tid] = acc;
  __syncthreads();
  if (tid < cw && col < C) {
    float s = 0.f;
    for (int q = 0; q < nsub; ++q) s += part[q * cw + tid];
    pdb[(long)blockIdx.x * C + col] = s;
  }
}

template <typename T>
int launch_dz(const Geom& G, const void* dy, const float* up, const void* y, int rb_rows, void* dz,
              float* pdb, cudaStream_t st) {
  const int rows = G.n * G.t_out, C = G.c_out;
  const int cw = C < kThreads ? C : kThreads;
  const dim3 grid(conv_core::ucdiv(rows, rb_rows), conv_core::ucdiv(C, cw));
  dz_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(dy), up, static_cast<const T*>(y),
                                          G.slope, rows, C, rb_rows, G.t_out, G.lane_period,
                                          G.lane_valid, static_cast<T*>(dz), pdb);
  return static_cast<int>(cudaGetLastError());
}

Geom stack_geom(int n, int t_in, int c_in, int t_out, int c_out, int k, int s, int groups,
                int pad_l, float slope, int lane_period, int lane_valid) {
  Geom G = conv_core::make_geom(n, t_in, c_in, t_out, c_out, k, s, 1, groups, pad_l, slope);
  G.lane_period = lane_period;
  G.lane_valid = lane_valid;
  return G;
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launches.
// x (n, t_in, c_in), w (k, c_in/groups, c_out), bias (c_out,) fp32 or null,
// y (n, t_out, c_out), all contiguous, in the working type but bias.
// lane_period, lane_valid: the partial last row's lane mask (0, 0: none).
// body 0: SIMT with `lanes` threads an output; body 1: tensor cores, tile
// bm x bn, reduction channel chunks of kc, smem the plan's bytes.
int hifigan_conv_fwd(int dtype, const void* x, const void* w, const float* bias, void* y, int n,
                     int t_in, int c_in, int t_out, int c_out, int k, int s, int groups,
                     int pad_l, float slope, int lane_period, int lane_valid, int body, int bm,
                     int bn, int kc, int smem, int lanes, void* stream) {
  const Geom G = stack_geom(n, t_in, c_in, t_out, c_out, k, s, groups, pad_l, slope, lane_period,
                            lane_valid);
  if (!conv_core::geom_ok(G)) return kBad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv_core::launch_fwd<float>(G, x, w, bias, y, body, bm, bn, kc, smem, lanes, st);
  if (dtype == 1)
    return conv_core::launch_fwd<bf16>(G, x, w, bias, y, body, bm, bn, kc, smem, lanes, st);
  return kBad;
}

// da (n, t_in, c_in) fp32 <- the input cotangent of one layer. dz (n, t_out,
// c_out, working type) is given (dz_ready = 1, formed by the dW entry) or
// formed here from dy (working type, or null), up (fp32, or null) and the
// saved y into dz. w is (k, c_in/groups, c_out), wt the same transposed to
// (k, c_out, c_in/groups) (null for the SIMT body).
int hifigan_conv_dx(int dtype, const void* dy, const float* up, const void* y, const void* w,
                    const void* wt, void* dz, int dz_ready, float* da, int n, int t_in, int c_in,
                    int t_out, int c_out, int k, int s, int groups, int pad_l, float slope,
                    int lane_period, int lane_valid, int body, int bm, int bn, int kc, int smem,
                    int lanes, int rb_rows, void* stream) {
  const Geom G = stack_geom(n, t_in, c_in, t_out, c_out, k, s, groups, pad_l, slope, lane_period,
                            lane_valid);
  if (!conv_core::geom_ok(G) || dz == nullptr || (!dz_ready && dy == nullptr && up == nullptr) ||
      rb_rows < 1)
    return kBad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return kBad;
  if (!dz_ready) {
    const int rc = dtype == 0 ? launch_dz<float>(G, dy, up, y, rb_rows, dz, nullptr, st)
                              : launch_dz<bf16>(G, dy, up, y, rb_rows, dz, nullptr, st);
    if (rc != 0) return rc;
  }
  if (dtype == 0)
    return conv_core::launch_dx<float, float>(G, dz, w, wt, da, body, bm, bn, kc, smem, lanes, st);
  return conv_core::launch_dx<bf16, float>(G, dz, w, wt, da, body, bm, bn, kc, smem, lanes, st);
}

// dz (n, t_out, c_out) in the working type is formed from dy, up and y and
// kept for the layer's dx; pdb (nrb, c_out) fp32 holds the bias gradient's
// row-block partials, nrb = ceil(n * t_out / rb_rows). dw (k, c_in/groups,
// c_out) in the working type and db (c_out,) fp32; partial (splits,
// k*c_in/groups, c_out) fp32 scratch of the tensor-core body (tile 128 x bn,
// kc channels of a tap a row group), whose split sp sums rows
// m = n*t_out + t in [sp*split_rows, (sp+1)*split_rows).
int hifigan_conv_dw(int dtype, const void* x, const void* dy, const float* up, const void* y,
                    void* dz, float* pdb, int rb_rows, float* partial, void* dw, float* db, int n,
                    int t_in, int c_in, int t_out, int c_out, int k, int s, int groups, int pad_l,
                    float slope, int lane_period, int lane_valid, int body, int bn, int kc,
                    int splits, int split_rows, int smem, int lanes, void* stream) {
  const Geom G = stack_geom(n, t_in, c_in, t_out, c_out, k, s, groups, pad_l, slope, lane_period,
                            lane_valid);
  if (!conv_core::geom_ok(G) || (dy == nullptr && up == nullptr) || dz == nullptr ||
      pdb == nullptr || rb_rows < 1)
    return kBad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n * t_out, nrb = conv_core::cdiv(rows, rb_rows);
  if (dtype == 0) {
    const int rc = launch_dz<float>(G, dy, up, y, rb_rows, dz, pdb, st);
    if (rc != 0) return rc;
    return conv_core::launch_dw<float>(G, x, dz, pdb, nrb, partial, dw, db, body, bn, kc,
                                       splits, split_rows, smem, lanes, st);
  }
  if (dtype == 1) {
    const int rc = launch_dz<bf16>(G, dy, up, y, rb_rows, dz, pdb, st);
    if (rc != 0) return rc;
    return conv_core::launch_dw<bf16>(G, x, dz, pdb, nrb, partial, dw, db, body, bn, kc,
                                      splits, split_rows, smem, lanes, st);
  }
  return kBad;
}

}  // extern "C"
