// One conv1d + bias + leaky-ReLU layer, forward and input gradient, for
// Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces hifigan_tpu/ops/pallas/msd_conv.py::msd_conv1d_lrelu (:191): the
// tap-loop kernel _tapconv_pallas (:77, Pallas call :96) that computes the
// forward, and the same kernel reused on the masked cotangent for dx
// (:165). Driven from hifigan_tpu_torch/ops/msd_conv.py, one entry call per
// conv and pass:
//
//   forward  y[n,t,c]  = act(b[c] + sum_{k,i} x[n, t*s + k*d - pad, g*ci_g+i] * W[k,i,c])
//   dx       dx[n,u,i] = sum_{k,o: t*s + k*d - pad = u} dz[n,t,g*co_g+o] * W[k,i,g*co_g+o]
//
// with act(z) = z >= 0 ? z : slope*z (slope 1 is no activation) and either
// the stride s or the dilation d equal to 1. The forward adds the bias in
// fp32 and rounds after the activation. The dx entry first forms the
// masked cotangent once per element, in the cotangent's type as the Pallas
// backward forms it (:140-143):
//
//   dz = round(dy * (y >= 0 ? 1 : slope_r))     slope_r = slope rounded to that type,
//
// then sums dx in fp32 and rounds it to the input's type. The weight and
// bias gradients are PyTorch products in the wrapper, as they are XLA
// einsums outside the Pallas call in JAX.
//
// What bounds it: operations. A V1 MSD traversal at B=16 x 8192 samples is
// ~7.1e10 FLOP a pass for ~0.2 GB of activations, far above the H100's
// ridge; the distillation's convs (k3 at 4-1092 channels) likewise.
//
// Design: the implicit-GEMM core of conv_core.cuh, shared with the conv
// stack (csrc/conv_stack.cu) and given its dilation here: tensor cores
// (3xTF32 in fp32, bf16 mma in bf16), each tile's input window staged once
// for all taps, the weights through a cp.async ring, dx per output phase.
// One input or output channel per group (conv_0, conv_post, some
// distillation convs) or a reduction shorter than one k-step takes the
// core's SIMT path. The TPU kernel's phase folding into (B, G, U, s*C'),
// group densification and weight-block tiling are VMEM devices and are not
// carried over.

#include "conv_core.cuh"

namespace {

using conv_core::bf16;
using conv_core::Geom;
using conv_core::from_f;
using conv_core::kThreads;
using conv_core::rnd;
using conv_core::to_f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mask_kernel(const T* __restrict__ dy, const T* __restrict__ y, float slope, long total,
                T* __restrict__ dz) {
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kThreads) {
    float v = to_f(dy[i]);
    if (slope != 1.f && to_f(y[i]) < 0.f) v = rnd<T>(v * slope);
    dz[i] = from_f<T>(v);
  }
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its launches.
// x (n, t_in, c_in), w (k, c_in/groups, c_out), bias (c_out,) fp32 or null,
// y (n, t_out, c_out), all contiguous, in the working type but bias.
// body 0: SIMT with `lanes` threads an output; body 1: tensor cores, tile
// bm x bn, reduction channel chunks of kc, smem the plan's bytes
// (ops/conv_stack.py::plan_conv).
int hifigan_msd_fwd(int dtype, const void* x, const void* w, const float* bias, void* y, int n,
                    int t_in, int c_in, int t_out, int c_out, int k, int s, int d, int groups,
                    int pad_l, float slope, int body, int bm, int bn, int kc, int smem, int lanes,
                    void* stream) {
  const Geom G = conv_core::make_geom(n, t_in, c_in, t_out, c_out, k, s, d, groups, pad_l, slope);
  if (!conv_core::geom_ok(G)) return kBad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv_core::launch_fwd<float>(G, x, w, bias, y, body, bm, bn, kc, smem, lanes, st);
  if (dtype == 1)
    return conv_core::launch_fwd<bf16>(G, x, w, bias, y, body, bm, bn, kc, smem, lanes, st);
  return kBad;
}

// dx (n, t_in, c_in) in the working type <- the input gradient for the output
// cotangent dy and the saved output y (both (n, t_out, c_out)); slope is the
// leaky-ReLU slope rounded to the working type (1 = no activation). dz
// (n, t_out, c_out) is scratch for the masked cotangent; wt is w transposed
// to (k, c_out, c_in/groups) (null for the SIMT body).
int hifigan_msd_dx(int dtype, const void* dy, const void* y, const void* w, const void* wt,
                   void* dz, void* dx, int n, int t_in, int c_in, int t_out, int c_out, int k,
                   int s, int d, int groups, int pad_l, float slope, int body, int bm, int bn,
                   int kc, int smem, int lanes, void* stream) {
  const Geom G = conv_core::make_geom(n, t_in, c_in, t_out, c_out, k, s, d, groups, pad_l, slope);
  if (!conv_core::geom_ok(G) || dz == nullptr || (dtype != 0 && dtype != 1)) return kBad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long total = (long)n * t_out * c_out;
  const unsigned blocks = conv_core::ucdiv(total, kThreads);
  const unsigned grid = blocks < 8192u ? blocks : 8192u;
  if (dtype == 0) {
    mask_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(dy),
                                                  static_cast<const float*>(y), slope, total,
                                                  static_cast<float*>(dz));
  } else {
    mask_kernel<bf16><<<grid, kThreads, 0, st>>>(static_cast<const bf16*>(dy),
                                                 static_cast<const bf16*>(y), slope, total,
                                                 static_cast<bf16*>(dz));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0)
    return conv_core::launch_dx<float, float>(G, dz, w, wt, dx, body, bm, bn, kc, smem, lanes, st);
  return conv_core::launch_dx<bf16, bf16>(G, dz, w, wt, dx, body, bm, bn, kc, smem, lanes, st);
}

}  // extern "C"
