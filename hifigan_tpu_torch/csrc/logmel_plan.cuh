// The log-mel kernel's FFT plan, shared by csrc/logmel.cu and by a CPU test
// that compiles this header with a host compiler (tests/test_torch_logmel.py):
// the pass plan, the Bluestein length, the shared memory of the FFT body,
// and the odd-prime butterflies' rotations. hifigan_tpu_torch/ops/logmel.py
// mirrors each function (fft_passes, bluestein_length, fft_smem_bytes); the
// kernel's entry refuses any other plan or shared-memory size, so a drift
// shows as an invalid-value error.
#pragma once

namespace logmel_plan {

constexpr int kMaxPasses = 16;

struct FftPlan {
  int passes;
  int radix[kMaxPasses];
};

// The pass plan of an n-point transform: radix 13s, 11s, 7s, 5s, then 3s,
// then a radix 2 when the power of two is odd, then radix 4s. False unless
// n = 2^a 3^b 5^c 7^d 11^e 13^f >= 2 (2^a 3^b 5^c when `primes` is false).
inline bool fft_plan(int n, FftPlan* p, bool primes = true) {
  const int odd[5] = {13, 11, 7, 5, 3};
  int m = n, count[5] = {0, 0, 0, 0, 0}, a = 0;
  for (int i = primes ? 0 : 3; i < 5; ++i)
    while (m > 1 && m % odd[i] == 0) m /= odd[i], ++count[i];
  while (m > 1 && m % 2 == 0) m /= 2, ++a;
  int passes = a % 2 + a / 2;
  for (int i = 0; i < 5; ++i) passes += count[i];
  if (n < 2 || m != 1 || passes > kMaxPasses) return false;
  p->passes = 0;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < count[i]; ++j) p->radix[p->passes++] = odd[i];
  if (a % 2) p->radix[p->passes++] = 2;
  for (int j = 0; j < a / 2; ++j) p->radix[p->passes++] = 4;
  return true;
}

// Bluestein's transform length for n points: the smallest 2^a 3^b 5^c >= 2 n - 1.
inline int bluestein_length(int n) {
  FftPlan p;
  int m = 2 * n - 1;
  while (!fft_plan(m, &p, false)) ++m;
  return m;
}

// Shared memory of an FFT body in floats: the tile's (frames - 1) hop + n_fft
// samples (rounded up to 4), then two ping-pong buffers of frames / 2
// complex sequences of `length` points (n_fft, or Bluestein's length).
inline long long smem_floats(int hop, int n_fft, int length, int frames) {
  const long long sig = ((long long)(frames - 1) * hop + n_fft + 3) / 4 * 4;
  return sig + 2LL * (frames / 2) * length * 2;
}

}  // namespace logmel_plan

// cos and sin of 2 pi m / p for m = 1 .. (p - 1) / 2, the rows of the
// radix-p butterflies' rotation tables (float64 values; the compiler rounds
// them to fp32).
#define LOGMEL_ROT7                                                        \
  {0.62348980185873359f, -0.22252093395631434f, -0.90096886790241903f},   \
  {0.78183148246802980f, 0.97492791218182362f, 0.43388373911755823f}
#define LOGMEL_ROT11                                                       \
  {0.84125353283118121f, 0.41541501300188644f, -0.14231483827328500f,     \
   -0.65486073394528499f, -0.95949297361449737f},                         \
  {0.54064081745559756f, 0.90963199535451833f, 0.98982144188093280f,      \
   0.75574957435425827f, 0.28173255684142967f}
#define LOGMEL_ROT13                                                       \
  {0.88545602565320991f, 0.56806474673115592f, 0.12053668025532301f,      \
   -0.35460488704253545f, -0.74851074817110119f, -0.97094181742605201f},  \
  {0.46472317204376851f, 0.82298386589365635f, 0.99270887409805397f,      \
   0.93501624268541483f, 0.66312265824079519f, 0.23931566428755768f}
