// The binomial observation weight of the particle filter's weighting step
// (phase pf_weight): one launch writes logw[chains, N] from the observed
// counts y[C], the states x[chains, N, C] and the reporting probability p (one
// value, or one per chain at p[chain * p_stride]):
//
//   logw[i] = combine over c of log Binomial(y[c] | x[i, c], p),
//
// combine "min" (the reference's weight) or "sum".  Its plain twin is
// epitpu_torch/observe/models.py:binom_logpmf followed by torch.amin or
// torch.sum over the last axis, which runs on the CPU and which the tests hold
// this kernel to.  It replaces no TPU kernel: epitpu leaves
// epitpu/observe/models.py:28-97 to XLA's fusion.  On the card the twin's
// plain torch form is about 150 elementwise launches a filter step.
//
// Bit identity with the twin on the card is the design rule.  Every value is
// computed by the float32 operations, in the order, that PyTorch's CUDA
// kernels perform for the twin's expressions (built with --fmad=false and no
// fast math, so nothing is contracted and logf / log1pf / division round as
// theirs do):
//  * a tensor divided by a Python number is a product with the float32
//    reciprocal (ATen's div_true_kernel_cuda for a CPU scalar): inv2 / 1260.0
//    is inv2 * (1.0f / 1260.0f), ej / (2j + 1) is ej * (1.0f / (2j + 1));
//  * a Python number divided by a tensor is reciprocal(t) * number
//    (Tensor.__rdiv__): 1.0 / x is (1.0f / x) * 1.0f;
//  * constant arithmetic on the Python side happens in double, and each
//    number enters an operation as float32: 2.0 * math.pi * kk is
//    kk * (float)(2 pi);
//  * torch.clamp keeps NaN and clamps with float32 bounds;
//  * torch.where selects: a branch here returns the value of the branch the
//    twin's where chain selects, and only that branch is computed;
//  * the reduction over c follows ATen's row reduction (Reduce.cuh) for a row
//    of C < 64 contiguous elements: W = the largest power of two <= C lanes
//    (at most 32), lane t folds elements t, t + W, ... each into its own
//    accumulator started at the identity and combines them in order, then the
//    W lanes meet in the warp's tree (shfl_down by W/2, W/4, ..., 1).  So "min" is
//    torch.amin's NaN-propagating (isnan(a) || a < b) ? a : b from +inf, and
//    "sum" adds from 0 in that order.  Rows of 64 to 127 elements take the same
//    order in torch when there are at least 16 rows (fewer rows give torch a
//    wider block; from 128 it vectorizes its loads); no model of the port
//    observes that many compartments.
//
// What bounds it: one pass over the cloud, 4 C + 4 bytes a particle (12 B
// read and 4 B written at C = 3: 0.5 MB at 2,048 x 16 and 2.1 MB at
// 32 x 4,096, 0.16 and 0.63 us at 3.35 TB/s), and about 150 float operations a
// compartment (15 and 59 M, 0.4 and 1.8 us at 33.5 T op/s): operations, by a
// little.  Why one thread a particle: a particle's work is a fixed short loop
// over its C compartments with no data shared between particles, so there is
// nothing to exchange between threads, and everything stays in registers (no
// shared memory, no atomics).  256 threads a block.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 127;  // epitpu_torch/ops/obs_cuda.py:MAX_COMPARTMENTS

// the twin's numbers, each rounded to float32 as it enters its operation
constexpr float kPsLo = static_cast<float>(1e-10);
constexpr float kPsHi = static_cast<float>(1.0 - 1e-7);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kInv12 = static_cast<float>(1.0 / 12.0);
constexpr float kInv360 = static_cast<float>(1.0 / 360.0);
constexpr float kRecip1260 = 1.0f / 1260.0f;
constexpr float kTenth = static_cast<float>(0.1);

// v != v: NaN (no fast math)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// models.py:_stirling_delta
__device__ __forceinline__ float stirling_delta(float x) {
  const float inv = (1.0f / x) * 1.0f;
  const float inv2 = inv * inv;
  return inv * (kInv12 - inv2 * (kInv360 - inv2 * kRecip1260));
}

// models.py:_bd0; the series' terms ej / (2j + 1), j = 1..7, as products
__device__ __forceinline__ float bd0(float x, float m) {
  const float d = x - m;
  const float s = x + m;
  if (fabsf(d) <= s * kTenth) {
    const float v = d / s;
    const float v2 = v * v;
    float acc = d * v;
    float ej = (x * 2.0f) * v;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      ej = ej * v2;
      acc = acc + ej * (1.0f / static_cast<float>(2 * j + 1));
    }
    return acc;
  }
  return ((x * logf(x / m)) + m) - x;
}

// models.py:binom_logpmf of one compartment: k observed, n the state, pc the
// probability clamped to [0, 1], ps clamped to [1e-10, 1 - 1e-7]; the twin's
// where chain from its last where inwards
__device__ __forceinline__ float binom_logpmf(float k, float n, float pc, float ps) {
  const float neg_inf = -INFINITY;
  if (!((k >= 0.0f) && (k <= n))) return neg_inf;
  if (pc == 1.0f) return k == n ? 0.0f : neg_inf;
  if (pc == 0.0f) return k == 0.0f ? 0.0f : neg_inf;
  if (n == 0.0f) return k == 0.0f ? 0.0f : neg_inf;
  if (k == n) return n * logf(ps);
  if (k == 0.0f) return n * log1pf(-ps);
  const float kk = clamp_min(k, 1.0f);
  const float nk = clamp_min(n - k, 1.0f);
  float t = (stirling_delta(n) - stirling_delta(kk)) - stirling_delta(nk);
  t = t + logf(n / ((kk * kTwoPi) * nk)) * 0.5f;
  t = t - bd0(kk, n * ps);
  return t - bd0(nk, n * (1.0f - ps));
}

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  if (kMin) return (a != a || a < b) ? a : b;
  return a + b;
}

// lane t's share of the row in ATen's order: elements t, t + W, t + 2W, t + 3W
// (those below c), each in its own accumulator from the identity, combined in order
template <int W, bool kMin>
__device__ __forceinline__ float lane_part(int t, const float* __restrict__ x,
                                           const float* __restrict__ y, int c, float pc,
                                           float ps) {
  const float ident = kMin ? INFINITY : 0.0f;
  float part = ident;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = t + i * W;
    const float acc = e < c ? combine<kMin>(ident, binom_logpmf(y[e], x[e], pc, ps)) : ident;
    part = i == 0 ? acc : combine<kMin>(part, acc);
  }
  return part;
}

// the warp's shuffle tree: at each offset (W/2, W/4, ..., 1) lane t takes
// lane t + offset as the second operand; unrolled, so the parts stay in registers
template <int kOffset, bool kMin, int W>
__device__ __forceinline__ void shuffle_tree(float (&part)[W]) {
  if constexpr (kOffset > 0) {
#pragma unroll
    for (int t = 0; t < kOffset; ++t) part[t] = combine<kMin>(part[t], part[t + kOffset]);
    shuffle_tree<kOffset / 2, kMin>(part);
  }
}

// one particle's weight from its row of C states, in ATen's order
template <int W, bool kMin>
__device__ __forceinline__ float weigh_row(const float* __restrict__ y,
                                           const float* __restrict__ row, int c, float p) {
  const float pc = clamp(p, 0.0f, 1.0f);
  const float ps = clamp(pc, kPsLo, kPsHi);
  float part[W];
#pragma unroll
  for (int t = 0; t < W; ++t) part[t] = lane_part<W, kMin>(t, row, y, c, pc, ps);
  shuffle_tree<W / 2, kMin>(part);
  return part[0];
}

template <int W, bool kMin>
__global__ void __launch_bounds__(kThreads)
    obs_binomial_kernel(const float* __restrict__ y, const float* __restrict__ x,
                        const float* __restrict__ p, long long p_stride,
                        float* __restrict__ out, long long rows, long long n_per_chain, int c) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows) return;
  out[i] = weigh_row<W, kMin>(y, x + i * c, c, p[(i / n_per_chain) * p_stride]);
}

template <int W>
void launch_width(bool use_min, const float* y, const float* x, const float* p,
                  long long p_stride, float* out, long long rows, long long n_per_chain, int c,
                  int blocks, cudaStream_t stream) {
  if (use_min) {
    obs_binomial_kernel<W, true><<<blocks, kThreads, 0, stream>>>(y, x, p, p_stride, out, rows,
                                                                  n_per_chain, c);
  } else {
    obs_binomial_kernel<W, false><<<blocks, kThreads, 0, stream>>>(y, x, p, p_stride, out, rows,
                                                                   n_per_chain, c);
  }
}

}  // namespace

// One launch over rows = chains * N particles on the caller's stream; combine
// 0 = min, 1 = sum.  Returns a cudaError_t: cudaErrorInvalidValue for
// arguments out of range, else cudaGetLastError() after the launch.
extern "C" int epi_obs_binomial(const void* y, const void* x, const void* p,
                                long long p_stride, void* out, long long rows,
                                long long n_per_chain, int c, int combine_mode, void* stream) {
  if (rows < 0 || c < 1 || c > kMaxC || p_stride < 0 || (rows > 0 && n_per_chain < 1) ||
      (combine_mode != 0 && combine_mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* yf = static_cast<const float*>(y);
  const auto* xf = static_cast<const float*>(x);
  const auto* pf = static_cast<const float*>(p);
  auto* of = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool use_min = combine_mode == 0;
  const int b = static_cast<int>(blocks);
  // W: the largest power of two <= c, at most a warp
  if (c >= 32) {
    launch_width<32>(use_min, yf, xf, pf, p_stride, of, rows, n_per_chain, c, b, s);
  } else if (c >= 16) {
    launch_width<16>(use_min, yf, xf, pf, p_stride, of, rows, n_per_chain, c, b, s);
  } else if (c >= 8) {
    launch_width<8>(use_min, yf, xf, pf, p_stride, of, rows, n_per_chain, c, b, s);
  } else if (c >= 4) {
    launch_width<4>(use_min, yf, xf, pf, p_stride, of, rows, n_per_chain, c, b, s);
  } else if (c >= 2) {
    launch_width<2>(use_min, yf, xf, pf, p_stride, of, rows, n_per_chain, c, b, s);
  } else {
    launch_width<1>(use_min, yf, xf, pf, p_stride, of, rows, n_per_chain, c, b, s);
  }
  return static_cast<int>(cudaGetLastError());
}
