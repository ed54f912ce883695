// The particle filter's likelihood update (phase pf_loglik): one launch takes,
// for every row (one chain's N particles), the step's log-weights logw[rows, N],
// the carried normalized log-weights lw[rows, N] (weight-carrying form only)
// and the running log-likelihood log_z[rows], and writes
//
//   s     = lw + logw                (carry form)  or  logw  (always-resample form)
//   lse   = log(sum exp(s - m0)) + m0,  m = max(s) (NaN propagates),
//           m0 = 0 where |m| is inf, else m
//   degen = !isfinite(lse)
//   log_z'= degen ? -inf : log_z + lse          (carry form)
//           degen ? -inf : (log_z + lse) - log N (always-resample form)
//   lw'   = degen ? -log N : s - lse             (carry form only)
//
// as epitpu_torch/smc/filter.py did with torch.logsumexp and four torch.where
// (the formula of epitpu/smc/filter.py:208-233).  It replaces no TPU kernel:
// epitpu leaves the update to XLA's fusion.  In plain torch on the card it was
// about 22 launches a filter step, two of them row reductions that at 32 rows
// of 4,096 run on a few blocks each.
//
// The sum runs in one fixed order that depends on N alone, which the plain twin
// (epitpu_torch/ops/loglik_cuda.py:row_sum) reproduces and which the kernel
// equals bit for bit on the card: pad the row with zeros to P, the next power of
// two >= N; where P > kTile, cut it into P / kTile tiles of kTile consecutive
// elements and add the tiles elementwise in order, tile 0 first; then fold the
// halves of the (tile-sized or P-long) vector, element i + H/2 into element i,
// until one element is left.  So a row's result does not depend on how many rows
// there are or where it lies, and no chain shard has to pad its rows
// (smc/filter.py).  exp and log are expf and logf, built with --fmad=false and
// no fast math, as PyTorch's CUDA exp and log compute them; the max is exact.
//
// What bounds it: one read of logw and lw and one write of lw', 12 bytes a
// particle in the carry form (0.39 MB at 2,048 x 16, 1.57 MB at 32 x 4,096:
// 0.12 and 0.47 us at 3.35 TB/s), a few operations a particle.  A launch's own
// latency is larger than either, so the design is one launch with every row's
// work on the card at once:
//  * P <= 32 (the production shape, N = 16): P lanes of a warp a row, 256 / P
//    rows a block; lane l holds element l, the max is a butterfly of shuffles,
//    the fold is __shfl_down_sync by P/2, ..., 1 (lane l takes lane l + h);
//  * P > 32: one block of T = min(P, 512) threads a row; thread t holds elements
//    t + T j, j < K = tile / T, of each tile (coalesced), folds its K partial
//    sums in registers (j + K/2 into j first), then the block folds thread
//    t + h into thread t through shared memory for h = T/2 ... 32 and the last
//    warp by shuffles.  The max, the sum and the write each read the row
//    (after the first from L1 or L2); past kTile the tiles are a loop.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallThreads = 256;  // a block of the P <= 32 kernel
constexpr int kRowThreads = 512;  // at most, a block of the one-block-a-row kernel
constexpr int kMaxPerThread = 16;  // elements a thread holds of a tile
constexpr int kTile = kRowThreads * kMaxPerThread;  // epitpu_torch/ops/loglik_cuda.py:TILE

struct Args {
  const float* logw;  // [rows, n]
  const float* lw;  // [rows, n]; null in the always-resample form
  const float* log_z;  // [rows]
  float* log_z_out;  // [rows]
  float* lw_out;  // [rows, n]; null in the always-resample form
  unsigned char* degen_out;  // [rows], torch.bool
  long long rows;
  int n;
  float log_n;  // (float) log N
  float neg_log_n;  // (float) -log N
};

// torch.amax's NaN-propagating max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <bool kCarry>
__device__ __forceinline__ float s_at(const Args& a, long long i) {
  return kCarry ? a.lw[i] + a.logw[i] : a.logw[i];
}

// one row's outputs but lw', from its log-sum-exp
template <bool kCarry>
__device__ __forceinline__ void finish_row(const Args& a, long long r, float lse, bool degen) {
  const float z = a.log_z[r] + lse;
  a.log_z_out[r] = degen ? -INFINITY : (kCarry ? z : z - a.log_n);
  a.degen_out[r] = degen ? 1 : 0;
}

// P <= 32: P lanes a row, kSmallThreads / P rows a block.  Every lane of every
// warp runs the shuffles (a lane past the rows or past n holds -inf and 0).
template <int P, bool kCarry>
__global__ void __launch_bounds__(kSmallThreads) loglik_small(Args a) {
  const int lane = threadIdx.x % P;
  const long long r = static_cast<long long>(blockIdx.x) * (kSmallThreads / P) + threadIdx.x / P;
  const bool ok = r < a.rows && lane < a.n;
  const long long i = r * a.n + lane;
  const float s = ok ? s_at<kCarry>(a, i) : -INFINITY;
  float m = s;
#pragma unroll
  for (int h = P / 2; h > 0; h /= 2) m = nan_max(m, __shfl_xor_sync(kFull, m, h, P));
  const float m0 = fabsf(m) == INFINITY ? 0.0f : m;
  float e = ok ? expf(s - m0) : 0.0f;
#pragma unroll
  for (int h = P / 2; h > 0; h /= 2) e = e + __shfl_down_sync(kFull, e, h, P);
  const float lse = __shfl_sync(kFull, logf(e) + m0, 0, P);  // lane 0's fold
  if (r >= a.rows) return;
  const bool degen = !isfinite(lse);
  if (lane == 0) finish_row<kCarry>(a, r, lse, degen);
  if (kCarry && ok) a.lw_out[i] = degen ? a.neg_log_n : s - lse;
}

// the block's NaN-propagating max, in every thread; red holds a value a warp
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int h = kWarp / 2; h > 0; h /= 2) v = nan_max(v, __shfl_xor_sync(kFull, v, h));
  const int warps = blockDim.x / kWarp;
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < warps; ++w) v = nan_max(v, red[w]);
  __syncthreads();  // red is free again
  return v;
}

// the fold of the block's values by halves of the thread index (thread t + h
// into thread t, h = T/2, ..., 1); the sum in thread 0
__device__ __forceinline__ float block_fold(float v, float* tree) {
  const int t = threadIdx.x;
  tree[t] = v;
  __syncthreads();
  for (int h = blockDim.x / 2; h >= kWarp; h /= 2) {
    if (t < h) tree[t] = tree[t] + tree[t + h];
    __syncthreads();
  }
  if (t < kWarp) {
    v = tree[t];
#pragma unroll
    for (int h = kWarp / 2; h > 0; h /= 2) v = v + __shfl_down_sync(kFull, v, h);
  }
  return v;
}

// P > 32: one block of T = blockDim.x threads a row, K elements a thread a tile
// of T K elements, `tiles` tiles
template <int K, bool kCarry>
__global__ void __launch_bounds__(kRowThreads) loglik_rows(Args a, int tiles) {
  __shared__ float tree[kRowThreads];
  __shared__ float red[kRowThreads / kWarp];
  __shared__ float row_lse;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int tile = T * K;
  const long long r = blockIdx.x;
  const long long base = r * a.n;
  const int n = a.n;

  float m = -INFINITY;
  for (int q = 0; q < tiles; ++q) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = q * tile + t + T * j;
      if (c < n) m = nan_max(m, s_at<kCarry>(a, base + c));
    }
  }
  m = block_max(m, red);
  const float m0 = fabsf(m) == INFINITY ? 0.0f : m;

  float part[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = t + T * j;
    part[j] = c < n ? expf(s_at<kCarry>(a, base + c) - m0) : 0.0f;
  }
  for (int q = 1; q < tiles; ++q) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = q * tile + t + T * j;
      part[j] = part[j] + (c < n ? expf(s_at<kCarry>(a, base + c) - m0) : 0.0f);
    }
  }
#pragma unroll
  for (int h = K / 2; h > 0; h /= 2) {
#pragma unroll
    for (int j = 0; j < h; ++j) part[j] = part[j] + part[j + h];
  }
  const float sum = block_fold(part[0], tree);
  if (t == 0) row_lse = logf(sum) + m0;
  __syncthreads();
  const float lse = row_lse;
  const bool degen = !isfinite(lse);
  if (t == 0) finish_row<kCarry>(a, r, lse, degen);
  if (!kCarry) return;
  for (int q = 0; q < tiles; ++q) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = q * tile + t + T * j;
      if (c < n) a.lw_out[base + c] = degen ? a.neg_log_n : s_at<kCarry>(a, base + c) - lse;
    }
  }
}

template <bool kCarry>
void launch_small(int p, const Args& a, cudaStream_t s) {
  const long long per_block = kSmallThreads / p;
  const auto blocks = static_cast<unsigned>((a.rows + per_block - 1) / per_block);
  switch (p) {
    case 1: loglik_small<1, kCarry><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 2: loglik_small<2, kCarry><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 4: loglik_small<4, kCarry><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 8: loglik_small<8, kCarry><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 16: loglik_small<16, kCarry><<<blocks, kSmallThreads, 0, s>>>(a); break;
    default: loglik_small<32, kCarry><<<blocks, kSmallThreads, 0, s>>>(a);
  }
}

template <bool kCarry>
void launch_rows(int k, int threads, int tiles, const Args& a, cudaStream_t s) {
  const auto blocks = static_cast<unsigned>(a.rows);
  switch (k) {
    case 1: loglik_rows<1, kCarry><<<blocks, threads, 0, s>>>(a, tiles); break;
    case 2: loglik_rows<2, kCarry><<<blocks, threads, 0, s>>>(a, tiles); break;
    case 4: loglik_rows<4, kCarry><<<blocks, threads, 0, s>>>(a, tiles); break;
    case 8: loglik_rows<8, kCarry><<<blocks, threads, 0, s>>>(a, tiles); break;
    default: loglik_rows<kMaxPerThread, kCarry><<<blocks, threads, 0, s>>>(a, tiles);
  }
}

}  // namespace

// One launch over `rows` rows of n particles on the caller's stream; lw and
// lw_out both null (always-resample form) or both set (carry form).  Returns a
// cudaError_t: cudaErrorInvalidValue for arguments out of range, else
// cudaGetLastError() after the launch.
extern "C" int epi_pf_loglik(const void* logw, const void* lw, const void* log_z,
                             void* log_z_out, void* lw_out, void* degen_out, long long rows,
                             int n, double log_n, void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || n < 1 || n > (1 << 30) ||
      (lw == nullptr) != (lw_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Args a{static_cast<const float*>(logw), static_cast<const float*>(lw),
               static_cast<const float*>(log_z), static_cast<float*>(log_z_out),
               static_cast<float*>(lw_out), static_cast<unsigned char*>(degen_out), rows, n,
               static_cast<float>(log_n), static_cast<float>(-log_n)};
  const bool carry = lw != nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  int p = 1;
  while (p < n) p *= 2;
  if (p <= kWarp) {
    if (carry) launch_small<true>(p, a, s);
    else launch_small<false>(p, a, s);
  } else {
    const int threads = p < kRowThreads ? p : kRowThreads;
    const int span = p < kTile ? p : kTile;
    const int k = span / threads;
    const int tiles = p / span;
    if (carry) launch_rows<true>(k, threads, tiles, a, s);
    else launch_rows<false>(k, threads, tiles, a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
