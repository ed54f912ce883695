// The particle filter's resampling step of the systematic kind (phase
// pf_resample): one launch takes, for every row (one chain's N particles), the
// carried log-weights lw[rows, N], the row's uniform u[rows], the mask skip[rows]
// (weight-carrying form only) and the cloud x[rows, N, C], and writes for the
// particles p0 .. p0 + n_local - 1 of the row (all N unsharded; a particle shard's
// slice on a mesh, x then being the all-gathered cloud)
//
//   m      = max(lw) (NaN propagates), degenerate = !isfinite(m)
//   w_k    = exp(lw_k - m)
//   S_k    = the running sums of w in the fixed order below, M_k = max(S_0..S_k)
//   point_j= (j + u) * (M_{N-1} / N)
//   anc_j  = min(#{k : M_k < point_j}, N - 1), or j where degenerate or skip
//   x_res_j= x[anc_j]                                     ([rows, n_local, C])
//   lw'    = skip ? lw : -log N                           (carry form only)
//
// as epitpu_torch/smc/filter.py did with smc/resample.py:systematic_resample
// (amax, exp, cumsum, the points, the count), the identity where a row is
// degenerate or keeps its particles, torch.gather and the reset of the carried
// weights: about 25 launches a resampling step (epitpu/smc/resample.py:
// systematic_resample and the gather at epitpu/smc/filter.py:172, which XLA
// fuses).  It replaces no TPU kernel: epitpu leaves resampling to XLA.
//
// The running sums follow one order that depends on N alone, which the plain twin
// (epitpu_torch/ops/resample_cuda.py:cdf_reference) reproduces with float32 adds
// and which the kernel equals bit for bit on the card, so a row's ancestors do not
// depend on the other rows and no chain shard pads its rows (smc/filter.py).
// Rounding can leave two such sums out of order by an ulp where a weight is 0
// or tiny; the running maximum M (exact in any order) makes the CDF nondecreasing,
// so the count of M_k below a point is its lower bound, found by binary search.
// With exact sums (dyadic weights) M is the plain cumulative sum.  exp is expf,
// built with --fmad=false and no fast math, as PyTorch's CUDA exp computes it;
// M_{N-1} / N is a true division (ATen's `tensor / int` on the card multiplies by
// the reciprocal instead, which differs where N is not a power of two).
//
// What bounds it: one read of lw and of the cloud and one write of anc, x_res and
// lw', about 4 + 4 C + 8 + 4 C + 4 = 40 bytes a particle at C = 3 (1.3 MB at
// 2,048 x 16, 5.2 MB at 32 x 4,096: 0.39 and 1.57 us at 3.35 TB/s), a few
// operations a particle and log2 N compares a point.  A launch's latency is
// larger than either, so every row's work goes on the card in one launch, its
// shape set by N:
//  * P <= 32 (P the next power of two >= N; the production shape, N = 16): P
//    lanes of a warp a row, kSmallThreads / P rows a block; lane l holds particle
//    l: the max is a butterfly of shuffles, the sums a Kogge-Stone scan by
//    __shfl_up_sync (lane l adds lane l - d for d = 1, 2, ..., P/2), the running
//    maximum another, and the binary search reads the lanes by shuffles;
//  * P > 32: blocks of T = min(P, 512) threads, tiles of S = min(P, kTile)
//    elements taken in order, zeros past N; thread t sums its K = S / T
//    consecutive elements t K .. t K + K - 1 in order (tile 0's held in
//    registers from the max on); the threads' totals are scanned by Kogge-Stone
//    within each warp, the warps' totals by Kogge-Stone in warp 0, and element k
//    of thread t is S_k = (carry + (warps before + lanes before)) + its own
//    running sum, carry the previous tile's last S.  M goes to shared memory
//    (N <= kTile, 32 KB) or to the scratch row the wrapper allocates (N > kTile),
//    where the points' binary searches read it, kPoints of a thread side by side
//    so that their dependent loads overlap, as do the loads of their states.
//    Such a block's time is its chain of dependent steps (loads, barriers,
//    shuffles, the searches), not its bytes: 32 rows would leave 100 of the 132
//    SMs idle.  So where rows are few and N <= kTile, up to kMaxSplits blocks
//    share a row: each computes the row's M (the same bits) and draws its own
//    share of the particles.  At 32 x 4,096, 4 blocks a row of 512 threads,
//    each with 8 elements and 2 points a thread, took 7.8 us against 12.9-13.3 for
//    one block of 1,024 threads with 4 of each (H100, CUDA events and the
//    profiler, launches back to back).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmallThreads = 256;  // a block of the P <= 32 kernel
constexpr int kRowThreads = 512;  // at most, a block of the rows kernel
constexpr int kMaxPerThread = 16;  // elements a thread sums of a tile
constexpr int kTile = kRowThreads * kMaxPerThread;  // epitpu_torch/ops/resample_cuda.py:TILE
constexpr int kMaxN = 1 << 24;  // every particle index exact as a float
constexpr int kMaxSplits = 8;  // blocks a row, at most, where rows are few

struct Args {
  const float* lw;  // [rows, n]
  const float* u;  // [rows]
  const unsigned char* skip;  // [rows], torch.bool; null in the always-resample form
  const float* x;  // [rows, n, c]
  long long* anc;  // [rows, n_local]
  float* x_res;  // [rows, n_local, c]
  float* lw_out;  // [rows, n]; null in the always-resample form
  float* scratch;  // [rows, n] where n > kTile, else null
  long long rows;
  int n;
  int c;
  int p0;
  int n_local;
  float neg_log_n;  // (float) -log N
};

// torch.amax's NaN-propagating max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

constexpr int kChunk = 4;  // compartments of a state loaded before any is stored

// particle p0 + i of row r drawn from particle k: its ancestor and its state
__device__ __forceinline__ void put(const Args& a, long long r, int i, int k) {
  const long long o = r * a.n_local + i;
  a.anc[o] = k;
  const float* src = a.x + (r * a.n + k) * a.c;
  float* dst = a.x_res + o * a.c;
  for (int q0 = 0; q0 < a.c; q0 += kChunk) {
    float state[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) state[q] = q0 + q < a.c ? src[q0 + q] : 0.0f;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (q0 + q < a.c) dst[q0 + q] = state[q];
    }
  }
}

// P <= 32: P lanes a row, kSmallThreads / P rows a block.  Every lane of every
// warp runs the shuffles (a lane past the rows or past n holds -inf and 0).
template <int P>
__global__ void __launch_bounds__(kSmallThreads) resample_small(Args a) {
  const int lane = threadIdx.x % P;
  const long long r = static_cast<long long>(blockIdx.x) * (kSmallThreads / P) + threadIdx.x / P;
  const bool row = r < a.rows;
  const bool ok = row && lane < a.n;
  const float lw = ok ? a.lw[r * a.n + lane] : -INFINITY;
  float m = lw;
#pragma unroll
  for (int h = P / 2; h > 0; h /= 2) m = nan_max(m, __shfl_xor_sync(kFull, m, h, P));
  const bool skip = row && a.skip != nullptr && a.skip[r] != 0;
  const bool keep = !isfinite(m) || skip;
  float s = ok && !keep ? expf(lw - m) : 0.0f;
#pragma unroll
  for (int d = 1; d < P; d *= 2) {
    const float y = __shfl_up_sync(kFull, s, d, P);
    if (lane >= d) s = y + s;
  }
  float cdf = s;
#pragma unroll
  for (int d = 1; d < P; d *= 2) {
    const float y = __shfl_up_sync(kFull, cdf, d, P);
    if (lane >= d) cdf = fmaxf(y, cdf);
  }
  const float scale = __shfl_sync(kFull, cdf, a.n - 1, P) / static_cast<float>(a.n);
  const float point = (static_cast<float>(lane) + (row ? a.u[r] : 0.0f)) * scale;
  int below = 0;  // #{k : cdf_k < point}, by halves
#pragma unroll
  for (int h = P; h > 0; h /= 2) {
    const int k = below + h - 1;
    const float ck = __shfl_sync(kFull, cdf, k < P ? k : P - 1, P);
    if (k < a.n && ck < point) below += h;
  }
  if (!ok) return;
  const int i = lane - a.p0;
  if (i >= 0 && i < a.n_local) put(a, r, i, keep ? lane : min(below, a.n - 1));
  if (a.lw_out != nullptr) a.lw_out[r * a.n + lane] = skip ? lw : a.neg_log_n;
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

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// the combination by op of the values of the threads before this one, 0 for
// thread 0: a Kogge-Stone scan within each warp, one over the warps' totals in
// warp 0 (part holds a value a warp), then op(warps before, lanes before)
template <class Op>
__device__ __forceinline__ float block_exclusive(float v, float* part, Op op) {
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const float y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = op(y, v);
  }
  float lanes = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) lanes = 0.0f;
  if (lane == kWarp - 1) part[w] = v;
  __syncthreads();
  if (w == 0) {
    float s = lane < warps ? part[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < kWarp; d *= 2) {
      const float y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s = op(y, s);
    }
    if (lane < warps) part[lane] = s;
  }
  __syncthreads();
  const float before = op(w > 0 ? part[w - 1] : 0.0f, lanes);
  __syncthreads();  // part is free again
  return before;
}

// particles p0 + i, i = i0 + t + T j (j < kPoints), of row r drawn from the
// lower bounds of their points in the row's cdf: kPoints searches side by side,
// then their states loaded kChunk compartments at a time before any is stored
constexpr int kPoints = 2;

__device__ __forceinline__ void draw_points(const Args& a, long long r, const float* cdf,
                                            float scale, float u, int half, int i0, int end) {
  const int n = a.n;
  int below[kPoints];  // #{k : cdf_k < point}, by halves
  float point[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int i = i0 + threadIdx.x + blockDim.x * j;
    point[j] = (static_cast<float>(a.p0 + i) + u) * scale;
    below[j] = 0;
  }
  for (int h = half; h > 0; h /= 2) {
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      if (below[j] + h <= n && cdf[below[j] + h - 1] < point[j]) below[j] += h;
    }
  }
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int i = i0 + threadIdx.x + blockDim.x * j;
    below[j] = min(below[j], n - 1);
    if (i < end) a.anc[r * a.n_local + i] = below[j];
  }
  for (int q0 = 0; q0 < a.c; q0 += kChunk) {
    float state[kPoints][kChunk];
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      const float* src = a.x + (r * n + below[j]) * a.c;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) state[j][q] = q0 + q < a.c ? src[q0 + q] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPoints; ++j) {
      const int i = i0 + threadIdx.x + blockDim.x * j;
      float* dst = a.x_res + (r * a.n_local + i) * a.c;
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (i < end && q0 + q < a.c) dst[q0 + q] = state[j][q];
      }
    }
  }
}

// P > 32: gridDim.y blocks of T = blockDim.x threads a row, K consecutive
// elements a thread a tile of T K elements, `tiles` tiles; every block of a row
// computes the row's cdf and draws its own share of the row's particles
template <int K>
__global__ void __launch_bounds__(kRowThreads) resample_rows(Args a, int tiles) {
  __shared__ float cdf_shared[kTile];
  __shared__ float part[kRowThreads / kWarp];
  __shared__ float last[2];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const long long r = blockIdx.x;
  const int n = a.n;
  const float* lw = a.lw + r * n;
  // this block's share: particles p0 + [i_lo, i_hi) and carried weights [k_lo, k_hi)
  const int g = blockIdx.y;
  const int splits = gridDim.y;
  const int i_lo = a.n_local * g / splits;  // at most kMaxN * kMaxSplits, no overflow
  const int i_hi = a.n_local * (g + 1) / splits;
  const int k_lo = n * g / splits;
  const int k_hi = n * (g + 1) / splits;

  float first[K];  // this thread's log-weights of tile 0
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    first[j] = t * K + j < n ? lw[t * K + j] : -INFINITY;
    m = nan_max(m, first[j]);
  }
  for (int q = 1; q < tiles; ++q) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int k = q * T * K + t * K + j;
      if (k < n) m = nan_max(m, lw[k]);
    }
  }
  m = block_max(m, part);
  const bool skip = a.skip != nullptr && a.skip[r] != 0;
  if (!isfinite(m) || skip) {
    for (int i = i_lo + t; i < i_hi; i += T) put(a, r, i, a.p0 + i);
    if (a.lw_out != nullptr) {
      for (int k = k_lo + t; k < k_hi; k += T) a.lw_out[r * n + k] = skip ? lw[k] : a.neg_log_n;
    }
    return;
  }

  float* cdf = n <= kTile ? cdf_shared : a.scratch + r * n;
  float carry = 0.0f;  // the previous tile's last running sum
  float top = 0.0f;  // and its running maximum
  for (int q = 0; q < tiles; ++q) {
    const int k0 = q * T * K + t * K;
    float own[K];  // this thread's running sums
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float l = q == 0 ? first[j] : (k0 + j < n ? lw[k0 + j] : -INFINITY);
      acc = acc + (k0 + j < n ? expf(l - m) : 0.0f);
      own[j] = acc;
    }
    const float base = carry + block_exclusive(own[K - 1], part, Add());
    // base + own[j] rises with j, so the threads before hold their maxima last
    const float before = fmaxf(top, block_exclusive(base + own[K - 1], part, Max()));
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (k0 + j < n) cdf[k0 + j] = fmaxf(before, base + own[j]);
    }
    if (t == T - 1) {
      last[0] = base + own[K - 1];
      last[1] = fmaxf(before, base + own[K - 1]);
    }
    __syncthreads();  // the tile's cdf and last are written
    carry = last[0];
    top = last[1];
  }

  const float scale = cdf[n - 1] / static_cast<float>(n);
  const float u = a.u[r];
  int half = 1;
  while (2 * half <= n) half *= 2;
  for (int i0 = i_lo; i0 < i_hi; i0 += T * kPoints) {
    draw_points(a, r, cdf, scale, u, half, i0, i_hi);
  }
  if (a.lw_out != nullptr) {
    for (int k = k_lo + t; k < k_hi; k += T) a.lw_out[r * n + k] = a.neg_log_n;
  }
}

void launch_small(int p, const Args& a, cudaStream_t s) {
  const long long per_block = kSmallThreads / p;
  const auto blocks = static_cast<unsigned>((a.rows + per_block - 1) / per_block);
  switch (p) {
    case 1: resample_small<1><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 2: resample_small<2><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 4: resample_small<4><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 8: resample_small<8><<<blocks, kSmallThreads, 0, s>>>(a); break;
    case 16: resample_small<16><<<blocks, kSmallThreads, 0, s>>>(a); break;
    default: resample_small<32><<<blocks, kSmallThreads, 0, s>>>(a);
  }
}

void launch_rows(int k, int threads, int tiles, int splits, const Args& a, cudaStream_t s) {
  const dim3 blocks(static_cast<unsigned>(a.rows), static_cast<unsigned>(splits));
  switch (k) {
    case 1: resample_rows<1><<<blocks, threads, 0, s>>>(a, tiles); break;
    case 2: resample_rows<2><<<blocks, threads, 0, s>>>(a, tiles); break;
    case 4: resample_rows<4><<<blocks, threads, 0, s>>>(a, tiles); break;
    case 8: resample_rows<8><<<blocks, threads, 0, s>>>(a, tiles); break;
    default: resample_rows<kMaxPerThread><<<blocks, threads, 0, s>>>(a, tiles);
  }
}

}  // namespace

// One launch over `rows` rows of n particles of c compartments on the caller's
// stream; skip and lw_out both null (always-resample form) or both set (carry
// form); scratch set where n > kTile.  Returns a cudaError_t:
// cudaErrorInvalidValue for arguments out of range, else cudaGetLastError()
// after the launch.
extern "C" int epi_pf_resample(const void* lw, const void* u, const void* skip, const void* x,
                               void* anc, void* x_res, void* lw_out, void* scratch,
                               long long rows, int n, int c, int p0, int n_local, double log_n,
                               void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || n < 1 || n > kMaxN || c < 1 || p0 < 0 ||
      n_local < 0 || p0 > n - n_local || (skip == nullptr) != (lw_out == nullptr) ||
      (n > kTile && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Args a{static_cast<const float*>(lw), static_cast<const float*>(u),
               static_cast<const unsigned char*>(skip), static_cast<const float*>(x),
               static_cast<long long*>(anc), static_cast<float*>(x_res),
               static_cast<float*>(lw_out), static_cast<float*>(scratch), rows, n, c, p0,
               n_local, static_cast<float>(-log_n)};
  const auto s = static_cast<cudaStream_t>(stream);
  int p = 1;
  while (p < n) p *= 2;
  if (p <= kWarp) {
    launch_small(p, a, s);
  } else {
    const int threads = p < kRowThreads ? p : kRowThreads;
    const int span = p < kTile ? p : kTile;
    // few rows leave most SMs idle: split each row's particles over up to
    // kMaxSplits blocks, every one computing the row's cdf (a shared scratch
    // row, past kTile, takes one block a row)
    int device = 0;
    int sms = 1;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    long long splits = sms / rows;
    if (splits > kMaxSplits) splits = kMaxSplits;
    if (splits > (n_local + threads - 1) / threads) splits = (n_local + threads - 1) / threads;
    if (splits < 1 || n > kTile) splits = 1;
    launch_rows(span / threads, threads, p / span, static_cast<int>(splits), a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
