// Per-lane Euler-multinomial tau-leap simulation of any compartment model whose
// reactions have unique sources, for Hopper: the kernel template, instantiated
// on a model functor by csrc/tauleap.cu (the hand-written functors of the
// built-in families) and by the sources epitpu_torch/ops/_build.py generates
// (a functor traced from a model's own rate_fn, epitpu_torch/ops/rate_trace.py).
//
// Replaces the Pallas TPU kernel epitpu/ops/tauleap_pallas.py:_make_traj_kernel,
// launched by _pallas_simulate_impl.  It computes what that kernel computes:
// B independent (theta, x0) lanes, each run through t_max * n_sub substeps of
// length dt, the state recorded at every integer time into out[B, t_max+1, C]
// (or, with final_only, only the state at t_max into out[B, C]).  Reaction r
// fires Binomial(x_src(r), 1 - exp(-mu_r dt)) by the two-regime law of
// epitpu/sim/samplers.py:66-88: exact inverse CDF over 20 terms below mean 8,
// Cornish-Fisher normal above, p > 1/2 flipped.  The TPU kernel reads the
// model's rate function and stoichiometry at trace time; here the model is a
// functor M with
//
//   kC, kR, kCoef          compartments, reactions, theta entries a reaction reads
//   src(r)                 reaction r's source compartment (unique per reaction)
//   load(th, r, coef)      the theta entries reaction r reads, from its row th
//   rate(x, coef, r)       reaction r's rate, in the operation order of the
//                          model's torch rate_fn, so the plain twin
//                          (epitpu_torch/ops/tauleap_cuda.py:simulate_lanes_reference)
//                          rounds alike
//   apply(x, e)            the state change of the R event counts e
//
// Since no two reactions share a source, draw slot r serves reaction r.  Within
// a substep every reaction draws from the pre-substep state before any update,
// and apply() then updates in the twin's order (sim/tauleap.py:substep).
// Randomness is Philox4x32-10 with key = seed and counter = (lane, call
// offset, substep, reaction), the layout of epitpu_torch/rng.py, so the twin
// draws the same bits: word 0 is the uniform, words 1 and 2 the Box-Muller
// normal.  The counter's lane word goes through a lane map (chain offset c0,
// local and total particles per chain n_local and n_total, particle offset
// p0): lane b draws as lane (c0 + b / n_local) * n_total + p0 + b % n_local,
// its index in the unsharded launch, so a shard of a chain- or
// particle-sharded filter step (epitpu_torch/dist) draws what the same
// particle draws unsharded.  The identity map is (0, 1, 1, 0).
//
// What bounds it: not bytes (a lane reads C + d words and writes at most
// C (t_max+1)) but one long dependent chain per lane: t_max * n_sub substeps,
// each a rate, a fire probability and a binomial draw whose inverse-CDF loop
// runs one IEEE division per term.  At the ABC and forecast shapes there are
// too few lanes to hide that chain behind other warps, so the design shortens
// the chain itself:
//
//  (a) A lane of R <= 32 reactions takes exactly R consecutive threads of a
//      warp, its group (G = R), and a warp holds L = floor(32 / R) lanes:
//      thread t of warp w serves lane w L + t / G and reaction t % G, and
//      the warp's last 32 - L G threads belong to no lane (SIR 16 lanes of
//      2; SEIR 10 lanes of 3 and 2 threads over; K groups 2K threads, one
//      lane a warp from K = 9).  A lane of R > 32 takes a whole warp
//      (G = 32), thread t drawing reactions t, t + 32, ....  Every thread
//      holds the lane's whole state and computes only its own reactions,
//      with only the theta entries they read, and only their draws.  The R
//      counts are exchanged with __shfl_sync inside the group, count q from
//      the group's thread q % G, its element q / G.  A group of a power of
//      two is a shuffle segment of width G; any other names its source lane
//      in the warp, since a width must be a power of two (naming it for
//      every G cost Sir 6 registers and K = 8 another 8, nvcc -v).  Every
//      thread applies all R updates in reaction order, so the copies of the
//      state stay identical; thread q writes the compartments c with
//      c % G == q.  This divides the draw part of the chain by min(R, 32).
//      A power of two R leaves no thread over; any other leaves fewer than
//      R a warp (R = 3, 6 and 10: 2 of 32).
//  (b) The CDF loop stops at the first term with u < cdf.  This is exact:
//      cdf is a running sum of terms clamped at >= 0, so it never decreases
//      and every later (u >= cdf) is false (a NaN cdf stays NaN and compares
//      false as well; the loop tests !(u >= cdf) so that case exits too).
//  (c) Box-Muller (logf, sqrtf, cosf) runs only in the normal regime.
//  (d) Philox is computed inside the draw that consumes it.  Computing the
//      words of substep j + 1 at the top of substep j did not take them off
//      the chain: nvcc placed the ten rounds at the loop top, ahead of the
//      drawing threads' branch (cuobjdump -sass), where they ran in series,
//      and that build timed 5 % slower at the ABC shape than this one
//      (k4_ablation.py at the repo's root, on an H100).  A producer warp
//      filling a shared-memory ring with (u, z) pairs was not built: its
//      ceiling, timed by the same script, is what a free Philox and a free
//      Box-Muller would save, 4-8 % each, before an mbarrier wait on every
//      substep of a chain whose length is the limit.
//  (e) The launch shape comes from the caller
//      (epitpu_torch/ops/tauleap_cuda.py:launch_geometry): the warps that
//      hold lanes, in fewer threads per block when a launch would fill
//      fewer blocks than the card has SMs.  Threads of no lane (a warp's
//      last 32 - L G, and every group past the last lane) return at once:
//      they never draw, write or shuffle, and no shuffle's mask names them.
//  (f) final_only writes only the state at t_max into [B, C] (the particle
//      filter's step), and lanes_per_theta lets consecutive lanes share one
//      theta row (lane b reads row b / lanes_per_theta), so the filter
//      launches nothing but this kernel.
//
// Tensor cores have no matrix product to run here, and TMA no tile worth
// copying: a launch reads tens of bytes a lane.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (see
// epitpu_torch/ops/_build.py); no fast-math, so expf/logf/expm1f/log1pf and
// the divisions round like the torch twin's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kSmallK = 20;
constexpr float kSmallMeanMax = 8.0f;
constexpr int kMaxThreads = 256;  // per block; tauleap_cuda.py:MAX_THREADS
constexpr int kWarp = 32;  // threads a warp, and at most a lane's; tauleap_cuda.py:WARP

struct Words {
  uint32_t x, y, z, w;
};

// threads a lane: one a reaction, at most a warp; (a)
__host__ __device__ constexpr int group_size(int reactions) {
  return reactions < kWarp ? reactions : kWarp;
}

__device__ __forceinline__ Words philox(Words c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = Words{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

__device__ __forceinline__ float uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = fmaxf(uniform(b1), 1e-12f);
  const float u2 = uniform(b2);
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.2831855f * u2);
}

// Binomial(n, p) from the Philox words of its counter; the operations and
// their order follow epitpu_torch/sim/samplers.py:binomial_from_draws.
__device__ __forceinline__ float binomial(const Words& w, float n, float p) {
  p = fminf(fmaxf(p, 0.0f), 1.0f);
  const bool flip = p > 0.5f;
  const float pe = flip ? 1.0f - p : p;
  const float lam = n * pe;
  float x;
  if (lam < kSmallMeanMax) {
    const float u = uniform(w.x);
    const float ps = fminf(pe, 0.9999999f);
    const float q = 1.0f - ps;
    const float ratio = ps / q;
    float pmf = expf(n * log1pf(-ps));
    float cdf = pmf;
    x = 0.0f;
    for (int k = 0; k < kSmallK - 1; ++k) {
      if (!(u >= cdf)) break;  // (b): no later term can count
      x += 1.0f;
      pmf = fmaxf(pmf * (n - (float)k) / ((float)k + 1.0f) * ratio, 0.0f);
      cdf = cdf + pmf;
    }
    x += (u >= cdf) ? 1.0f : 0.0f;
    x = fminf(x, n);
  } else {
    const float z = box_muller(w.y, w.z);  // (c)
    const float var = lam * (1.0f - pe);
    const float sig = sqrtf(fmaxf(var, 1e-12f));
    const float gamma = (1.0f - 2.0f * pe) / sig;
    const float zc = z + gamma * (z * z - 1.0f) / 6.0f;
    x = floorf(lam + sig * zc + 0.5f);
    x = fminf(fmaxf(x, 0.0f), n);
  }
  if (flip) x = n - x;
  if (p == 0.0f) x = 0.0f;
  if (p == 1.0f) x = n;
  return x;
}

__device__ __forceinline__ float fire_probability(float rate, float src, float dt) {
  const float mu = src > 0.0f ? fmaxf(rate, 0.0f) / fmaxf(src, 1.0f) : 0.0f;
  return fminf(fmaxf(-expm1f(-mu * dt), 0.0f), 1.0f);
}

// x[i] for a runtime i, by selects over the unrolled compartments, so the
// state never leaves registers.
template <int C>
__device__ __forceinline__ float pick(const float (&x)[C], int i) {
  float v = x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) v = (i == c) ? x[c] : v;
  return v;
}

// Thread r of a lane's group writes the compartments c with c % G == r.
template <int C, int G>
__device__ __forceinline__ void store(float* o, const float (&x)[C], int r) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c % G == r) o[c] = x[c];
  }
}

template <class M>
__global__ void __launch_bounds__(kMaxThreads)
traj_kernel(const float* __restrict__ x0, const float* __restrict__ theta,
            float* __restrict__ out, int lanes, int theta_stride, int lanes_per_theta,
            uint32_t k0, uint32_t k1, uint32_t offset, uint32_t lane_c0, uint32_t lane_n_local,
            uint32_t lane_n_total, uint32_t lane_p0, int t_max, int n_sub, float dt,
            int final_only) {
  constexpr int C = M::kC, R = M::kR, G = group_size(R), L = kWarp / G;
  constexpr int P = (R + G - 1) / G;  // reactions a thread draws: r, r + G, ...
  constexpr unsigned kGroupMask = G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u;
  // a block is whole warps, so no group spans two
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int t_warp = static_cast<int>(threadIdx.x % kWarp);
  const int slot = t_warp / G;  // the warp's lane this thread serves; L for none
  const int r = t_warp % G;
  if (slot >= L || warp * L + slot >= lanes) return;  // (e)
  const int b = static_cast<int>(warp * L + slot);
  // the counter's lane word: b's index in the unsharded launch
  const uint32_t lane = (lane_c0 + (uint32_t)b / lane_n_local) * lane_n_total + lane_p0 +
                        (uint32_t)b % lane_n_local;
  const int base = G * slot;  // the group's first thread in the warp
  const unsigned mask = kGroupMask << base;
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = x0[(size_t)C * b + c];
  float coef[P][M::kCoef];
  int src[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int q = r + p * G;
#pragma unroll
    for (int j = 0; j < M::kCoef; ++j) coef[p][j] = 0.0f;
    if (q < R) M::load(theta + (size_t)(b / lanes_per_theta) * theta_stride, q, coef[p]);
    src[p] = M::src(q < R ? q : 0);
  }
  float* o = out + (size_t)b * (final_only ? 1 : t_max + 1) * C;
  if (!final_only || t_max == 0) store<C, G>(o, x, r);
  uint32_t step = 0;
  for (int t = 1; t <= t_max; ++t) {
    for (int j = 0; j < n_sub; ++j, ++step) {
      float ev[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = r + p * G;
        ev[p] = 0.0f;
        if (q < R) {
          const float n = pick(x, src[p]);
          const Words w = philox(Words{lane, offset, step, (uint32_t)q}, k0, k1);
          ev[p] = binomial(w, n, fire_probability(M::rate(x, coef[p], q), n, dt));
        }
      }
      float e[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if constexpr ((G & (G - 1)) == 0) e[q] = __shfl_sync(mask, ev[q / G], q % G, G);
        else e[q] = __shfl_sync(mask, ev[q / G], base + q % G);
      }
      M::apply(x, e);
    }
    if (!final_only || t == t_max) store<C, G>(o + (final_only ? 0 : C * t), x, r);
  }
}

struct Launch {
  const float* x0;
  const float* theta;
  float* out;
  int lanes, theta_stride, lanes_per_theta;
  uint32_t k0, k1, offset;
  uint32_t lane_c0, lane_n_local, lane_n_total, lane_p0;
  int t_max, n_sub;
  float dt;
  int final_only, group, threads, blocks;
  cudaStream_t stream;
};

template <class M>
int launch(const Launch& l) {
  constexpr int G = group_size(M::kR), L = kWarp / G;
  // the threads of the warps that hold lanes, L lanes a warp: the shape must
  // be the one launch_geometry computes for this instantiation
  const long long need = ((long long)l.lanes + L - 1) / L * kWarp;
  if (l.group != G || l.threads < 32 || l.threads > kMaxThreads || l.threads % 32 != 0 ||
      l.blocks < 1 || (long long)l.blocks * l.threads < need ||
      (long long)(l.blocks - 1) * l.threads >= need || l.lanes_per_theta < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the lane map must cover the launch with whole chains, and every lane word
  // it gives must fit the counter's 32 bits
  const long long n_local = l.lane_n_local, n_total = l.lane_n_total;
  if (n_local < 1 || n_total < n_local || (long long)l.lane_p0 + n_local > n_total ||
      l.lanes % n_local != 0 ||
      ((long long)l.lane_c0 + l.lanes / n_local - 1) * n_total + l.lane_p0 + n_local - 1 >
          0xFFFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  traj_kernel<M><<<l.blocks, l.threads, 0, l.stream>>>(
      l.x0, l.theta, l.out, l.lanes, l.theta_stride, l.lanes_per_theta, l.k0, l.k1,
      l.offset, l.lane_c0, l.lane_n_local, l.lane_n_total, l.lane_p0, l.t_max, l.n_sub, l.dt,
      l.final_only);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
