// The hand-written model functors of the tau-leap kernel
// (csrc/tauleap_kernel.cuh, which says what the kernel computes, what bounds
// it and how its design answers that), and the C entry epi_traj that
// launches it for a built-in model family:
//
//   Sir                   3 compartments, 2 reactions, theta [beta, gamma]
//   Seir                  4 compartments, 3 reactions, theta [beta, alpha, gamma]
//   SirSubgroups<K, T>    3K compartments [s_g, i_g, r_g], 2K reactions
//                         (infection into g at slot g, recovery at K + g),
//                         theta [beta (K x K row-major), gamma]; T selects the
//                         transposed force sum_p beta[p, g] i_p, else
//                         sum_p beta[g, p] i_p.  K = 1 .. kMaxGroups.
//
// Every reaction of these families moves one unit from x[src(r)] to
// x[src(r) + 1].  Each functor's rate() follows the operation order of the
// model's torch rate_fn (epitpu_torch/models/), the force as a left-to-right
// sum over p.  Any other model with unique reaction sources, and K-group SIR
// past kMaxGroups, runs on a functor generated from its rate_fn
// (epitpu_torch/ops/rate_trace.py, built by epitpu_torch/ops/_build.py).

#include "tauleap_kernel.cuh"

namespace {

constexpr int kMaxGroups = 8;  // epitpu_torch/ops/tauleap_cuda.py:MAX_GROUPS

// apply() of the hand functors: reaction q moves e[q] from x[src(q)] to the
// next compartment
template <class M>
__device__ __forceinline__ void move_to_next(float (&x)[M::kC], const float (&e)[M::kR]) {
#pragma unroll
  for (int q = 0; q < M::kR; ++q) {
    x[M::src(q)] = x[M::src(q)] - e[q];
    x[M::src(q) + 1] = x[M::src(q) + 1] + e[q];
  }
}

// ---- model functors (epitpu_torch/models/{sir,seir,subgroups}.py) ----------
// load(th, r, coef): the theta entries reaction r reads; rate(x, coef, r):
// reaction r's rate, in the operation order of the model's rate_fn;
// apply(x, e): the state change of the event counts.

struct Sir {
  static constexpr int kC = 3, kR = 2, kCoef = 1;
  __host__ __device__ static constexpr int src(int r) { return r; }  // s->i, i->r
  __device__ __forceinline__ static void load(const float* th, int r, float* coef) {
    coef[0] = th[r];
  }
  __device__ __forceinline__ static float rate(const float (&x)[kC], const float* coef, int r) {
    if (r == 0) {
      const float n = x[0] + x[1] + x[2];
      return coef[0] * x[0] * x[1] / n;
    }
    return coef[0] * x[1];
  }
  __device__ __forceinline__ static void apply(float (&x)[kC], const float (&e)[kR]) {
    move_to_next<Sir>(x, e);
  }
};

struct Seir {
  static constexpr int kC = 4, kR = 3, kCoef = 1;
  __host__ __device__ static constexpr int src(int r) { return r; }  // s->e, e->i, i->r
  __device__ __forceinline__ static void load(const float* th, int r, float* coef) {
    coef[0] = th[r];
  }
  __device__ __forceinline__ static float rate(const float (&x)[kC], const float* coef, int r) {
    if (r == 0) {
      const float n = x[0] + x[1] + x[2] + x[3];
      return coef[0] * x[0] * x[2] / n;
    }
    return coef[0] * pick(x, r);  // alpha e, gamma i
  }
  __device__ __forceinline__ static void apply(float (&x)[kC], const float (&e)[kR]) {
    move_to_next<Seir>(x, e);
  }
};

template <int K, bool kTranspose>
struct SirSubgroups {
  static constexpr int kC = 3 * K, kR = 2 * K, kCoef = K;
  // infection into g: s_g -> i_g; recovery in g: i_g -> r_g
  __host__ __device__ static constexpr int src(int r) { return r < K ? 3 * r : 3 * (r - K) + 1; }
  __device__ __forceinline__ static void load(const float* th, int r, float* coef) {
    if (r < K) {
#pragma unroll
      for (int p = 0; p < K; ++p) coef[p] = kTranspose ? th[p * K + r] : th[r * K + p];
    } else {
      coef[0] = th[K * K];
    }
  }
  __device__ __forceinline__ static float rate(const float (&x)[kC], const float* coef, int r) {
    if (r < K) {
      float n = x[0];
#pragma unroll
      for (int c = 1; c < kC; ++c) n = n + x[c];  // integer counts: exact in any order
      float force = coef[0] * x[1];
#pragma unroll
      for (int p = 1; p < K; ++p) force = force + coef[p] * x[3 * p + 1];
      return pick(x, 3 * r) * force / n;
    }
    return coef[0] * pick(x, 3 * (r - K) + 1);
  }
  __device__ __forceinline__ static void apply(float (&x)[kC], const float (&e)[kR]) {
    move_to_next<SirSubgroups>(x, e);
  }
};

template <int K>
int launch_subgroups(int k, bool transpose, const Launch& l) {
  if constexpr (K > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k != K) return launch_subgroups<K + 1>(k, transpose, l);
    return transpose ? launch<SirSubgroups<K, true>>(l) : launch<SirSubgroups<K, false>>(l);
  }
}

}  // namespace

// Launches the kernel of model family `family` (0 sir, 1 seir, 2 sir_subgroups
// with `k` groups and the `transpose` flag) on `stream` as `blocks` blocks of
// `threads` threads, `group` threads per lane, and returns cudaGetLastError()
// (0 = launched).  An unknown family or k, a shape that does not fit the
// instantiation's group size, or a lane map (lane_*) that does not fit the
// launch returns cudaErrorInvalidValue without launching.
extern "C" int epi_traj(int family, int k, int transpose, const void* x0,
                        const void* theta, void* out, int lanes, int theta_stride,
                        int lanes_per_theta, uint32_t k0, uint32_t k1, uint32_t offset,
                        uint32_t lane_c0, uint32_t lane_n_local, uint32_t lane_n_total,
                        uint32_t lane_p0, int t_max, int n_sub, float dt, int final_only,
                        int group, int threads, int blocks, void* stream) {
  if (lanes <= 0) return 0;
  const Launch l{static_cast<const float*>(x0), static_cast<const float*>(theta),
                 static_cast<float*>(out), lanes, theta_stride, lanes_per_theta, k0, k1,
                 offset, lane_c0, lane_n_local, lane_n_total, lane_p0, t_max, n_sub, dt,
                 final_only, group, threads, blocks, static_cast<cudaStream_t>(stream)};
  switch (family) {
    case 0:
      return launch<Sir>(l);
    case 1:
      return launch<Seir>(l);
    case 2:
      return launch_subgroups<1>(k, transpose != 0, l);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
