"""Ablation of the tau-leap kernel's design on one GPU.

    python3 k4_ablation.py

Builds variants of the hand-written kernel library
(``epitpu_torch/csrc/tauleap.cu`` with the kernel template of
``tauleap_kernel.cuh``), each undoing one part of its design by a text edit
of a copy of the two sources (the shipped files are not touched; an edit
whose anchor text is not found once in the two raises), checks
that every variant gives the shipped kernel's output bit for bit (they
compute the same function), and times them with CUDA events, in turns
(shipped, variants, variants reversed, shipped), at six cases: SIR and
8-group SIR (transposed), each at the filter shape (32,768 lanes, 20
substeps, final state, 16 lanes per theta row) and the ABC shape (512 lanes
x 14 units x 20 substeps, full trajectory), and SEIR at the SEIR cell's
filter shape (65,536 lanes, 32 a theta row) and the ABC shape, on
chip_smoke.py's phase-3 inputs.  Variants:

  one_thread       one thread per lane running all R draws in turn, the
                   rest of the design kept: part (a), the group split, undone;
  power_of_two_group  a lane's group the next power of two >= R threads,
                   32 / G lanes a warp: part (a)'s packing undone (the same
                   launch for a power-of-two R; SEIR's lanes in groups of 4);
  no_early_exit    the inverse-CDF loop runs all of its terms, part (b);
  philox_ahead     the Philox words of substep j + 1 computed at the top of
                   substep j, the prefetch that part (d) measured and left out;
  zero_guard       every division of a zero dividend skipped (exact for the
                   positive divisors here): whether IEEE division's slow path
                   costs the lanes whose rates are 0;
  threads_256      the shipped kernel launched 256 threads a block at
                   every lane count, part (e) undone;
  full_trajectory  at the filter shape, the shipped kernel writing rows 0
  / final_only     and 1 (the filter step without final_only, row 0
                   rewritten); at the ABC shape, only the final state
                   instead of all 15 strided rows: what the writes cost;

and two timing-only variants whose output differs, as ceilings on what
taking the random words off a lane's chain (a producer warp filling a
shared-memory ring) could save:

  philox_2_rounds  Philox4x32 with 2 rounds instead of 10;
  cheap_normal     the normal draw from two uniforms by a sum, not
                   Box-Muller's logf, sqrtf and cosf;

then it times the shipped kernel on SIR at 1, 2, 4, 8 and 16 warps per SM
(132 x 16 lanes per warp-per-SM step), which shows where a launch stops
being bound by one lane's chain.  Prints the card's name and power limit,
then one JSON object per line; the last one holds every number.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

import torch

from chip_smoke import _lane_inputs, cuda_ms
from epitpu_torch.models import seir_model, sir_model, sir_subgroups_model
from epitpu_torch.ops import _build, tauleap_cuda
from epitpu_torch.rng import seed_key

EARLY_EXIT = ("      if (!(u >= cdf)) break;  // (b): no later term can count\n"
              "      x += 1.0f;\n")
LOOP_TOP = "  uint32_t step = 0;\n  for (int t = 1; t <= t_max; ++t) {\n"
# the draw of a thread's reaction q (one reaction a thread at SIR and K = 8)
DRAW_TOP = "        ev[p] = 0.0f;\n        if (q < R) {\n"
DRAW_WORDS = ("          const Words w = philox(Words{lane, offset, step, (uint32_t)q}, "
              "k0, k1);\n")
DRAW_END = "        }\n      }\n      float e[R];\n"
PHILOX_ROUNDS = "  for (int i = 0; i < 10; ++i) {\n"
BOX_MULLER = "  return r * cosf(6.2831855f * u2);\n"
BINOMIAL_NOTE = "// Binomial(n, p) from the Philox words"
DIVIDE_GUARD = ("__device__ __forceinline__ float div_pos(float a, float b) {\n"
                "  return a == 0.0f ? a : a / b;\n}\n\n")
KERNEL_START = "template <class M>\n__global__ void __launch_bounds__(kMaxThreads)\ntraj_kernel("
KERNEL_END = "struct Launch {"
GROUP = "  constexpr int G = group_size(M::kR), L = kWarp / G;\n  // the threads of the warps"
GROUP_SIZE = "  return reactions < kWarp ? reactions : kWarp;\n"
# one thread per lane: every reaction's theta entries loaded once, then per
# substep all R draws from the pre-substep state, in reaction order
ONE_THREAD_KERNEL = """template <class M>
__global__ void __launch_bounds__(kMaxThreads)
traj_kernel(const float* __restrict__ x0, const float* __restrict__ theta,
            float* __restrict__ out, int lanes, int theta_stride, int lanes_per_theta,
            uint32_t k0, uint32_t k1, uint32_t offset, uint32_t lane_c0, uint32_t lane_n_local,
            uint32_t lane_n_total, uint32_t lane_p0, int t_max, int n_sub, float dt,
            int final_only) {
  constexpr int C = M::kC, R = M::kR;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= lanes) return;
  const int b = static_cast<int>(tid);
  const uint32_t lane = (lane_c0 + (uint32_t)b / lane_n_local) * lane_n_total + lane_p0 +
                        (uint32_t)b % lane_n_local;
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = x0[(size_t)C * b + c];
  float coef[R][M::kCoef];
#pragma unroll
  for (int q = 0; q < R; ++q)
    M::load(theta + (size_t)(b / lanes_per_theta) * theta_stride, q, coef[q]);
  float* o = out + (size_t)b * (final_only ? 1 : t_max + 1) * C;
  if (!final_only || t_max == 0) store<C, 1>(o, x, 0);
  uint32_t step = 0;
  for (int t = 1; t <= t_max; ++t) {
    for (int j = 0; j < n_sub; ++j, ++step) {
      float e[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float n = x[M::src(q)];
        const Words w = philox(Words{lane, offset, step, (uint32_t)q}, k0, k1);
        e[q] = binomial(w, n, fire_probability(M::rate(x, coef[q], q), n, dt));
      }
      M::apply(x, e);
    }
    if (!final_only || t == t_max) store<C, 1>(o + (final_only ? 0 : C * t), x, 0);
  }
}

"""

EDITS = {
    "one_thread": [(None, ONE_THREAD_KERNEL),
                   (GROUP, "  constexpr int G = 1, L = kWarp / G;\n  // the threads of the warps")],
    "power_of_two_group": [(GROUP_SIZE, "  int g = 1;\n  while (g < reactions && g < kWarp) "
                                        "g *= 2;\n  return g;\n")],
    "no_early_exit": [(EARLY_EXIT, "      x += (u >= cdf) ? 1.0f : 0.0f;\n")],
    "philox_ahead": [
        (LOOP_TOP, "  uint32_t step = 0;\n  Words w = philox(Words{lane, offset, 0u, "
                   "(uint32_t)r}, k0, k1);\n  for (int t = 1; t <= t_max; ++t) {\n"),
        (DRAW_TOP, "        const Words next = philox(Words{lane, offset, step + 1u, "
                   "(uint32_t)q}, k0, k1);\n" + DRAW_TOP),
        (DRAW_WORDS, ""),
        (DRAW_END, "        }\n        w = next;\n      }\n      float e[R];\n"),
    ],
    "zero_guard": [
        (BINOMIAL_NOTE, DIVIDE_GUARD + BINOMIAL_NOTE),
        ("fmaxf(rate, 0.0f) / fmaxf(src, 1.0f)", "div_pos(fmaxf(rate, 0.0f), fmaxf(src, 1.0f))"),
        ("      return coef[0] * x[0] * x[1] / n;",
         "      return div_pos(coef[0] * x[0] * x[1], n);"),
        ("    const float ratio = ps / q;", "    const float ratio = div_pos(ps, q);"),
        ("pmf * (n - (float)k) / ((float)k + 1.0f) * ratio",
         "div_pos(pmf * (n - (float)k), (float)k + 1.0f) * ratio"),
    ],
    "philox_2_rounds": [(PHILOX_ROUNDS, "  for (int i = 0; i < 2; ++i) {\n")],
    "cheap_normal": [(BOX_MULLER, "  return (u1 + u2 - 1.0f) * 2.449f;\n")],
}
TIMING_ONLY = ("philox_2_rounds", "cheap_normal")  # their output differs by design
# threads a lane of R reactions in the variants that launch another group
GROUPS = {"one_thread": lambda r: 1,
          "power_of_two_group": lambda r: min(1 << (r - 1).bit_length(), 32)}
SMS = 132
FILTER_LANES, ABC_LANES, PER_THETA = 32768, 512, 16
SEIR_LANES, SEIR_PER_THETA = 65536, 32  # the SEIR cell's 2,048 chains x 32 particles
SCAN_WARPS_PER_SM = (1, 2, 4, 8, 16)
SEED = 20261016


def variant_sources(name):
    """{file name: text} of the library's sources (``_build.SOURCES``) with
    ``name``'s edits, each anchor found once in the two; an anchor of None
    replaces the kernel template itself (KERNEL_START up to KERNEL_END)."""
    srcs = {f: (_build.CSRC / f).read_text() for f in _build.SOURCES}

    def owner(anchor):
        hits = [f for f, text in srcs.items() if text.count(anchor) == 1]
        if len(hits) != 1 or sum(text.count(anchor) for text in srcs.values()) != 1:
            raise RuntimeError(f"variant {name}: the anchor {anchor[:40]!r} does not occur once")
        return hits[0]

    for old, new in EDITS[name]:
        if old is None:
            f = owner(KERNEL_START)
            if owner(KERNEL_END) != f:
                raise RuntimeError(f"variant {name}: the kernel's anchors are in two files")
            start, end = srcs[f].index(KERNEL_START), srcs[f].index(KERNEL_END)
            srcs[f] = srcs[f][:start] + new + srcs[f][end:]
            continue
        f = owner(old)
        srcs[f] = srcs[f].replace(old, new)
    return srcs


def build_variants():
    """nvcc for every variant at once; {name: (ctypes library, its threads a
    lane of R reactions, or None for the model's)}."""
    procs = {}
    for name in EDITS:
        d = _build.BUILD_DIR / "ablation" / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in variant_sources(name).items():
            (d / f).write_text(text)  # tauleap.cu includes the header beside it
        cmd = _build.nvcc_command(_build.find_nvcc(), [d / _build.SOURCES[0]], d / "lib.so")
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}")
        lib = _build.bind(ctypes.CDLL(str(d / "lib.so")), "epi_traj")
        libs[name] = (lib, GROUPS.get(name))
    return libs


def launcher(lib, model, x0, theta, t_max, final_only, per_theta, group=None, threads=None):
    """A closure that launches ``lib``'s kernel for ``model`` once into a
    fixed output, in launch_geometry's shape for ``group`` threads a lane
    (default: the model's), or with ``threads`` a block."""
    b, c = x0.shape
    family, k, transpose = tauleap_cuda.hand_args(model)
    g, t, blocks = tauleap_cuda.launch_geometry(group or model.num_reactions, b, SMS)
    if threads is not None:
        need = -(-b // (32 // g)) * 32  # the threads of the warps that hold lanes
        t, blocks = threads, -(-need // threads)
    out = torch.empty((b, c) if final_only else (b, t_max + 1, c), device=x0.device)
    k0, k1 = seed_key(SEED)

    def run():
        rc = lib.epi_traj(family, k, transpose, x0.data_ptr(), theta.data_ptr(), out.data_ptr(),
                          b, model.theta_dim, per_theta, k0, k1, 3, 0, 1, 1, 0,  # identity map
                          t_max, 20, 1.0 / 20,
                          int(final_only), g, t, blocks,
                          torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out

    return run


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("the ablation needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    shipped = _build.load_library()
    libs = {"shipped": (shipped, None), **build_variants()}
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator().manual_seed(SEED)
    cases = {}
    for label, model, lanes, per_theta in (
            ("sir", sir_model(), FILTER_LANES, PER_THETA),
            ("k8", sir_subgroups_model(8), FILTER_LANES, PER_THETA),
            ("seir", seir_model(), SEIR_LANES, SEIR_PER_THETA)):
        x0, th, _ = _lane_inputs(model, lanes, gen)
        cases[f"{label} filter"] = (model, x0, th[::per_theta].contiguous(), 1, True, per_theta)
        x0, th, _ = _lane_inputs(model, ABC_LANES, gen)
        cases[f"{label} abc"] = (model, x0, th, 14, False, 1)
    result = {"device": smi, "cases": {}, "scan": []}
    for case, args in cases.items():
        reactions = args[0].num_reactions
        runs = {name: launcher(lib, *args, group=g and g(reactions))
                for name, (lib, g) in libs.items()}
        runs["threads_256"] = launcher(shipped, *args, threads=256)
        model, x0, theta, t_max, final_only, per_theta = args
        other_mode = "full_trajectory" if final_only else "final_only"
        runs[other_mode] = launcher(shipped, model, x0, theta, t_max, not final_only, per_theta)
        ref = runs["shipped"]().clone()
        ref_final = ref if final_only else ref[:, -1]
        for name, fn in runs.items():
            if name in TIMING_ONLY:
                continue
            out = fn()
            if name == other_mode:  # the same final state, written the other way
                same = torch.equal(out if not final_only else out[:, -1], ref_final)
            else:
                same = torch.equal(out, ref)
            torch.cuda.synchronize()
            if not same:
                raise AssertionError(f"{name} at {case} differs from the shipped kernel")
        order = list(runs)
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            times[name].append(cuda_ms(runs[name], reps=20))
        result["cases"][case] = {"lanes": x0.shape[0], "t_max": t_max,
                                 "final_only": final_only, "ms": times}
        print(json.dumps({case: times}), flush=True)
    sir = sir_model()
    for w in SCAN_WARPS_PER_SM:
        lanes = SMS * 16 * w  # 16 lanes of 2 threads fill a warp
        x0, th, _ = _lane_inputs(sir, lanes, gen)
        run = launcher(shipped, sir, x0, th[::PER_THETA].contiguous(), 1, True, PER_THETA)
        ms = cuda_ms(run, reps=20)
        row = {"warps_per_sm": w, "lanes": lanes, "ms": ms, "us_per_substep": 1e3 * ms / 20,
               "ns_per_lane_substep": 1e6 * ms / (20 * lanes)}
        result["scan"].append(row)
        print(json.dumps(row), flush=True)
    result["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
