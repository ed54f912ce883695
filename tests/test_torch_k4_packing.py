"""K4's map of threads to a lane's reactions (``csrc/tauleap_kernel.cuh``,
part (a)): a lane of R <= 32 reactions takes exactly R consecutive threads
of a warp, floor(32 / R) lanes a warp, and the warp's other threads belong
to no lane.

On the CPU the kernel's own source runs under ``HOST_WARP``, a host stand-in
for the few CUDA names it uses (a warp is 32 threads, ``__shfl_sync`` a
barrier over its mask, counting every shuffle whose mask leaves out the
caller or its source), compiled by the host's g++, against the plain twin
(``tauleap_cuda.simulate_lanes_reference``) on the same Philox counters:
hand-written and generated functors of R = 2 to 40, ragged lane counts,
both modes, the identity and a chain-sharded lane map.  On the card the
packed launch runs against the twin there (marked ``cuda``).  This file
imports neither JAX nor epitpu, so the card runs it with ``--noconftest``."""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from epitpu_torch import profiling
from epitpu_torch.models import make_model, seir_model, sir_model, sir_subgroups_model
from epitpu_torch.ops import _build, rate_trace, tauleap_cuda
from epitpu_torch.rng import seed_key

HOST_WARP = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <stdint.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct HostDim { unsigned x; };
inline thread_local HostDim threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
struct HostWarp {
  std::mutex m;
  std::map<unsigned, std::unique_ptr<std::barrier<>>> groups;
  float vals[32];
  int stray = 0;
};
inline thread_local HostWarp* host_warp;
inline int host_stray = 0;
inline float __shfl_sync(unsigned mask, float v, int src, int width = 32) {
  const int me = threadIdx.x % 32, from = (me / width) * width + src % width;
  std::barrier<>* group;
  {
    std::lock_guard<std::mutex> hold(host_warp->m);
    if (!((mask >> me) & 1u) || !((mask >> from) & 1u)) host_warp->stray++;
    auto& g = host_warp->groups[mask];
    if (!g) g = std::make_unique<std::barrier<>>(__builtin_popcount(mask));
    group = g.get();
  }
  host_warp->vals[me] = v;
  group->arrive_and_wait();
  const float got = host_warp->vals[from];
  group->arrive_and_wait();
  return got;
}
template <class F, class... A>
void host_launch(int blocks, int threads, F kernel, A... args) {
  for (int bk = 0; bk < blocks; ++bk) {
    for (int w = 0; w < threads / 32; ++w) {
      HostWarp warp;
      std::vector<std::thread> team;
      for (int t = 0; t < 32; ++t) {
        team.emplace_back([&, t] {
          threadIdx.x = w * 32 + t, blockIdx.x = bk, blockDim.x = threads, host_warp = &warp;
          kernel(args...);
        });
      }
      for (auto& t : team) t.join();
      host_stray += warp.stray;
    }
  }
}
extern "C" int host_stray_shuffles() { return host_stray; }
"""
LAUNCH = "traj_kernel<M><<<l.blocks, l.threads, 0, l.stream>>>("
HOST_LAUNCH = "host_launch(l.blocks, l.threads, traj_kernel<M>, "


def _chain_rates(x, theta):
    return torch.stack([theta[..., r] * x[..., r] for r in range(x.shape[-1] - 1)], dim=-1)


def chain_model(reactions):
    """A linear chain x_0 -> x_1 -> ... -> x_R, reaction r at rate theta_r
    x_r: a generated functor of any R."""
    c = reactions + 1
    stoich = [[-1 if j == r else 1 if j == r + 1 else 0 for j in range(c)]
              for r in range(reactions)]
    return make_model(f"chain{reactions}", tuple(f"x{j}" for j in range(c)), stoich,
                      list(range(reactions)), _chain_rates, reactions,
                      tuple(f"k{r}" for r in range(reactions)))


def _sirs_rates(x, theta):
    s, i, r = x.unbind(-1)
    n = s + i + r
    return torch.stack([theta[..., 0] * s * i / torch.clamp(n, min=1.0), theta[..., 1] * i,
                        theta[..., 2] * r], dim=-1)


def sirs_model():
    """SIRS, waning immunity R -> S: three reactions on the generated route."""
    return make_model("sirs", ("s", "i", "r"), [[-1, 1, 0], [0, -1, 1], [1, 0, -1]], [0, 1, 2],
                      _sirs_rates, 3, ("beta", "gamma", "omega"))


MODELS = {
    "sir": sir_model,  # R = 2
    "seir": seir_model,  # R = 3
    "k3": lambda: sir_subgroups_model(3),  # R = 6
    "k3_textbook": lambda: sir_subgroups_model(3, reference_dynamics=False),
    "k5": lambda: sir_subgroups_model(5),  # R = 10
    "k7": lambda: sir_subgroups_model(7),  # R = 14
    "sirs_generated": sirs_model,  # R = 3
    "seir_generated": lambda: dataclasses.replace(seir_model(), kernel=None),
    "chain5_generated": lambda: chain_model(5),
    "chain7_generated": lambda: chain_model(7),
    "k12_generated": lambda: sir_subgroups_model(12),  # R = 24: one lane a warp
    "k20_generated": lambda: sir_subgroups_model(20),  # R = 40: two passes a thread
}
HOST_LANES = (1, 9, 11, 31, 33)  # part-filled warps at every R
CARD_MODELS = ("seir", "k3", "k5", "sirs_generated")
CARD_LANES = (1, 9, 11, 31, 33, 513)


def _lane_inputs(model, b, seed):
    """Lanes across an epidemic: every group of three compartments (SIR, K
    groups, SIRS) 20-1,500 infected and 0-1,000 removed of 4,820; SEIR an
    exposed share too; a chain spread over its compartments; theta around
    the presets' truths."""
    rng = np.random.default_rng(seed)
    c = model.num_compartments
    if model.name.startswith("chain"):
        x0 = rng.integers(0, 2000, size=(b, c))
        th = rng.uniform(0.2, 2.0, size=(b, model.theta_dim))
    elif c == 4:
        e0, i0 = rng.integers(20, 1000, size=(2, b))
        x0 = np.stack([4820 - e0 - i0, e0, i0, 0 * i0], -1)
        th = rng.uniform([3.0, 0.7, 0.7], [5.0, 1.3, 1.3], size=(b, 3))
    else:
        i0 = rng.integers(20, 1500, size=(b, c // 3))
        r0 = rng.integers(0, 1000, size=(b, c // 3))
        x0 = np.stack([4820 - i0 - r0, i0, r0], -1).reshape(b, c)
        th = rng.uniform(0.5, 3.0, size=(b, model.theta_dim))
    return (torch.from_numpy(x0.astype(np.float32)).contiguous(),
            torch.from_numpy(th.astype(np.float32)).contiguous())


def _per_theta(b):
    """Lanes a theta row in the final mode: the largest divisor of b up to 16."""
    return max(d for d in range(1, 17) if b % d == 0)


# ---- on the host -------------------------------------------------------------

def _host_build(d, header, units):
    """Build each ``{name: .cu path}`` of ``units`` in ``d`` for the host,
    beside HOST_WARP and ``header`` (the kernel's source, its launch made a
    host_launch); {name: ctypes library}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on PATH to build the kernel for the host")
    assert header.count(LAUNCH) == 1
    (d / "cuda_runtime.h").write_text(HOST_WARP)
    (d / "tauleap_kernel.cuh").write_text(header.replace(LAUNCH, HOST_LAUNCH))
    procs = {name: subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(d), "-x", "c++", str(src), "-o", f"{src}.so"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name, src in units.items()}
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(f"{units[name]}.so")
    return libs


@pytest.fixture(scope="module")
def host_entries(tmp_path_factory):
    """{model name: (ctypes entry, its leading arguments)}, from the hand
    library and each generated functor's, built from the package's own
    sources for the host; and the libraries."""
    d = tmp_path_factory.mktemp("k4_host")
    shutil.copy(_build.CSRC / "tauleap.cu", d / "tauleap.cu")
    units = {"hand": d / "tauleap.cu"}
    for name, make in MODELS.items():
        model = make()
        if tauleap_cuda.route(model) == "generated":
            units[name] = d / f"{name}.cu"
            units[name].write_text(_build.generated_source(rate_trace.functor_source(model)))
    libs = _host_build(d, (_build.CSRC / "tauleap_kernel.cuh").read_text(), units)
    hand = _build.bind(libs["hand"], "epi_traj").epi_traj
    entries = {}
    for name, make in MODELS.items():
        if name in libs:
            entries[name] = (_build.bind(libs[name], _build.GENERATED).epi_traj_generated, ())
        else:
            entries[name] = (hand, tauleap_cuda.hand_args(make()))
    return entries, libs


def _host_run(entry, model, x0, theta, seed, offset, t_max, n_sub, final_only=False, lpt=1,
              lane_map=tauleap_cuda.IDENTITY_LANE_MAP):
    """The host build's launch in ``launch_geometry``'s shape into an output
    of NaN, so an entry no thread writes stays unequal to everything."""
    fn, lead = entry
    b, c = x0.shape
    out = torch.full((b, c) if final_only else (b, t_max + 1, c), float("nan"))
    k0, k1 = seed_key(seed)
    group, threads, blocks = tauleap_cuda.launch_geometry(model.num_reactions, b)
    rc = fn(*lead, x0.data_ptr(), theta.data_ptr(), out.data_ptr(), b, theta.shape[1], lpt, k0,
            k1, offset, *lane_map, t_max, n_sub, 1.0 / n_sub, int(final_only), group, threads,
            blocks, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("sharded", [False, True], ids=["identity", "chain_sharded"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_packed_kernel_equals_twin_on_host(host_entries, name, sharded):
    """At ragged lane counts, in both modes (a theta row a lane; the final
    state with a theta row per up to 16 lanes), over 3 units of 2 substeps:
    every lane equal to the twin bit for bit, every entry written, no
    shuffle outside its group."""
    entries, libs = host_entries
    model = MODELS[name]()
    twin = tauleap_cuda.simulate_lanes_reference
    for b in HOST_LANES:
        x0, th = _lane_inputs(model, b, b)
        lpt = _per_theta(b)
        lane_map = (5, lpt, lpt, 0) if sharded else tauleap_cuda.IDENTITY_LANE_MAP
        th_chain = th[::lpt].contiguous()
        seed, off = 2026 + b, 7
        full = _host_run(entries[name], model, x0, th, seed, off, 3, 2, lane_map=lane_map)
        final = _host_run(entries[name], model, x0, th_chain, seed, off, 3, 2, True, lpt,
                          lane_map)
        assert torch.equal(full, twin(model, x0, th, seed, off, 3, 2, lane_map=lane_map))
        assert torch.equal(final, twin(model, x0, th_chain, seed, off, 3, 2, True, lpt,
                                       lane_map=lane_map))
    for lib in libs.values():
        assert lib.host_stray_shuffles() == 0


def test_a_stray_shuffle_is_caught_on_host(tmp_path):
    """The stand-in sees a kernel whose shuffle reads outside its group:
    the source lane taken within the warp's first group, as a shuffle of
    width 32 without the group's base would."""
    header = (_build.CSRC / "tauleap_kernel.cuh").read_text()
    good = "__shfl_sync(mask, ev[q / G], base + q % G)"
    assert header.count(good) == 1
    shutil.copy(_build.CSRC / "tauleap.cu", tmp_path / "tauleap.cu")
    lib = _host_build(tmp_path, header.replace(good, "__shfl_sync(mask, ev[q / G], q % G)"),
                      {"hand": tmp_path / "tauleap.cu"})["hand"]
    model = seir_model()
    entry = (_build.bind(lib, "epi_traj").epi_traj, tauleap_cuda.hand_args(model))
    x0, th = _lane_inputs(model, 11, 1)
    got = _host_run(entry, model, x0, th, 3, 1, 1, 1)
    assert lib.host_stray_shuffles() > 0
    assert not torch.equal(got, tauleap_cuda.simulate_lanes_reference(model, x0, th, 3, 1, 1, 1))


# ---- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_MODELS)
def test_packed_launch_equals_twin_on_card(name):
    """SEIR, K = 3 and K = 5 subgroups and generated SIRS at lane counts
    that leave a warp part-filled, in both modes, with the identity and a
    chain-sharded lane map: the kernel equal to the twin on the card bit for
    bit, and the launch's thread slots the warps that hold lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    model = MODELS[name]()
    r = model.num_reactions
    sim, twin = tauleap_cuda.simulate_lanes, tauleap_cuda.simulate_lanes_reference
    for b in CARD_LANES:
        x0, th = (a.cuda() for a in _lane_inputs(model, b, b))
        lpt = _per_theta(b)
        th_chain = th[::lpt].contiguous()
        seed, off = 3100 + b, 5
        for lane_map in (tauleap_cuda.IDENTITY_LANE_MAP, (5, lpt, lpt, 0)):
            for args in ((x0, th, seed, off, 3, 2, False, 1),
                         (x0, th_chain, seed, off, 3, 2, True, lpt)):
                with profiling.recording() as rec:
                    got = sim(model, *args, lane_map=lane_map)
                want = twin(model, *args, lane_map=lane_map)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (name, b, lane_map, args[6])
                warps = -(-b // (32 // min(r, 32)))
                assert rec.counters["k4.thread_slots"] == warps * 32 * -(-r // 32)
                assert rec.counters["k4.reaction_slots"] == b * r
