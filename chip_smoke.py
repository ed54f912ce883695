"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

Phases, one or more lines each on stdout:
  1. device   nvidia-smi name and power limit, torch and CUDA versions;
  2. build    nvcc builds epitpu_torch/csrc/tauleap.cu (sm_90a) and, in
              parallel, the generated functors' libraries of SIR, SEIR,
              K = 2 T and K = 8 T (their KernelSpec removed), K = 12, K = 20
              and SIRS; seconds, registers, stack and spills of each, and
              K4's Sir and Seir on a line of their own;
  3. kernel   every instantiation of the tau-leap kernel against its plain
              torch twin on the card, in both modes (the full trajectory
              with a theta row per lane; the final state with one theta row
              per up to 16 lanes, the filter's): SIR, SEIR, 2-group SIR
              with each dynamics, 8-group SIR timed at the filter shape
              (32,768 lanes, 1 unit, 20 substeps, final state) and the ABC
              shape (512 lanes, 14 units, 20 substeps), SIR also at the
              forecast shape (200, 5, 20), each beside the one-thread-per-lane
              design's time (PERF.md's kernel table), its bound (operations
              or bytes), its share of the bound, us per substep and ns per
              lane-substep, and the SM clock; untimed at
              the other lane counts phases 5-11 launch (300/200-lane PMMH
              presets and their init searches, the production init search,
              ABC at batch 65,536, the runner's sweep and its init search,
              its surface and forecast, the app's 30 lanes x 31 units), at
              1, 31, 33 and 513 lanes for SIR, SEIR and K = 3, 5, 8, and
              every other K = 1..8 subgroup instantiation at 300 lanes;
  3b. weight_kernel  the weighting kernel (csrc/obs_binomial.cu) against
              its plain twin on the card, bit for bit: edge cases (k = 0,
              k = n, n = 0, k > n, k < 0, NaN states; p = 0, 1, clamped
              near 0 and 1, one per chain; C = 1 to 60) and the tau-leap's
              own states at both PMMH cells' shapes (2,048 x 16 and 32 x
              4,096, every filter step), min and sum; its ms from idle and
              back to back beside the twin's, the bound and its share; a
              production-preset PMMH run (40 rows): one launch a filter
              step, init search included, and its chains equal to the same
              seed's run on the plain weighting bit for bit;
  3c. loglik_kernel  the likelihood update (csrc/pf_loglik.cu) against its
              plain twin on the card, bit for bit: rows of N = 1 to 32,768
              (1, 32 and 2,048 rows; rows all -inf, with one finite entry,
              a NaN, a +inf, an empty carry), both forms; a row's result
              the same among 1, 7 or all rows; both PMMH cells' shapes
              over the filter steps of K4's states and the weighting
              kernel's log-weights; its ms from idle and back to back, its
              device us from the profiler, host us a call, the twin's ms,
              the bound (12 bytes a particle) and its share, registers and
              stack; a production-preset PMMH run (40 rows): one launch a
              filter step, and its chains equal to the same seed's run on
              the twin bit for bit;
  3d. resample_kernel  the systematic resampling step (csrc/pf_resample.cu)
              against its plain twin on the card, bit for bit: rows of N = 1
              to 65,536 (1, 32 and 2,048 rows; rows all -inf, with a NaN, a
              +inf, rows that skip), both forms, a four-card shard's slices
              of 4,096 (p0 0 and 3,072, 1,024 each); a row's result the
              same among 1, 7 or all rows; both PMMH cells' shapes over the
              resampling steps of K4's states, weighed and updated by the
              two K2 kernels; its ms from idle and back to back, its device
              us, host us a call, the twin's ms, the bound (40 bytes a
              particle at C = 3) and its share, registers and stack; a
              production-preset PMMH run (40 rows): one launch a resampling
              step (every 4th filter step), and its chains equal to the
              same seed's run on the twin bit for bit;
  4. filter   particle-filter logZ at the truth on the card against the
              host (512 replicates, N=16): SIR on the committed dataset,
              SEIR, sir_subgroups and sir_subgroups2 on the port's
              generate_dataset data of their presets; the Gaussian
              `sir_noisy` and the binomial `sir_infer_p` data with three
              levels of the observation parameter, one per chain, in one
              batch (the levels' logZ must differ, and the true p rank
              first); and the subgroup initial cloud drawn on the card
              (per-group Poisson);
  5. pmmh     the CLI's `production` preset (epitpu/cli/run.py:730-746),
              turned into arguments by `pmmh_arguments` as the other PMMH
              phases are, on the committed dataset: N self-sized from 16, 2,048
              chains, pooled adaptive h=0.6 from iteration 16,
              resample_every=4, theta only; 200 iterations instead of 2,000;
  6. forecast the committed 2-chain checkpoint (step 59) continued for 100
              rows (segment_len=100 of n_iters=160; the `sir_underreported`
              preset's h=0.05, 100 particles) with trajectories, then a
              5-unit posterior forecast;
  7. pmmh-models  the `seir_underreported`, `sir_subgroups` and
              `sir_subgroups2` presets (epitpu/cli/run.py:760-770, :778-805)
              at their own chains, particles and h on their generate_dataset
              data; 200 iterations instead of 1,000 / 500 / 500;
  8. abc      the `sir_abc` preset (epitpu/cli/run.py:771-777: 100 samples,
              threshold 150, U(0, 5) priors, batch 512) on the port's ODE
              data, then the same at batch 65,536;
  9. resume   256 chains x 16 particles: 40 rows in one call against 20 + 20
              rows, bit for bit; a theta-only run's thetas against a storing
              run's;
 10. cli-*    the experiment runner's entry point, `epitpu_torch.cli.run.main`
              with `--device cuda --no-plots`, each in a temporary working
              directory: the `production` preset at 2,048 chains (200
              iterations, a checkpoint every 100; thetas equal to phase 5's
              bit for bit); `sir_underreported` killed after its first
              60-row segment and resumed (equal to an uninterrupted run bit
              for bit; a resume under another seed refused); `sir_noisy`
              and `sir_infer_p` at 200 iterations; `sir_underreported` with
              a forecast, a 9 x 9 likelihood surface, telemetry and a
              torch.profiler trace (20 iterations); `sir_abc`; the `tmps`
              sweep at 60 iterations;
 11. app      `epitpu_torch.app.simulate_overlay`: 30 trajectories in one
              kernel launch, equal to the twin bit for bit;
 12. exact    the exact SSA (plain torch) on the card against K4 at 40
              substeps with tests/test_sim.py's moment bounds: SIR, 2,048
              lanes x 12 units; K = 2 subgroups at 512 lanes;
              sampler="exact" through `simulate`; the absorbing state;
 13. dist-*   sharded runs (epitpu_torch.dist), each rank a child process
              of this script under a timeout, all on the one card: the
              production preset's chains on a 2 x 1 mesh (two ranks over
              gloo, 40 rows), SIR with each chain's 4,096 particles on a
              1 x 2 mesh (32 chains, 20 rows, paths, and the sharded
              filter's logZ at the truth), a 1-rank NCCL group from the env
              triple (256 chains, 20 rows; the rank bound to card
              LOCAL_RANK); each gathered run against the unsharded run in
              this process, bit for bit;
 14. cli-multihost  the runner with --multihost under a 1-process env
              triple, in a child process; then multichip[1 card]:
              multichip_torch.py's checks with four ranks over gloo sharing
              the card at its full sizes (epitpu's dryrun with its shard
              check; its three gathered runs, the 2 x 2 mesh's chain shards
              among them, against the unsharded runs on the card, bit for
              bit);
 15. user-models  the generated and plain routes end to end: SIRS
              (tests/test_models.py:126-152) PMMH at the production preset's
              shape (2,048 chains x 16, pooled adaptive h=0.6 from 16,
              resample_every=4, theta only, 200 iterations) on its own
              simulated data (T=15, population 4,820, binomial p=0.1) through
              the generated functor and no hand one, posterior means held to
              phase 7's bounds; `particle_mcmc` (one chain) equal to chain 0
              of a one-chain batch and its 5-unit forecast; ABC on SIRS at
              batch 512 and 65,536; 12-group SIR through the filter, logZ on
              the card against the host; the competing-hazards model
              (tests/test_torch_tauleap.py:193) through the filter on the
              plain route, no kernel launch;
 16. repro    the production study, repro_torch.py's main with every stage
              at repro.py's SMOKE sizes (60 iterations, 3 chains x 16
              particles, 5 substeps, 8 production chains) in a temporary
              directory: finite summaries, forecast coverage in [0, 1], the
              production equivalence table, the comparison with repro.json,
              and --report on its printed lines equal to its own record;
 17. bench    bench_torch.py's four arms (32 chains x 4,096 particles at
              h = 0.05, pooled adaptive h = 0.6, the production shape 2,048
              x 16 theta only, resample_every = 1) at 8 / 32 iterations:
              finite thetas, acceptance in (0, 1), the kernel launched in
              each arm;
 18. insitu   insitu_profile_torch.py's phase split at its default shape
              (16 x 4,096, resample_every = 4) and the production shape
              (2,048 x 16, theta only), 4 iterations each: phases summing to
              100 %, at most 5 % of device time unjoined to a launch, the
              tau-leap kernel's time in pf_propagate;
 19. large-regime  tests/test_large_regime.py on the card (population 10^6,
              T = 100): 64 lanes exact integers below 2^24 conserving 10^6,
              the 128-particle filter finite and the truth ahead of (0.6,
              0.1) by more than 50, PMMH 2 x 60 x 64 recovering (0.3, 0.1)
              within 0.05 / 0.03;
 20. studies  every mode of substeps_study_torch.py, ess_study_torch.py and
              scaling_bench_torch.py at a smoke size (full widths, a few
              iterations, row 0 of each ESS grid; the weak-scaling modes as
              gloo processes on the host at widths 1-2): each record holds
              the TPU record's keys and this card's name;
and after phase 3 `kernel[regimes]`: SIR at the filter shape at 5 and 80
substeps a unit, and at population 10^6 (the large regime's filter step,
32 x 1,024 lanes, a theta row per chain, and its T = 100 trajectory at the
ABC batch), each against its twin with its bound; `kernel[generated ...]`:
the generated SIR, SEIR, K = 2 T and K = 8 T functors equal to the hand
ones bit for bit in both modes at the filter and ABC shapes, timed beside
them; K = 12, K = 20 (40 reactions) and SIRS against their twin, timed, and
at ragged lane counts;
`advance[t_span]`: `advance` over 3 units on the card against the twin;
`kernel[lane-map]`: the kernel under a non-identity lane map against its
twin, and a 2-shard filter step's lanes against the unsharded launch's.
Then a `routes:` line (hand, generated and plain launches per main path, and
the weighting's, the likelihood update's and the resampling kernel's), a
JSON line for the kernels, and as the last line {"ok": true, "device":
{...}}.  Phases 5-20 are the main paths: the launch counts are set to 0
before each and read after it (in each child for 13-14, summed over
them).  The kernel libraries are built before any child
starts; children only load them.  Every failed check
raises and exits non-zero; without a CUDA device it raises before printing
any result.
"""
import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from epitpu_torch import app, mcmc
from epitpu_torch.abc import abc_rejection
from epitpu_torch.cli import (PRESETS, build_model, generate_dataset, pmmh_arguments,
                               population_and_mu)
from epitpu_torch.cli import main as cli_main
from epitpu_torch.device import card_name
from epitpu_torch.dist import filter_streams, free_port
from epitpu_torch.diag import ess_rank, gelman_rubin_rank
from epitpu_torch.io import (dataset_from_csv, load_pmmh_checkpoint, load_pmmh_run,
                             pmmh_state_from_numpy)
from epitpu_torch.mcmc import forecast_from_result, particle_mcmc, particle_mcmc_chains
from epitpu_torch.models import make_model, seir_model, sir_model, sir_subgroups_model
from epitpu_torch.observe import get_observation_model
from epitpu_torch.ops import _build, loglik_cuda, rate_trace, resample_cuda, tauleap_cuda
from epitpu_torch.rng import PhiloxStream
from epitpu_torch.sim import advance, simulate
from epitpu_torch.smc import particle_filter

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data", "sir_underreported")
POP = 4820.0
TRUTH = (2.0, 1.0)
SEED = 20261016
DEV = torch.device("cuda")
MODEL_PRESETS = ("seir_underreported", "sir_subgroups", "sir_subgroups2")
CLI_MODEL_PRESETS = ("sir_noisy", "sir_infer_p")  # Gaussian; p inferred per chain
# the shapes the main paths give the kernel, and the smoke's cuts
FILTER_LANES = 32768  # production: 2,048 chains x 16 particles
ABC_LANES = 512  # the sir_abc preset's batch
FILTER_REPS = 512
FILTER_MIN_FINITE = 500  # of FILTER_REPS log-likelihoods
PROD_ITERS = 200
MODELS_ITERS = 200
ABC_BIG_BATCH = 65536
PROD_INIT_LANES = 2048 * 16 * 16  # production's init search: chains x attempts x N
RESUME_CHAINS = 256
CLI_CKPT_EVERY = 100  # cli-production: two segments of PROD_ITERS
CLI_RESUME_ITERS, CLI_RESUME_SEG = 120, 60
CLI_EXTRAS_ITERS, CLI_LOG_EVERY = 20, 5  # the profiled run
CLI_SURFACE_POINTS = 9
CLI_SWEEP_ITERS = 60
APP_ARGS = (2.0, 1.0, 4800.0, 20.0, 31)  # beta, gamma, S0, I0, t
APP_TRAJ = 30
RAGGED_LANES = (1, 31, 33, 513)  # partial warps, groups and blocks
# the sharded phases (two ranks share the one card) and the exact SSA
DIST_CHAIN_ROWS = 40
DIST_PART_CHAINS, DIST_PART_PARTICLES, DIST_PART_ROWS = 32, 4096, 20
NCCL_CHAINS, NCCL_ROWS = 256, 20
CLI_MULTIHOST_ITERS = 20
EXACT_LANES, EXACT_UNITS = 2048, 12  # tests/test_sim.py:36-48
CHILD_TIMEOUT = 300  # seconds, per child process
# posterior-mean bounds; PERF.md section 4 says why they are honest
PMMH_MODELS_REL, PMMH_MODELS_ABS = 0.3, 0.25  # around the truth, per component
ABC_TOL = 0.35  # absolute, per component
KERNEL_NAMES = {
    "sir": "traj_kernel<Sir>",
    "seir": "traj_kernel<Seir>",
    "sir_subgroups": "traj_kernel<SirSubgroups<K, transpose>>",
    "generated": "traj_kernel<GeneratedModel>",
}
PATH_LAUNCHES = {}  # main path -> {family, "generated" or "plain": launches}
# the user models' path (tests/test_models.py:126-152's SIRS) and the routes
SIRS_TRUTH = (2.0, 1.0, 0.3)
SIRD_TRUTH = (2.0, 0.8, 0.2)  # the competing-hazards model of tests/test_torch_tauleap.py:193
USER_CHAINS, USER_ITERS = 2048, 200  # the production preset's shape, 200 iterations
USER_ONE_ITERS = 200  # the one-chain run, then its 200-draw forecast
USER_ABC_SAMPLES, USER_ABC_THRESHOLD = 100, 150.0
K12_POP, K12_MU = 400.0, 3.0  # per group
ADVANCE_SPAN = 3.0


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def missing_keys(got, want, renamed=(), skip=(), path=""):
    """The keys of the record ``want`` (dicts, and the first row of lists of
    dicts, all the way down) that ``got`` lacks; ``renamed`` maps a key of
    ``want`` to its name in ``got``, keys in ``skip`` are not looked for."""
    renamed = dict(renamed)
    if isinstance(want, list) and want and isinstance(want[0], dict):
        if not (isinstance(got, list) and got):
            return [path + "[0]"]
        return missing_keys(got[0], want[0], renamed, skip, path + "[0].")
    if not isinstance(want, dict):
        return []
    out = []
    for key, value in want.items():
        if key in skip:
            continue
        mine = renamed.get(key, key)
        if not isinstance(got, dict) or mine not in got:
            out.append(path + mine)
        else:
            out += missing_keys(got[mine], value, renamed, skip, f"{path}{mine}.")
    return out


def cuda_ms(fn, reps=5, warmup=True):
    """Median milliseconds of ``fn`` over ``reps`` runs (after one warm-up
    run unless ``warmup`` is False), timed with CUDA events."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


PHASE_SECONDS = {}  # phase -> host seconds


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    return out


def on_main_path(name, families, fn, *args):
    """Run one main path with the launch counts (``_build.LAUNCHES``) set to
    0 before it; fail if a kernel family it must use was never launched."""
    _build.LAUNCHES.update(dict.fromkeys(_build.LAUNCHES, 0))
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    counts = dict(_build.LAUNCHES)
    for f in families:
        check(counts[f] > 0, f"main path {name} never launched the {f} kernel")
    PATH_LAUNCHES[name] = counts
    return out


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must stay off")
    smi = card_name(DEV)
    print(smi, flush=True)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return smi


def _instantiation(mangled):
    m = re.search(r"obs_binomial_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        return f"obs_binomial<{m.group(1)},{'min' if m.group(2) == '1' else 'sum'}>"
    m = re.search(r"loglik_(small|rows)ILi(\d+)ELb([01])E", mangled)
    if m:
        return f"loglik_{m.group(1)}<{m.group(2)},{'carry' if m.group(3) == '1' else 'resample'}>"
    m = re.search(r"resample_(small|rows)ILi(\d+)EE", mangled)
    if m:
        return f"resample_{m.group(1)}<{m.group(2)}>"
    m = re.search(r"SirSubgroupsILi(\d+)ELb([01])E", mangled)
    if m:
        return f"SirSubgroups<{m.group(1)},{'T' if m.group(2) == '1' else 'F'}>"
    if "GeneratedModel" in mangled:
        return "GeneratedModel"
    return "Seir" if "Seir" in mangled else "Sir"


def _ptxas_report(ptxas):
    """"name registers/stack/spill-store bytes" of every kernel nvcc's -v
    reported."""
    rows, name = [], None
    for ln in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _instantiation(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
        if m and name:
            rows.append([name, None, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", ln)
        if m and rows and rows[-1][1] is None:
            rows[-1][1] = int(m.group(1))
    return (", ".join(f"{n} {r}/{s}/{sp}" for n, r, s, sp in rows) if rows else
            " | ".join(ln.strip() for ln in ptxas.splitlines()
                       if "registers" in ln or "spill" in ln))


def phase_build():
    """The hand library and the generated functors' libraries, all nvcc runs
    at once."""
    functors = {label: rate_trace.functor_source(m) for label, m in generated_models().items()}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(functors) + 1) as pool:
        hand = pool.submit(_build.build)
        gen = {label: pool.submit(_build.build_generated, f) for label, f in functors.items()}
        path = hand.result()
        gen = {label: f.result() for label, f in gen.items()}
    wall = time.perf_counter() - t0
    report = _ptxas_report(_build.BUILD_INFO.get("ptxas", ""))
    print(f"build: {_build.BUILD_INFO['seconds']:.2f} s -> {os.path.relpath(path, ROOT)}; "
          f"registers/stack bytes/spill-store bytes: {report}", flush=True)
    k4 = [part for part in report.split(", ") if part.split(" ")[0] in ("Sir", "Seir")]
    print(f"build: K4's Sir and Seir registers/stack bytes/spill-store bytes: {', '.join(k4)}",
          flush=True)
    parts = []
    for label, p in gen.items():
        info = _build.GENERATED_INFO[str(p)]
        parts.append(f"{label} {info['seconds']:.2f} s {_ptxas_report(info['ptxas'])}")
    print(f"build: generated functors (KernelSpec removed from the built-ins), {len(gen)} nvcc "
          f"runs beside the hand library's, {wall:.2f} s wall: seconds and registers/stack "
          f"bytes/spill-store bytes: {'; '.join(parts)}", flush=True)


# ---- the user models: SIRS, and competing hazards ---------------------------

def _sirs_rates(x, theta):
    beta, gamma, omega = theta[..., 0], theta[..., 1], theta[..., 2]
    s, i, r = x.unbind(-1)
    n = s + i + r
    return torch.stack([beta * s * i / torch.clamp(n, min=1.0), gamma * i, omega * r], dim=-1)


def _sird_rates(x, theta):
    n = x.sum(-1)
    return torch.stack([theta[..., 0] * x[..., 0] * x[..., 1] / n,
                        theta[..., 1] * x[..., 1], theta[..., 2] * x[..., 1]], -1)


def _one_group_init(generator, shape, n_population=POP, mu=20.0, c_dim=3):
    """I0 ~ Poisson(mu), S0 = N - I0, the other compartments 0."""
    rate = torch.full(tuple(shape), float(mu), dtype=torch.float32, device=generator.device)
    i0 = torch.poisson(rate, generator=generator)
    z = [torch.zeros_like(i0)] * (c_dim - 2)
    return torch.stack([float(n_population) - i0, i0, *z], dim=-1)


@functools.lru_cache(maxsize=None)
def sirs_model():
    """tests/test_models.py:126-152's SIRS (waning immunity R -> S): a user
    model with unique sources, so the generated route."""
    return make_model("sirs", ("s", "i", "r"), [[-1, 1, 0], [0, -1, 1], [1, 0, -1]], [0, 1, 2],
                      _sirs_rates, 3, ("beta", "gamma", "omega"), init_fn=_one_group_init,
                      terminal_compartments=(1,))


@functools.lru_cache(maxsize=None)
def sird_model():
    """I leaves by recovery or death, two reactions sharing source I: the
    plain route."""
    return make_model("sird", ("s", "i", "r", "d"), [[-1, 1, 0, 0], [0, -1, 1, 0], [0, -1, 0, 1]],
                      [0, 1, 1], _sird_rates, 3, ("beta", "gamma", "delta"),
                      init_fn=functools.partial(_one_group_init, c_dim=4),
                      terminal_compartments=(1,))


@functools.lru_cache(maxsize=None)
def generated_models():
    """label -> a model on the generated route: the built-ins with their
    KernelSpec removed (their functors traced from their rate_fn), K = 12
    and K = 20 subgroups, SIRS."""
    plain = lambda m: dataclasses.replace(m, kernel=None)  # noqa: E731
    models = {"sir": plain(sir_model()), "seir": plain(seir_model()),
              "k=2 T": plain(sir_subgroups_model(2)), "k=8 T": plain(sir_subgroups_model(8)),
              "k=12": sir_subgroups_model(12), "k=20": sir_subgroups_model(20),
              "sirs": sirs_model()}
    for label, m in models.items():
        check(tauleap_cuda.route(m) == "generated", f"{label} is not on the generated route")
    return models


GENERATED_VS_HAND = {"sir": sir_model, "seir": seir_model,
                     "k=2 T": lambda: sir_subgroups_model(2),
                     "k=8 T": lambda: sir_subgroups_model(8)}


# ---- phase 3: every kernel instantiation against its twin -----------------

def _family(model):
    """(lane-input family, groups): the built-in families by name, SIRS."""
    if model.name.startswith("sir_subgroups"):
        return "sir_subgroups", model.num_compartments // 3
    return model.name, 1


def _lane_inputs(model, b, gen):
    """Lanes across the epidemic, so both binomial regimes fire: per group a
    population of 1,000-5,000 (SIR, SIRS: 4,820), up to 30 % infected (SEIR:
    20 % exposed and 20 % infectious), a random removed share; theta spread
    around the presets' truths (SIRS: around SIRS_TRUTH)."""
    fam, groups = _family(model)
    if fam in ("sir", "sirs"):
        pop = torch.full((b, 1), POP)
    else:
        pop = torch.randint(1000, 5001, (b, groups), generator=gen).float()
    if fam == "seir":
        e0 = torch.floor(0.2 * pop * torch.rand(b, 1, generator=gen))
        i0 = torch.floor(0.2 * pop * torch.rand(b, 1, generator=gen))
        r0 = torch.floor(torch.rand(b, 1, generator=gen) * (pop - e0 - i0))
        x0 = torch.stack([pop - e0 - i0 - r0, e0, i0, r0], -1)
        lo, hi = torch.tensor([3.0, 0.7, 0.7]), torch.tensor([5.0, 1.3, 1.3])
    else:
        if fam in ("sir", "sirs"):
            i0 = torch.randint(0, 1500, (b, 1), generator=gen).float()
            lo, hi = torch.tensor([1.5, 0.7]), torch.tensor([2.5, 1.3])
            if fam == "sirs":
                lo, hi = torch.tensor([1.5, 0.7, 0.1]), torch.tensor([2.5, 1.3, 0.5])
        else:
            i0 = torch.floor(0.3 * pop * torch.rand(b, groups, generator=gen))
            lo = torch.tensor([0.5] * groups ** 2 + [0.3])
            hi = torch.tensor([5.0] * groups ** 2 + [1.0])
        r0 = torch.floor(torch.rand(b, groups, generator=gen) * (pop - i0))
        x0 = torch.stack([pop - i0 - r0, i0, r0], -1)
    theta = lo + (hi - lo) * torch.rand(b, lo.numel(), generator=gen)
    return x0.reshape(b, -1).to(DEV).contiguous(), theta.to(DEV).contiguous(), groups


# The one-thread-per-lane design's kernel times (one call each; NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md section 6, the kernel table), for the cases
# this phase times: constants, printed beside this run's times on the kernel
# lines and nowhere else.  `ms` is timed as those were, one call from an idle
# device (which counts the wrapper's host time before the launch); `b2b_ms`
# is a launch's share of BACK_TO_BACK launches in a row, the kernel without
# that host time.
BACK_TO_BACK = 10
ONE_THREAD_MS = {
    ("sir", "filter"): 0.1633, ("sir", "abc"): 1.9419, ("sir", "forecast"): 0.6539,
    ("seir", "filter"): 0.2041, ("seir", "abc"): 2.6443,
    ("sir_subgroups k=2 transposed", "filter"): 0.2538,
    ("sir_subgroups k=2 transposed", "abc"): 3.6295,
    ("sir_subgroups k=2 textbook", "filter"): 0.2950,
    ("sir_subgroups k=2 textbook", "abc"): 3.6537,
    ("sir_subgroups k=8 transposed", "filter"): 0.6183,
    ("sir_subgroups k=8 transposed", "abc"): 13.6141,
}
# The least time the card could take for a launch: the larger of its
# operations over PEAK_OPS (132 SMs x 128 float32 lanes x 1.98 GHz, no FMA
# pairs: the build has --fmad=false) and its bytes (x0 and theta read once,
# the output written once) over PEAK_BYTES.  Operations are counted per line
# of epitpu_torch/csrc/tauleap.cu, each +, -, *, /, comparison, select,
# min/max, shift, bit operation, int->float conversion and call of
# expf/log1pf/expm1f/logf/sqrtf/cosf/floorf as one:
PEAK_OPS, PEAK_BYTES = 33.5e12, 3.35e12
OPS_PHILOX = 100  # philox(): 10 rounds x (2 __umulhi, 2 multiplies, 4 xors, 2 key adds)
OPS_FIRE = 11  # fire_probability(): compare, select, 2 max, divide, 2 negate, multiply,
#                expm1f, max, min
OPS_BINOMIAL = 14  # binomial() around the regimes: clamp 2, flip test, 1-p, select,
#                    lam, regime test, flip (subtract, select), p==0 and p==1 (2 each)
OPS_SMALL = 14  # small regime: uniform() 3, min, 1-ps, ratio divide, negate, log1pf,
#                 multiply, expf; the exiting test; final test and add, min
OPS_TERM = 9  # per CDF term: test, x+1, 2 int->float, n-k, multiply, divide, *ratio,
#               max, cdf add (the terms these inputs need, as the twin counts them)
OPS_NORMAL = 32  # normal regime: box_muller() 13 (2 uniforms, max, logf, multiply,
#                  sqrtf, multiply, cosf, multiply), Cornish-Fisher and rounding 19


def ops_rates(model):
    """Operations of one lane-substep's rates (the model's rate_fn, the
    population sum once) and its 2 R state updates; for a generated functor
    the traced program's operations, each once however many reactions share
    it (as the population sum above), and one per nonzero stoichiometry
    entry."""
    spec = model.kernel
    r = model.num_reactions
    if tauleap_cuda.route(model) == "generated":
        return rate_trace.trace_rates(model).operations() + int(np.count_nonzero(model.stoich))
    if spec.family == "sir":
        rates = 6  # n: 2 adds; beta s i / n: 3; gamma i: 1
    elif spec.family == "seir":
        rates = 8  # n: 3; beta s i / n: 3; alpha e, gamma i: 2
    else:
        kk = spec.k  # n: 3K-1; per group force K mul + K-1 add, s force / n: 2; recovery K
        rates = 2 * kk * kk + 5 * kk - 1
    return rates + 2 * r


def bound(model, b, t_max, theta_rows, final_only, work, n_sub=20):
    """(bound ms, "operations" or "bytes", ops, bytes) of one launch of
    ``t_max`` units of ``n_sub`` substeps from the twin's counts of draws,
    small-regime draws and CDF terms."""
    c, d = model.num_compartments, model.theta_dim
    ops = (b * t_max * n_sub * ops_rates(model)
           + work["draws"] * (OPS_PHILOX + OPS_FIRE + OPS_BINOMIAL)
           + work["small"] * OPS_SMALL + work["terms"] * OPS_TERM
           + (work["draws"] - work["small"]) * OPS_NORMAL)
    nbytes = 4 * (b * c + theta_rows * d + b * c * (1 if final_only else t_max + 1))
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return 1e3 * max(t_ops, t_bytes), by, ops, nbytes


# ---- the weighting kernel (csrc/obs_binomial.cu) ----------------------------

WEIGHT_CELLS = ((2048, 16), (32, 4096))  # the benchmark's PMMH cells: chains x particles
WEIGHT_PMMH_ITERS = 40  # the same-seed production runs, each kernel against its twin
HBM_BYTES_PER_S, OPS_PER_S = 3.35e12, 33.5e12  # the H100's bounds, PERF.md section 6


def _same_bits(a, b):
    """Equal bit for bit, NaN equal to NaN (its payload aside)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return bool(a.shape == b.shape and torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def _weight_edges(gen):
    """(label, y, x, p) cases at the edges of binom_logpmf: k = 0, k = n,
    n = 0, k > n, k < 0, NaN states; p = 0, 1, clamped near 0 and 1, and a p
    per chain with some chains at 0 or 1; C = 1, 3, 4, 6, 24, 36, 60; and
    chains whose every compartment is finite, where a sum's order shows."""
    cases = []
    for c in (1, 3, 4, 6, 24, 36, 60):
        x = torch.floor(10 ** (torch.rand((8, 64, c), generator=gen, device=DEV) * 4))
        y = torch.floor(x[0, 0] * 0.1)
        y[0] = 0.0
        x[0, :4] = 0.0  # n = 0 (k = 0 for c = 0)
        x[1, :8, :] = y  # k = n
        x[2, :8, :] = y - 1.0  # k > n
        x[3, 0, 0] = float("nan")
        x[3, 1, :] = float("nan")
        x[4, :8] = torch.floor(y * 0.5)
        x[5:] = y + torch.floor(y * 9 + torch.rand((3, 64, c), generator=gen, device=DEV) * 100)
        per_chain = torch.tensor([0.1, 0.0, 1.0, 1e-12, 1.0 - 1e-9, 0.5, 0.9, float("nan")],
                                 device=DEV)
        y_neg = y.clone()
        y_neg[-1] = -1.0  # k < 0
        for label, p in (("p=0.1", torch.tensor(0.1, device=DEV)),
                         ("p=0", torch.tensor(0.0, device=DEV)),
                         ("p=1", torch.tensor(1.0, device=DEV)),
                         ("p=1e-12", torch.tensor(1e-12, device=DEV)),
                         ("p=1-1e-9", torch.tensor(1.0 - 1e-9, device=DEV)),
                         ("p per chain", per_chain[:, None, None])):
            cases.append((f"C={c} {label}", y, x, p))
        cases.append((f"C={c} k<0", y_neg, x, torch.tensor(0.1, device=DEV)))
    return cases


def _weight_states(model, chains, n, y, gen, truth=TRUTH):
    """The tau-leap's own states at the filter's shape: the initial cloud and
    each of the T - 1 steps after it at theta ``truth`` (no resampling), one
    row of y each."""
    from epitpu_torch.sim.tauleap import advance

    x = model.init_fn(gen, (chains, n), POP, 20.0).to(torch.float32).contiguous()
    theta = torch.tensor(truth, device=DEV).expand(chains, len(truth))[:, None, :]
    stream = PhiloxStream(SEED + 7, DEV)
    for t in range(y.shape[0] - 1):
        yield y[t], x
        x = advance(model, x, theta, stream, 20, "fast", gen)


def _time_against_twin(label, call, twin, event, ops_per_twin_launch, nbytes, ops=None):
    """A hand kernel's ``call`` against its twin's on the card: the kernel's
    ms for one call from idle and back to back (CUDA events around the
    Python call), its device us (the profiler's events whose name holds
    ``event``, median of 20), the host's us a call, the twin's ms and device
    launches, the bound (``ops_per_twin_launch`` operations for each of the
    twin's launches, or ``ops`` in all, and ``nbytes`` bytes, at the H100's
    peaks) and its shares.  Prints them after ``label``; returns them."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        twin()
        torch.cuda.synchronize()
    twin_ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    ms = cuda_ms(call, reps=20)
    b2b = cuda_ms(lambda: [call() for _ in range(10)], reps=5) / 10
    plain_ms = cuda_ms(twin, reps=5)
    # the kernel's own device time (the events above also hold the host's
    # dispatch of each call), and the host's time a call
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    device_us = float(np.median([e.time_range.elapsed_us() for e in prof.events()
                                 if event in e.name] or [float("nan")]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    bound_ops = (twin_ops * ops_per_twin_launch if ops is None else ops) / OPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    row = dict(ms=ms, b2b_ms=b2b, device_us=device_us, host_us=host_us, plain_ms=plain_ms,
               twin_launches=twin_ops, bound_ms=bound_ms,
               bound_by="ops" if bound_ops >= bound_bytes else "bytes",
               bound_share=bound_ms / ms, bound_share_b2b=bound_ms / b2b,
               bound_share_device=bound_ms * 1e3 / device_us)
    print(f"{label}; kernel {ms:.4f} ms one call, {b2b:.4f} ms back to back (events around "
          f"the Python call), {device_us:.2f} us on the device (profiler, median of 20), "
          f"{host_us:.2f} us of host a call; twin {plain_ms:.4f} ms ({twin_ops} launches); "
          f"bound {bound_ms:.5f} ms by {row['bound_by']} (ops {bound_ops:.5f}, bytes "
          f"{bound_bytes:.5f}); share of bound {100 * row['bound_share']:.2f} % one call, "
          f"{100 * row['bound_share_b2b']:.2f} % back to back, "
          f"{100 * row['bound_share_device']:.2f} % of the device time; SM clock "
          f"{_sm_clock()}", flush=True)
    return row


def _pmmh_against_twin(label, model, obs, y, key, phase, module, name, twin,
                       resampling=False):
    """The production preset at WEIGHT_PMMH_ITERS rows on one seed, on hand
    kernel ``key`` and on its twin, bound for that run to ``module.name``,
    the name the program calls the kernel's wrapper by: the kernel's
    launches (``_build.LAUNCHES[key]``) == its profiling counter == the
    steps it serves: the spans of ``phase``, one a filter step, or with
    ``resampling`` the filter's resampling steps, every
    ``resample_every``-th; none on the twin; the two runs' thetas and
    log-likelihoods equal bit for bit.  Prints them after ``label``;
    returns the JSON entry's fields."""
    from epitpu_torch import profiling

    cfg = PRESETS["production"]()
    cfg.seed = SEED
    cfg.mcmc.n_iters = WEIGHT_PMMH_ITERS
    kw, _ = pmmh_arguments(cfg, model, obs, y, DEV)
    kernel_wrapper, runs = getattr(module, name), {}
    for run, wrapper in (("kernel", kernel_wrapper), ("twin", twin)):
        setattr(module, name, wrapper)
        try:
            torch.cuda.synchronize()
            launches0 = _build.LAUNCHES[key]
            t0 = time.perf_counter()
            with profiling.recording() as rec:
                res = particle_mcmc_chains(model, obs, y.to(DEV), **kw)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            setattr(module, name, kernel_wrapper)
        names = [sp.name for sp in rec.spans]
        runs[run] = dict(res=res, wall=wall, launches=_build.LAUNCHES[key] - launches0,
                         counter=rec.counters.get(_build.PROFILED[key], 0),
                         steps=names.count(phase), filters=names.count("pf_scan"))
    k, tw = runs["kernel"], runs["twin"]
    t_len = y.shape[0]
    every = kw["resample_every"] if resampling else 1
    served = k["filters"] * ((t_len - 1) // every)
    what = f"resampling steps (every {every}th)" if resampling else "filter steps"
    check(k["launches"] == k["counter"] == served and k["steps"] == (t_len - 1) * k["filters"],
          f"{label}: launches {k['launches']}, counter {k['counter']}, filter steps "
          f"{k['steps']}, filters {k['filters']} x {t_len - 1}: not one launch a "
          f"{'resampling' if resampling else 'filter'} step")
    check(tw["launches"] == 0 and tw["steps"] == k["steps"],
          f"{label}: the twin's run launched {tw['launches']} and made {tw['steps']} filter "
          f"steps")
    for field in ("thetas", "log_likelihoods"):
        check(_same_bits(getattr(k["res"], field), getattr(tw["res"], field)),
              f"{label}: production PMMH on the kernel: {field} differ from the twin's")
    rate = {run: kw["n_chains"] * kw["n_iters"] / r["wall"] for run, r in runs.items()}
    print(f"{label}[pmmh]: production preset, {kw['n_chains']} chains x {kw['n_particles']} x "
          f"{kw['n_iters']} rows, same seed: thetas and log-likelihoods == the twin's bit for "
          f"bit; {k['launches']} launches == {_build.PROFILED[key]} {k['counter']} == "
          f"{served} {what} ({k['filters']} filters x {(t_len - 1) // every}, init search "
          f"included); {rate['kernel']:.1f} iters/s against {rate['twin']:.1f} on the twin",
          flush=True)
    return dict(pmmh_launches=k["launches"], pmmh_filter_steps=k["steps"],
                iters_per_s=rate["kernel"], plain_iters_per_s=rate["twin"])


def phase_weight_kernel(model, obs, y):
    """csrc/obs_binomial.cu against its twin on the card, bit for bit: edge
    cases, and the tau-leap's states at both PMMH cells' shapes with both
    combines; its time from idle and back to back beside the twin's and the
    bound; the launches of a production-preset PMMH run; and that run's
    chains equal to the same seed's run on the plain weighting."""
    from epitpu_torch.observe import models

    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    kernels = {m: models.make_binomial_obs(m) for m in ("min", "sum")}
    plains = {m: functools.partial(models.binomial_log_weight_reference, combine=m)
              for m in ("min", "sum")}
    edges = _weight_edges(gen)
    for label, yy, x, p in edges:
        for m in ("min", "sum"):
            got, want = kernels[m](yy, x, p), plains[m](yy, x, p)
            check(_same_bits(got, want), f"weight kernel {label} {m}: differs from the twin "
                  f"at {int((got != want).sum())} of {got.numel()} particles")
        # the plain route's and the exact sampler's final states are strided views
        strided = torch.stack([x, x], dim=2)[:, :, -1]
        check(_same_bits(kernels["min"](yy, strided, p), kernels["min"](yy, x, p)),
              f"weight kernel {label}: a strided x_obs differs from its contiguous copy")
    print(f"weight_kernel: edges == twin bit for bit, min and sum: {len(edges)} cases "
          f"(C = 1, 3, 4, 6, 24, 36, 60; k = 0, k = n, n = 0, k > n, k < 0, NaN; p = 0, 1, "
          f"1e-12, 1 - 1e-9, per chain); a strided x_obs == its contiguous copy", flush=True)
    rows = []
    for chains, n in WEIGHT_CELLS:
        steps = 0
        for yt, x in _weight_states(model, chains, n, y.to(DEV), gen):
            for m in ("min", "sum"):
                check(_same_bits(kernels[m](yt, x, torch.tensor(0.1, device=DEV)),
                                 plains[m](yt, x, torch.tensor(0.1, device=DEV))),
                      f"weight kernel at {chains} x {n}, step {steps}, {m}: differs from the twin")
            steps += 1
        p = torch.tensor(0.1, device=DEV)
        particles, c = chains * n, x.shape[-1]
        label = (f"weight_kernel[{chains} x {n}]: == twin bit for bit at {steps} filter steps "
                 f"of the tau-leap's states, min and sum")
        rows.append(dict(shape=f"{chains} x {n} x {c}", particles=particles, steps_checked=steps,
                         **_time_against_twin(label, lambda: kernels["min"](yt, x, p),
                                              lambda: plains["min"](yt, x, p),
                                              "obs_binomial_kernel", particles * c,
                                              particles * (4 * c + 4))))
    return dict(rows=rows, **_pmmh_against_twin("weight_kernel", model, obs, y, "obs_weight",
                                                "pf_weight", models, "binomial_log_weight",
                                                models.binomial_log_weight_reference))


# ---- the likelihood update (csrc/pf_loglik.cu) --------------------------------

LOGLIK_SIZES = (1, 2, 15, 16, 17, 31, 32, 33, 64, 513, 1000, 4096, 8191, 8192, 8193, 20000,
                32768)
LOGLIK_BYTES = 12  # a particle, carry form: read logw and lw, write lw'


def _loglik_inputs(rows, n, gen):
    """(logw, log_z, lw) on the card: log-weights with some -inf, a running
    log-likelihood, normalized carried log-weights; from 5 rows, rows all
    -inf, with one finite entry, a NaN, a +inf, and an empty carry."""
    logw = torch.randn((rows, n), generator=gen, device=DEV) * 4.0 - 12.0
    logw[torch.rand((rows, n), generator=gen, device=DEV) < 0.05] = -math.inf
    raw = torch.randn((rows, n), generator=gen, device=DEV) * 2.0
    lw = raw - torch.logsumexp(raw, -1, keepdim=True)
    log_z = -100.0 * torch.rand(rows, generator=gen, device=DEV)
    if rows >= 5:
        logw[:2] = -math.inf
        logw[1, n // 2] = -3.25
        logw[2, n - 1] = math.nan
        logw[3, 0] = math.inf
        lw[4] = -math.inf
    return logw, log_z, lw


def _loglik_equal(got, want):
    """(log_z', lw' or None, degen) equal bit for bit."""
    (z, lw, degen), (z0, lw0, degen0) = got, want
    return (_same_bits(z, z0) and torch.equal(degen.cpu(), degen0.cpu())
            and ((lw is None and lw0 is None) or _same_bits(lw, lw0)))


def phase_loglik_kernel(model, obs, y):
    """csrc/pf_loglik.cu against its twin on the card, bit for bit: rows of
    every size class in both forms, a row's independence of the others, and
    both PMMH cells' shapes over the filter steps of K4's states; its time
    beside the twin's and the bound; the launches of a production-preset
    PMMH run, and that run's chains equal to the same seed's run on the
    twin."""
    twin = loglik_cuda.loglik_update_reference
    update = loglik_cuda.loglik_update
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    cases = 0
    for n in LOGLIK_SIZES:
        for rows in (1, 32, 2048):
            if rows * n > 2048 * 4096:
                continue
            logw, log_z, lw = _loglik_inputs(rows, n, gen)
            for carry in (None, lw):
                got = update(logw, log_z, math.log(n), carry)
                want = twin(logw, log_z, math.log(n), carry)
                check(_loglik_equal(got, want), f"loglik kernel {rows} x {n} "
                      f"{'resample' if carry is None else 'carry'}: differs from the twin")
                cases += 1
        rows = 2048 if n <= 4096 else 64
        logw, log_z, lw = _loglik_inputs(rows, n, gen)
        every = update(logw, log_z, math.log(n), lw)
        for size, start in ((1, 0), (1, rows - 1), (7, 3), (7, rows - 7)):
            part = slice(start, start + size)
            got = update(logw[part].contiguous(), log_z[part], math.log(n), lw[part].contiguous())
            check(_loglik_equal(got, [t[part] for t in every]),
                  f"loglik kernel at N = {n}: rows {start}..{start + size} among {rows} differ "
                  f"from the same rows alone")
    print(f"loglik_kernel: == twin bit for bit in {cases} cases, both forms (N = "
          f"{', '.join(map(str, LOGLIK_SIZES))}; 1, 32 and 2,048 rows; rows all -inf, one "
          f"finite entry, NaN, +inf, an empty carry); rows 1 and 7 alone == among all",
          flush=True)
    regs = [part for part in _ptxas_report(_build.BUILD_INFO.get("ptxas", "")).split(", ")
            if part.startswith("loglik_")]
    print(f"loglik_kernel: registers/stack bytes/spill-store bytes: {', '.join(regs)}",
          flush=True)
    rows_out = []
    p = torch.tensor(0.1, device=DEV)
    for chains, n in WEIGHT_CELLS:
        log_n = math.log(n)
        lw = torch.full((chains, n), -log_n, device=DEV)
        log_z = torch.zeros(chains, device=DEV)
        steps = 0
        for yt, x in _weight_states(model, chains, n, y.to(DEV), gen):
            logw = obs(yt, x, p)
            got, want = update(logw, log_z, log_n, lw), twin(logw, log_z, log_n, lw)
            check(_loglik_equal(got, want),
                  f"loglik kernel at {chains} x {n}, step {steps}: differs from the twin")
            log_z, lw, _ = got
            steps += 1
        label = (f"loglik_kernel[{chains} x {n}]: == twin bit for bit at {steps} filter steps "
                 f"of K4's states (carry form)")
        rows_out.append(dict(shape=f"{chains} x {n}", particles=chains * n, steps_checked=steps,
                             **_time_against_twin(label, lambda: update(logw, log_z, log_n, lw),
                                                  lambda: twin(logw, log_z, log_n, lw),
                                                  "loglik_", 0, chains * n * LOGLIK_BYTES)))
    from epitpu_torch.smc import filter as pf

    return dict(rows=rows_out, registers=regs,
                **_pmmh_against_twin("loglik_kernel", model, obs, y, "pf_loglik", "pf_loglik",
                                     pf, "loglik_update", twin))


# ---- the resampling step (csrc/pf_resample.cu) ---------------------------------

RESAMPLE_SIZES = (1, 2, 3, 15, 16, 17, 31, 32, 33, 64, 513, 1000, 4096, 5000, 8191, 8192,
                  8193, 20000, 65536)
RESAMPLE_SLICES = ((4096, 0, 1024), (4096, 3072, 1024))  # a four-card shard's particles
RESAMPLE_EVERY = 4  # the PMMH cells' resample_every


def _resample_bytes(c):
    """A particle's bytes in the carry form: read lw and x, write anc (int64),
    x_res and lw'."""
    return 4 + 4 * c + 8 + 4 * c + 4


def _resample_inputs(rows, n, gen, c=3):
    """(lw, u, x, skip) on the card: log-weights with some -inf, uniforms, a
    cloud of counts, a third of the rows marked to skip; from 5 rows, rows
    all -inf, with a NaN, with a +inf."""
    lw = torch.randn((rows, n), generator=gen, device=DEV) * 4.0 - 12.0
    lw[torch.rand((rows, n), generator=gen, device=DEV) < 0.05] = -math.inf
    u = torch.rand((rows, 1), generator=gen, device=DEV)
    x = torch.floor(torch.rand((rows, n, c), generator=gen, device=DEV) * 5000.0)
    skip = torch.rand(rows, generator=gen, device=DEV) < 0.33
    if rows >= 5:
        lw[0] = -math.inf
        lw[1, n // 2] = math.nan
        lw[2, 0] = math.inf
    return lw, u, x, skip


def _resample_equal(got, want):
    """(anc, x_res, lw' or None) equal bit for bit."""
    (anc, x_res, lw), (anc0, x_res0, lw0) = got, want
    return (torch.equal(anc.cpu(), anc0.cpu()) and _same_bits(x_res, x_res0)
            and ((lw is None and lw0 is None) or _same_bits(lw, lw0)))


def phase_resample_kernel(model, obs, y):
    """csrc/pf_resample.cu against its twin on the card, bit for bit: rows of
    every size class in both forms, a four-card shard's slices, a row's
    independence of the others, and both PMMH cells' shapes over the
    resampling steps of K4's states; its time beside the twin's and the
    bound; the launches of a production-preset PMMH run, and that run's
    chains equal to the same seed's run on the twin."""
    twin = resample_cuda.systematic_step_reference
    step = resample_cuda.systematic_step
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    cases = 0
    for n in RESAMPLE_SIZES:
        for rows in (1, 32, 2048):
            if rows * n > 2048 * 4096:
                continue
            lw, u, x, skip = _resample_inputs(rows, n, gen)
            for form in (None, skip):
                check(_resample_equal(step(lw, u, x, form), twin(lw, u, x, form)),
                      f"resample kernel {rows} x {n} {'resample' if form is None else 'carry'}: "
                      f"differs from the twin")
                cases += 1
        rows = 2048 if n <= 4096 else 32
        lw, u, x, skip = _resample_inputs(rows, n, gen)
        every = step(lw, u, x, skip)
        for size, start in ((1, 0), (1, rows - 1), (7, 3), (7, rows - 7)):
            part = slice(start, start + size)
            check(_resample_equal(step(lw[part], u[part], x[part], skip[part]),
                                  [t[part] for t in every]),
                  f"resample kernel at N = {n}: rows {start}..{start + size} among {rows} "
                  f"differ from the same rows alone")
    for n, p0, n_local in RESAMPLE_SLICES:
        lw, u, x, skip = _resample_inputs(32, n, gen)
        for form in (None, skip):
            got = step(lw, u, x, form, p0, n_local)
            every = step(lw, u, x, form)
            mine = slice(p0, p0 + n_local)
            check(_resample_equal(got, twin(lw, u, x, form, p0, n_local))
                  and _resample_equal(got, (every[0][:, mine], every[1][:, mine], every[2])),
                  f"resample kernel, particles {p0}.. of 32 x {n}: differ from the twin or "
                  f"from the unsharded slice")
            cases += 1
    print(f"resample_kernel: == twin bit for bit in {cases} cases, both forms (N = "
          f"{', '.join(map(str, RESAMPLE_SIZES))}; 1, 32 and 2,048 rows; rows all -inf, NaN, "
          f"+inf, skipped; particles 0.. and 3,072.. (1,024) of 32 x 4,096 == the unsharded "
          f"slice); rows 1 and 7 alone == among all", flush=True)
    regs = [part for part in _ptxas_report(_build.BUILD_INFO.get("ptxas", "")).split(", ")
            if part.startswith("resample_")]
    print(f"resample_kernel: registers/stack bytes/spill-store bytes: {', '.join(regs)}",
          flush=True)
    rows_out = []
    p = torch.tensor(0.1, device=DEV)
    for chains, n in WEIGHT_CELLS:
        log_n = math.log(n)
        lw = torch.full((chains, n), -log_n, device=DEV)
        log_z = torch.zeros(chains, device=DEV)
        steps = 0
        for t, (yt, x) in enumerate(_weight_states(model, chains, n, y.to(DEV), gen)):
            log_z, lw, degen = loglik_cuda.loglik_update(obs(yt, x, p), log_z, log_n, lw)
            if (t + 1) % RESAMPLE_EVERY:
                continue
            lw_new, u = lw, torch.rand((chains, 1), generator=gen, device=DEV)
            got = step(lw_new, u, x, degen)
            check(_resample_equal(got, twin(lw_new, u, x, degen)),
                  f"resample kernel at {chains} x {n}, step {t}: differs from the twin")
            lw = got[2]
            steps += 1
        c = x.shape[-1]
        label = (f"resample_kernel[{chains} x {n}]: == twin bit for bit at {steps} resampling "
                 f"steps of K4's states (carry form)")
        rows_out.append(dict(shape=f"{chains} x {n} x {c}", particles=chains * n,
                             steps_checked=steps,
                             **_time_against_twin(label, lambda: step(lw_new, u, x, degen),
                                                  lambda: twin(lw_new, u, x, degen),
                                                  "resample_", 0,
                                                  chains * n * _resample_bytes(c))))
    from epitpu_torch.smc import filter as pf

    return dict(rows=rows_out, registers=regs,
                **_pmmh_against_twin("resample_kernel", model, obs, y, "pf_resample",
                                     "pf_resample", pf, "systematic_step", twin,
                                     resampling=True))


# ---- the benchmark's SEIR cell (seir_binomial.chains2048) ------------------------

SEIR_CELL = (2048, 32)  # chains x particles
SEIR_TRUTH = (4.0, 1.0, 1.0)  # the seir_underreported preset's theta


def phase_seir_cell():
    """The hand kernels at the benchmark's SEIR cell's shapes (2,048 chains x
    32 particles, C = 4, R = 3): the weighting, the likelihood update and the
    resampling step against their twins bit for bit at every filter step of
    K4's SEIR states (the carry form, a resampling every 4th step), each
    timed at the last; K4's Seir functor at the cell's 65,536 lanes x 20
    substeps, final state, against its twin and timed, with its launch's K4
    counters.  Returns the four timed rows."""
    from epitpu_torch import profiling
    from epitpu_torch.observe import models

    model = seir_model()
    chains, n = SEIR_CELL
    y, _ = generate_dataset(PRESETS["seir_underreported"]())
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    p = torch.tensor(0.1, device=DEV)
    weigh = models.make_binomial_obs("min")
    weigh_twin = functools.partial(models.binomial_log_weight_reference, combine="min")
    update, update_twin = loglik_cuda.loglik_update, loglik_cuda.loglik_update_reference
    step, step_twin = resample_cuda.systematic_step, resample_cuda.systematic_step_reference
    log_n = math.log(n)
    lw = torch.full((chains, n), -log_n, device=DEV)
    log_z = torch.zeros(chains, device=DEV)
    steps = resamplings = 0
    for t, (yt, x) in enumerate(_weight_states(model, chains, n, y, gen, SEIR_TRUTH)):
        logw = weigh(yt, x, p)
        check(_same_bits(logw, weigh_twin(yt, x, p)),
              f"seir cell: the weighting at step {t} differs from its twin")
        got = update(logw, log_z, log_n, lw)
        check(_loglik_equal(got, update_twin(logw, log_z, log_n, lw)),
              f"seir cell: the likelihood update at step {t} differs from its twin")
        log_z_prev, lw_prev = log_z, lw
        log_z, lw, degen = got
        steps += 1
        if (t + 1) % RESAMPLE_EVERY:
            continue
        lw_new, u = lw, torch.rand((chains, 1), generator=gen, device=DEV)
        got = step(lw_new, u, x, degen)
        check(_resample_equal(got, step_twin(lw_new, u, x, degen)),
              f"seir cell: the resampling step at step {t} differs from its twin")
        lw = got[2]
        resamplings += 1
    particles, c = chains * n, x.shape[-1]
    shape = f"{chains} x {n} x {c}"
    rows = {}
    rows["weight"] = dict(shape=shape, particles=particles, steps_checked=steps, **_time_against_twin(
        f"seir_cell[weight {shape}]: == twin bit for bit at {steps} filter steps of K4's SEIR "
        f"states", lambda: weigh(yt, x, p), lambda: weigh_twin(yt, x, p),
        "obs_binomial_kernel", particles * c, particles * (4 * c + 4)))
    rows["loglik"] = dict(shape=f"{chains} x {n}", particles=particles, steps_checked=steps,
                          **_time_against_twin(
        f"seir_cell[loglik {chains} x {n}]: == twin bit for bit at {steps} filter steps (carry "
        f"form)", lambda: update(logw, log_z_prev, log_n, lw_prev),
        lambda: update_twin(logw, log_z_prev, log_n, lw_prev), "loglik_", 0,
        particles * LOGLIK_BYTES))
    rows["resample"] = dict(shape=shape, particles=particles, steps_checked=resamplings,
                            **_time_against_twin(
        f"seir_cell[resample {shape}]: == twin bit for bit at {resamplings} resampling steps "
        f"(carry form)", lambda: step(lw_new, u, x, degen),
        lambda: step_twin(lw_new, u, x, degen), "resample_", 0, particles * _resample_bytes(c)))
    # K4 on the last states, a theta row a chain, as the filter launches it
    sim, twin = tauleap_cuda.simulate_lanes, tauleap_cuda.simulate_lanes_reference
    x0 = x.reshape(particles, c).contiguous()
    theta = torch.tensor(SEIR_TRUTH, device=DEV).expand(chains, 3).contiguous()
    seed, off = SEED + 22, 7
    k1, p1 = (f(model, x0, theta, seed, off, 1, 1, True, n) for f in (sim, twin))
    same_1sub = float((k1 == p1).all(-1).float().mean())
    work = {}
    k, pl = sim(model, x0, theta, seed, off, 1, 20, True, n), twin(model, x0, theta, seed, off,
                                                                  1, 20, True, n, work=work)
    same = float((k == pl).all(-1).float().mean())
    check(same_1sub >= 0.999 and bool((k.sum(-1) == x0.sum(-1)).all()),
          f"seir cell: K4's Seir matches its twin in {same_1sub:.5f} of lanes after one substep, "
          f"or does not conserve the population")
    with profiling.recording() as rec:
        sim(model, x0, theta, seed, off, 1, 20, True, n)
    counts = {name: rec.counters.get(name) for name in
              ("k4.launches", "k4.thread_slots", "k4.reaction_slots")}
    # 10 lanes of 3 threads a warp: the slots of the warps that hold lanes
    check(counts == {"k4.launches": 1, "k4.thread_slots": -(-particles // 10) * 32,
                     "k4.reaction_slots": 3 * particles},
          f"seir cell: one Seir launch counted {counts}")
    bound_ms, by, ops, nbytes = bound(model, particles, 1, chains, True, work)
    rows["k4"] = dict(shape=f"{particles} x 20, final", lanes=particles, same_1sub=same_1sub,
                      same_full=same, counters=counts, **_time_against_twin(
        f"seir_cell[k4 Seir {particles} x 20, final]: {same_1sub:.6f} of lanes == twin after 1 "
        f"substep, {same:.6f} after 20; counters {counts}",
        lambda: sim(model, x0, theta, seed, off, 1, 20, True, n),
        lambda: twin(model, x0, theta, seed, off, 1, 20, True, n), "traj_kernel", 0, nbytes,
        ops=ops))
    return rows


def _sm_clock():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _per_theta(b):
    """Lanes per theta row for the final-state mode: the largest divisor of
    ``b`` up to 16 (production's 16 particles a chain)."""
    return max(d for d in range(1, 17) if b % d == 0)


def _kernel_case(model, tag, b, t_max, gen, timed=True, label=None, n_sub=20, inputs=None,
                 lpt=None, lean=False):
    """The kernel against its twin in both modes: the full trajectory with a
    theta row per lane (ABC, the forecast, the app), and the final state with
    one theta row per ``lpt`` lanes (the filter; default ``_per_theta(b)``),
    ``t_max`` units of ``n_sub`` substeps.  A timed case (a tag starting with
    "filter" for the filter's) is timed in the mode its path uses: the
    filter's final state, else the full trajectory.  ``inputs`` (x0, theta,
    groups) replace ``_lane_inputs``; ``lean`` (a theta row a lane in both
    modes) runs the twin once less (its final state is its full run's last
    row) and times it once."""
    x0, th, groups = _lane_inputs(model, b, gen) if inputs is None else inputs
    lpt = 1 if lean else _per_theta(b) if lpt is None else lpt
    th_chain = th[::lpt].contiguous()
    c_dim = model.num_compartments
    seed, off = SEED + b + c_dim, 7
    sim, twin = tauleap_cuda.simulate_lanes, tauleap_cuda.simulate_lanes_reference
    # one substep: the kernel and the twin must draw the same counts
    k1, p1 = sim(model, x0, th, seed, off, 1, 1), twin(model, x0, th, seed, off, 1, 1)
    kf1 = sim(model, x0, th_chain, seed, off, 1, 1, True, lpt)
    pf1 = twin(model, x0, th_chain, seed, off, 1, 1, True, lpt)
    torch.cuda.synchronize()
    same = float((k1 == p1).all(-1).all(-1).float().mean())
    same_final = float((kf1 == pf1).all(-1).float().mean())
    err1 = max(float((k1 - p1).abs().max()), float((kf1 - pf1).abs().max()))
    # lanes whose largest difference is exactly one event: a rounding of the
    # normal regime (the card's and the host's logf/sqrtf), not a wrong law
    off_by_one = int(((k1 - p1).abs().amax((-1, -2)) == 1).sum())
    spec = model.kernel
    if label is None:
        label = (f"sir_subgroups k={spec.k} {'transposed' if spec.transpose else 'textbook'}"
                 if spec.family == "sir_subgroups" else model.name)
    check(same >= 0.999 and same_final >= 0.999,
          f"{label} {tag}: only {same:.5f} (full) / {same_final:.5f} (final) of lanes match "
          "the twin after one substep")
    final_mode = timed and tag.startswith("filter")
    work = {}
    k = sim(model, x0, th, seed, off, t_max, n_sub)
    p = twin(model, x0, th, seed, off, t_max, n_sub,
             work=None if final_mode or not timed else work)
    kf = sim(model, x0, th_chain, seed, off, t_max, n_sub, True, lpt)
    kx = sim(model, x0, th_chain.repeat_interleave(lpt, 0), seed, off, t_max, n_sub)
    pf = (p[:, -1] if lean else
          twin(model, x0, th_chain, seed, off, t_max, n_sub, True, lpt,
               work=work if final_mode else None))
    torch.cuda.synchronize()
    check(kf.shape == (b, c_dim) and torch.equal(kf, kx[:, -1]),
          f"{label} {tag}: the final state with {lpt} lanes per theta row differs from the "
          "full trajectory's last row")
    pop0 = x0.reshape(b, groups, -1).sum(-1)
    for name, out in (("kernel", k), ("plain", p)):
        check(out.shape == (b, t_max + 1, c_dim), f"{label} {tag} {name} shape {tuple(out.shape)}")
        check(bool((out == torch.round(out)).all()), f"{label} {tag} {name} not integer-valued")
        check(bool((out.reshape(b, t_max + 1, groups, -1).sum(-1) == pop0[:, None]).all()),
              f"{label} {tag} {name} does not conserve each group's population")
        check(bool((out[:, 0] == x0).all()), f"{label} {tag} {name} row 0 differs from x0")
        check(bool((out >= 0).all()), f"{label} {tag} {name} has negative counts")
        check(float(out.max()) < 2**24, f"{label} {tag} {name}: a count at or past 2^24, "
              "where float32 stops holding every integer")
    if b >= FILTER_LANES:
        km, pm = k[:, -1].mean(0), p[:, -1].mean(0)
        ks, ps = k[:, -1].std(0), p[:, -1].std(0)
        check(bool(((km - pm).abs() <= 3.0 + 0.06 * pm.abs()).all()),
              f"{label} {tag} means {km.tolist()} vs {pm.tolist()}")
        check(bool(((ks - ps).abs() <= 3.0 + 0.3 * ps.abs()).all()),
              f"{label} {tag} sds {ks.tolist()} vs {ps.tolist()}")
    full_same = float((k == p).all(-1).all(-1).float().mean())
    final_same = float((kf == pf).all(-1).float().mean())
    row = dict(model=label, k=groups, transpose=None if spec is None else spec.transpose,
               against="twin", shape=tag, lanes=b, t_max=t_max, n_sub=n_sub,
               lanes_per_theta=lpt, same_1sub=same, same_1sub_final=same_final,
               max_abs_err=err1, off_by_one_1sub=off_by_one, same_full=full_same,
               same_full_final=final_same, mode=None,
               ms=None, b2b_ms=None, plain_ms=None, bound_ms=None, bound_by=None,
               bound_share=None, library_ms=None)
    times = "not timed"
    if timed:
        if final_mode:
            args, kw, rows = (model, x0, th_chain, seed, off, t_max, n_sub), (True, lpt), b // lpt
        else:
            args, kw, rows = (model, x0, th, seed, off, t_max, n_sub), (), b
        b2b_ms = cuda_ms(lambda: [sim(*args, *kw) for _ in range(BACK_TO_BACK)]) / BACK_TO_BACK
        ms = cuda_ms(lambda: sim(*args, *kw))
        plain_ms = cuda_ms(lambda: twin(*args, *kw),
                           reps=1 if lean else 3 if t_max == 1 else 2, warmup=False)
        bound_ms, by, ops, nbytes = bound(model, b, t_max, rows, final_mode, work, n_sub)
        substeps = t_max * n_sub
        # us and ns per (lane-)substep from b2b_ms: the chain's pace, without host time
        row.update(mode="final" if final_mode else "full", ms=ms, b2b_ms=b2b_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, bound_share=bound_ms / ms,
                   b2b_bound_share=bound_ms / b2b_ms, ops=ops, bytes=nbytes,
                   draws=work["draws"], small_draws=work["small"], cdf_terms=work["terms"],
                   us_per_substep=1e3 * b2b_ms / substeps,
                   ns_per_lane_substep=1e6 * b2b_ms / (b * substeps), sm_clock=_sm_clock())
        was = ONE_THREAD_MS.get((label, tag))
        was = f"{was:.4f} ms, a constant from PERF.md" if was is not None else "none"
        times = (f"{row['mode']} mode: kernel {ms:.4f} ms one call (one thread a lane: {was}), "
                 f"{b2b_ms:.4f} ms a launch of {BACK_TO_BACK} back to back, plain "
                 f"{plain_ms:.4f} ms (CUDA events, median); bound {bound_ms:.5f} ms by {by} "
                 f"({ops / 1e6:.1f} M ops over {work['draws']} draws, {work['small']} small "
                 f"with {work['terms']} CDF terms; {nbytes} bytes) = "
                 f"{100 * row['bound_share']:.2f} % of bound in one call, "
                 f"{100 * row['b2b_bound_share']:.2f} % back to back; "
                 f"{row['us_per_substep']:.3f} us per substep, "
                 f"{row['ns_per_lane_substep']:.4f} ns per lane-substep; SM clock "
                 f"{row['sm_clock']}")
    print(f"kernel[{label} {tag}]: B={b} t_max={t_max} n_sub={n_sub}: lanes identical to "
          f"twin {same:.6f} full / {same_final:.6f} final ({lpt} lanes per theta) after 1 "
          f"substep (max |diff| {err1:g}, {off_by_one} lanes off by exactly 1), {full_same:.6f} "
          f"/ {final_same:.6f} after {t_max * n_sub}; final == full's last row; integer below "
          f"2^24, conserving per group, row0=x0, non-negative; {times}", flush=True)
    return row


def phase_kernel():
    """Timed at the filter and ABC shapes (and SIR's forecast shape); held
    to the twin, untimed, at the lane counts the main paths launch that
    leave a partial last block (PMMH presets, their init searches, the
    forecast phase's chains) or outgrow the timed shapes (production's init
    search, ABC at batch 65,536), at ragged counts (1, 31, 33, 513 lanes)
    for SIR, SEIR and K = 3, 5, 8, and every other subgroup instantiation
    at a partial-block count."""
    gen = torch.Generator().manual_seed(SEED)
    filt, abc = ("filter", FILTER_LANES, 1, True), ("abc", ABC_LANES, 14, True)
    ragged = [("ragged", n, 3, False) for n in RAGGED_LANES]
    cases = [
        (sir_model(), [filt, ("forecast", 200, 5, True), abc, ("pmmh-forecast", 200, 1, False),
                       ("pmmh-init", PROD_INIT_LANES, 1, False),
                       (f"abc-{ABC_BIG_BATCH}", ABC_BIG_BATCH, 14, False),
                       ("cli-pmmh", 300, 1, False), ("cli-init", 4800, 1, False),
                       ("cli-sweep", 100, 1, False), ("cli-sweep-init", 1600, 1, False),
                       ("cli-forecast", CLI_EXTRAS_ITERS - max(1, CLI_EXTRAS_ITERS // 5), 5,
                        False),
                       ("cli-surface", CLI_SURFACE_POINTS ** 2 * 100, 1, False),
                       ("app", APP_TRAJ, APP_ARGS[4], False)] + ragged),
        (seir_model(), [filt, abc, ("pmmh", 300, 1, False), ("pmmh-init", 4800, 1, False)]
         + ragged),
        (sir_subgroups_model(2), [filt, abc, ("pmmh", 200, 1, False),
                                  ("pmmh-init", 3200, 1, False)]),
        (sir_subgroups_model(2, reference_dynamics=False), [filt, abc]),
        (sir_subgroups_model(8), [filt, abc] + ragged),
        (sir_subgroups_model(3), ragged),
        (sir_subgroups_model(5), ragged),
    ]
    cases += [(sir_subgroups_model(kk, reference_dynamics=t), [("coverage", 300, 1, False)])
              for kk in range(1, tauleap_cuda.MAX_GROUPS + 1) for t in (True, False)
              if (kk, t) not in ((2, True), (2, False), (8, True))]
    rows = {f: [] for f in tauleap_cuda.FAMILIES}
    for model, shapes in cases:
        for tag, b, t_max, timed in shapes:
            rows[model.kernel.family].append(_kernel_case(model, tag, b, t_max, gen, timed))
    return rows


def _generated_vs_hand(label, gmodel, hmodel, gen):
    """The generated functor of a built-in model against its hand-written
    one, bit for bit in both modes (full trajectory, a theta row a lane;
    final state, a theta row per 16 lanes) at the filter and ABC shapes,
    each timed in its path's mode back to back beside the hand kernel."""
    sim, twin = tauleap_cuda.simulate_lanes, tauleap_cuda.simulate_lanes_reference
    rows = []
    for tag, b, t_max in (("filter", FILTER_LANES, 1), ("abc", ABC_LANES, 14)):
        x0, th, groups = _lane_inputs(hmodel, b, gen)
        lpt = _per_theta(b)
        th_chain = th[::lpt].contiguous()
        seed, off = SEED + 100 + b, 3
        full = (x0, th, seed, off, t_max, 20)
        final = (x0, th_chain, seed, off, t_max, 20, True, lpt)
        one_sub = [(x0, th, seed, off, 1, 1), (x0, th_chain, seed, off, 1, 1, True, lpt)]
        pairs = [(sim(gmodel, *a), sim(hmodel, *a)) for a in one_sub + [full, final]]
        torch.cuda.synchronize()
        # fraction of lanes equal in every entry: 1-substep full, final; t_max full, final
        same = [float((g == h).reshape(b, -1).all(-1).float().mean()) for g, h in pairs]
        err1 = max(float((g - h).abs().max()) for g, h in pairs[:2])
        check(min(same) == 1.0 and err1 == 0.0,
              f"kernel[{label} generated {tag}]: the generated functor differs from the "
              f"hand-written one (lanes equal after 1 substep full, final; after {t_max * 20} "
              f"full, final: {same}; max |diff| after 1 substep {err1:g})")
        final_mode = tag == "filter"
        args = final if final_mode else full
        # back to back in turns, hand, generated, generated, hand: the mean of each pair
        b2b = {hmodel: [], gmodel: []}
        for m in (hmodel, gmodel, gmodel, hmodel):
            b2b[m].append(cuda_ms(lambda: [sim(m, *args) for _ in range(BACK_TO_BACK)])
                          / BACK_TO_BACK)
        hand_b2b, b2b_ms = float(np.mean(b2b[hmodel])), float(np.mean(b2b[gmodel]))
        ms = cuda_ms(lambda: sim(gmodel, *args))
        work = {}  # one twin run, counted and timed
        plain_ms = cuda_ms(lambda: twin(gmodel, *args, work=work), reps=1, warmup=False)
        bound_ms, by, ops, nbytes = bound(gmodel, b, t_max, b // lpt if final_mode else b,
                                          final_mode, work)
        substeps = t_max * 20
        rows.append(dict(
            model=f"{label} generated", k=groups, transpose=None, against="hand", shape=tag,
            lanes=b, t_max=t_max, lanes_per_theta=lpt, same_1sub=same[0],
            same_1sub_final=same[1], same_full=same[2], same_full_final=same[3],
            max_abs_err=err1,
            mode="final" if final_mode else "full", ms=ms, b2b_ms=b2b_ms, hand_b2b_ms=hand_b2b,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, bound_share=bound_ms / ms,
            b2b_bound_share=bound_ms / b2b_ms, library_ms=None, ops=ops, bytes=nbytes,
            draws=work["draws"], small_draws=work["small"], cdf_terms=work["terms"],
            us_per_substep=1e3 * b2b_ms / substeps,
            ns_per_lane_substep=1e6 * b2b_ms / (b * substeps), sm_clock=_sm_clock()))
        print(f"kernel[generated {label} {tag}]: B={b} t_max={t_max} n_sub=20: generated == hand "
              f"bit for bit in both modes (lanes equal {same[0]:.6f} full / {same[1]:.6f} final "
              f"after 1 substep, max |diff| {err1:g}; {same[2]:.6f} / {same[3]:.6f} after "
              f"{t_max * 20}); {rows[-1]['mode']} mode: generated {ms:.4f} ms one "
              f"call, {b2b_ms:.4f} ms a launch of {BACK_TO_BACK} back to back against the hand "
              f"functor's {hand_b2b:.4f} ms ({b2b_ms / hand_b2b:.2f}x; timed in turns), plain "
              f"{plain_ms:.4f} ms; "
              f"bound {bound_ms:.5f} ms by {by} ({ops / 1e6:.1f} M ops; {nbytes} bytes) = "
              f"{100 * bound_ms / b2b_ms:.2f} % back to back; "
              f"{rows[-1]['us_per_substep']:.3f} us per substep; SM clock "
              f"{rows[-1]['sm_clock']}", flush=True)
    return rows


def phase_generated():
    """The generated route: SIR, SEIR, K = 2 and K = 8 traced from their
    rate_fn against their hand functors bit for bit; K = 12, K = 20 (40
    reactions, past a warp) and SIRS against their twin after one substep in
    both modes (>= 0.999 of lanes), timed at the filter and ABC shapes, and
    at ragged lane counts."""
    gen = torch.Generator().manual_seed(SEED + 4)
    models = generated_models()
    rows = []
    for label, hand in GENERATED_VS_HAND.items():
        rows += _generated_vs_hand(label, models[label], hand(), gen)
    shapes = [("filter", FILTER_LANES, 1, True), ("abc", ABC_LANES, 14, True)]
    shapes += [("ragged", n, 3, False) for n in RAGGED_LANES]
    for label in ("k=12", "k=20", "sirs"):
        for tag, b, t_max, timed in shapes:
            rows.append(_kernel_case(models[label], tag, b, t_max, gen, timed,
                                     label=f"{label} generated"))
    return rows


def phase_advance_span():
    """``advance`` over ADVANCE_SPAN units (60 substeps of 0.05) on the card
    against the twin at the filter shape."""
    model = sir_model()
    gen = torch.Generator().manual_seed(SEED + 5)
    x0, th, _ = _lane_inputs(model, FILTER_LANES, gen)
    th = th[::16].contiguous()
    card = advance(model, x0.reshape(-1, 16, 3), th[:, None, :], PhiloxStream(SEED + 95, DEV),
                   t_span=ADVANCE_SPAN)
    n_sub = int(round(ADVANCE_SPAN * 20))
    twin = tauleap_cuda.simulate_lanes_reference(model, x0, th, SEED + 95, 0, 1, n_sub, True, 16,
                                                 dt=ADVANCE_SPAN / n_sub)
    same = float((card.reshape(-1, 3) == twin).all(-1).float().mean())
    check(same >= 0.999, f"advance[t_span]: only {same:.5f} of lanes match the twin")
    check(bool((card.sum(-1) == POP).all()), "advance[t_span] does not conserve")
    print(f"advance[t_span={ADVANCE_SPAN}]: SIR {FILTER_LANES} lanes, {n_sub} substeps of "
          f"{ADVANCE_SPAN / n_sub:g}, one launch: {same:.6f} of lanes identical to the twin",
          flush=True)


# ---- phase 4: the filter on the card against the host ----------------------

def _filter_logz(name, model, obs, y, theta, pop, mu, levels=(0.1,)):
    """Filter logZ at ``theta``, FILTER_REPS replicates per observation
    parameter in ``levels``, all levels in one batch with a per-chain
    ``obs_param`` when there are several; card against host within 4 se at
    every level.  Returns the card's mean logZ and the se per level."""
    reps = FILTER_REPS * len(levels)
    th = torch.as_tensor(theta, dtype=torch.float32)
    per_chain = torch.tensor(levels, dtype=torch.float32).repeat_interleave(FILTER_REPS)
    lls = {}
    for d in ("cpu", DEV.type):
        g = torch.Generator(device=d).manual_seed(SEED)
        lls[d] = particle_filter(
            model, obs, y.to(d), th.to(d).expand(reps, th.numel()),
            levels[0] if len(levels) == 1 else per_chain.to(d),
            PhiloxStream(SEED + 1, d), g, n_particles=16, resample_every=4,
            n_population=pop, mu=mu, record_history=False,
        ).log_likelihood.double().cpu().reshape(len(levels), FILTER_REPS)
    card, ses, parts = [], [], []
    for j, level in enumerate(levels):
        fin = {}
        for d, v in lls.items():
            fin[d] = v[j][torch.isfinite(v[j])]
            check(fin[d].numel() >= FILTER_MIN_FINITE,
                  f"{name} filter at {level} on {d}: {fin[d].numel()} of {FILTER_REPS} finite, "
                  f"need {FILTER_MIN_FINITE}")
        se = math.sqrt(sum(float(v.var()) / v.numel() for v in fin.values()))
        gap = float(fin[DEV.type].mean() - fin["cpu"].mean())
        check(abs(gap) <= 4 * se,
              f"{name} filter logZ at {level} on card vs host differ by {gap:.3f} "
              f"(4 se = {4 * se:.3f})")
        card.append(float(fin[DEV.type].mean()))
        ses.append(se)
        parts.append(f"{'' if len(levels) == 1 else f'{level}: '}card {card[-1]:.4f} host "
                     f"{float(fin['cpu'].mean()):.4f} (diff {gap:.4f}, 4 se {4 * se:.4f})")
    label = "" if len(levels) == 1 else f", obs_param per chain in {list(levels)}"
    print(f"filter[{name}]: logZ at truth, N=16, {FILTER_REPS} reps{label}: "
          f"{'; '.join(parts)}", flush=True)
    return card, ses


def _check_group_cloud(model, pop, mu):
    """torch.poisson with a [chains, N, K] rate on a device generator: the
    initial cloud has I_g ~ Poisson(mu_g) and S_g = N_g - I_g per group."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 2)
    x = model.init_fn(g, (FILTER_REPS, 16), pop, mu).reshape(-1, model.kernel.k, 3).cpu()
    n = x.shape[0]
    mean = x[:, :, 1].double().mean(0).numpy()
    check(bool(np.all(np.abs(mean - mu) <= 4 * np.sqrt(np.asarray(mu) / n))),
          f"initial cloud means {mean.tolist()} vs mu {np.asarray(mu).tolist()}")
    check(bool((x[:, :, 0] + x[:, :, 1] == torch.as_tensor(pop)).all()
               and (x[:, :, 2] == 0).all()), "initial cloud populations")
    print(f"filter: {model.name} initial cloud on the card, {n} particles: per-group "
          f"I mean {np.round(mean, 3).tolist()} (mu {np.asarray(mu).tolist()})", flush=True)


def phase_filter(obs, y):
    """Every observation model the main paths weight with: binomial at a
    fixed p (four models), Gaussian (`sir_noisy`) and binomial with a p per
    chain (`sir_infer_p`), each at three levels of its parameter in one
    batch."""
    _filter_logz("sir", sir_model(), obs, y, TRUTH, POP, 20.0)
    for name in MODEL_PRESETS + CLI_MODEL_PRESETS:
        cfg = PRESETS[name]()
        y_m, _ = generate_dataset(cfg)
        pop, mu = population_and_mu(cfg)
        if name == "sir_subgroups":
            _check_group_cloud(build_model(cfg), pop, mu)
        if name not in CLI_MODEL_PRESETS:
            _filter_logz(name, build_model(cfg), obs, torch.from_numpy(y_m),
                         cfg.data.theta_true, pop, mu)
            continue
        truth = cfg.data.obs_param
        levels = (truth / 2, truth, truth * 2)
        card, ses = _filter_logz(name, build_model(cfg),
                                 get_observation_model(cfg.data.observation),
                                 torch.from_numpy(y_m), cfg.data.theta_true, pop, mu, levels)
        # the per-chain parameter reaches the weighting: the levels' logZ
        # differ, and for the reporting probability the truth ranks first
        check(abs(card[0] - card[2]) > 4 * (ses[0] + ses[2]),
              f"{name}: logZ at {levels[0]} and {levels[2]} agree ({card}): "
              "the per-chain parameter is ignored")
        if cfg.mcmc.infer_obs_param:
            check(card[1] > max(card[0], card[2]),
                  f"{name}: logZ at the true p {truth} is not the highest of {card}")


# ---- phases 5-9: the main paths ---------------------------------------------

def phase_pmmh(model, obs, y):
    cfg = PRESETS["production"]()
    cfg.seed = SEED
    cfg.mcmc.n_iters = PROD_ITERS
    check(build_model(cfg).kernel == model.kernel, "production preset is not SIR")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kw, sd = pmmh_arguments(cfg, model, obs, y, DEV)
    t_tune = time.perf_counter() - t0
    n_iters, n_chains, n_part = kw["n_iters"], kw["n_chains"], kw["n_particles"]
    launches0 = tauleap_cuda.launches()
    t0 = time.perf_counter()
    res = particle_mcmc_chains(model, obs, y.to(DEV), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = tauleap_cuda.launches() - launches0
    t_len = y.shape[0]
    check(launched >= (n_iters - 1) * (t_len - 1),
          f"pmmh launched the kernel {launched} times, expected >= {(n_iters - 1) * (t_len - 1)}")
    thetas = res.thetas.cpu().numpy()
    lls_c = res.log_likelihoods.cpu().numpy()
    check(thetas.shape == (n_chains, n_iters, 2), f"thetas shape {thetas.shape}")
    check(bool(np.isfinite(thetas).all() and np.isfinite(lls_c).all()),
          "non-finite theta or log-likelihood rows")
    acc = float(res.acceptance_rate().mean())
    check(0.05 < acc < 0.8, f"pooled acceptance {acc}")
    burn = n_iters // 5
    post = thetas[:, burn:].reshape(-1, 2).mean(0)
    for v, truth in zip(post, TRUTH):
        check(abs(v - truth) <= 0.25 * truth, f"posterior mean {post} misses {TRUTH}")
    rhat = float(np.max(gelman_rubin_rank(thetas[:, burn:])))
    ess = float(np.min(ess_rank(thetas[:, burn:])))
    print(f"pmmh: production preset, N={n_part} (tuned sd(logZ)={sd:.3f} in {t_tune:.2f} s), "
          f"{n_chains} chains x {n_iters} iters (reduced from {PRESETS['production']().mcmc.n_iters} "
          f"for the smoke) in "
          f"{wall:.2f} s = {n_chains * n_iters / wall:.1f} PMMH iters/s; acceptance {acc:.4f}; "
          f"posterior mean beta {post[0]:.4f} gamma {post[1]:.4f}; max rank-Rhat {rhat:.4f}; "
          f"min rank-ESS {ess:.1f}; kernel launches {launched}", flush=True)
    return thetas, n_chains * n_iters / wall


def phase_forecast(model, obs, y):
    dev = DEV
    state = pmmh_state_from_numpy(np.load(os.path.join(DATA, "checkpoint.npz")), dev)
    check(int(state.step[0]) == 59, f"checkpoint step {int(state.step[0])}, expected 59")
    cfg = PRESETS["sir_underreported"]()
    cfg.seed = SEED + 7
    cfg.mcmc.n_iters = 160
    kw, _ = pmmh_arguments(cfg, model, obs, y, dev)
    res = particle_mcmc_chains(model, obs, y.to(dev), init_state=state, segment_len=100, **kw)
    check(tuple(res.sampled_trajs.shape) == (2, 100, y.shape[0], 3),
          f"trajectories {tuple(res.sampled_trajs.shape)}")
    check(res.final_state.step.tolist() == [159, 159], f"final step {res.final_state.step.tolist()}")
    check(bool(torch.isfinite(res.log_likelihoods).all()), "continued chains not finite")
    before = tauleap_cuda.launches()
    fc = forecast_from_result(model, PhiloxStream(SEED + 8, dev), res, 5)
    torch.cuda.synchronize()
    check(tauleap_cuda.launches() > before, "forecast did not launch the kernel")
    check(tuple(fc.shape) == (200, 6, 3), f"forecast shape {tuple(fc.shape)}")
    check(bool((fc == torch.round(fc)).all()), "forecast not integer-valued")
    check(bool((fc.sum(-1) == POP).all()), "forecast does not conserve population")
    check(bool((torch.diff(fc[..., 0], dim=1) <= 0).all()), "S increases in the forecast")
    print(f"forecast: checkpoint chains continued as rows 60..159 (acceptance "
          f"{float(res.acceptance_rate().mean()):.4f}, final step "
          f"{int(res.final_state.step[0])}); forecast {tuple(fc.shape)} integer, "
          f"conserving, S non-increasing; kernel launches {tauleap_cuda.launches()}", flush=True)


def _check_posterior_mean(name, model, thetas, truth):
    """Each component's posterior mean (after a 20 % burn-in) within
    PMMH_MODELS_REL x its truth + PMMH_MODELS_ABS of the truth; returns the
    posterior mean and sd."""
    post = thetas[:, thetas.shape[1] // 5:].reshape(-1, truth.size)
    mean, sd = post.mean(0), post.std(0)
    lo, hi = truth.copy(), truth.copy()
    spec = model.kernel
    if spec is not None and spec.family == "sir_subgroups" and spec.transpose:
        # the data come from the untransposed ODE and the presets infer with
        # the transposed SSA (deliberate, as in the reference): beta[p, g] and
        # beta[g, p] trade places, so each is held to the interval of both
        kk = spec.k
        beta = truth[:kk * kk].reshape(kk, kk)
        lo[:kk * kk] = np.minimum(beta, beta.T).reshape(-1)
        hi[:kk * kk] = np.maximum(beta, beta.T).reshape(-1)
    lo = lo - (PMMH_MODELS_REL * lo + PMMH_MODELS_ABS)
    hi = hi + (PMMH_MODELS_REL * hi + PMMH_MODELS_ABS)
    check(bool(np.all((lo <= mean) & (mean <= hi))),
          f"{name}: posterior mean {mean.round(3).tolist()} outside {lo.tolist()}..{hi.tolist()}")
    return mean, sd


def phase_pmmh_model(name, obs, k):
    cfg = PRESETS[name]()
    full_iters = cfg.mcmc.n_iters
    cfg.seed = SEED + 10 + k
    cfg.mcmc.n_iters = MODELS_ITERS
    model = build_model(cfg)
    m = cfg.mcmc
    y, _ = generate_dataset(cfg)
    truth = np.asarray(cfg.data.theta_true, dtype=np.float64)
    t0 = time.perf_counter()
    kw, _ = pmmh_arguments(cfg, model, obs, y, DEV)
    res = particle_mcmc_chains(model, obs, torch.from_numpy(y).to(DEV), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    family = model.kernel.family
    launched = _build.LAUNCHES[family]
    t_len = y.shape[0]
    check(launched >= (MODELS_ITERS - 1) * (t_len - 1),
          f"{name}: {launched} {family} launches, expected >= {(MODELS_ITERS - 1) * (t_len - 1)}")
    thetas = res.thetas.cpu().numpy()
    check(thetas.shape == (m.n_chains, MODELS_ITERS, truth.size), f"{name} thetas {thetas.shape}")
    check(bool(np.isfinite(thetas).all() and torch.isfinite(res.log_likelihoods).all()),
          f"{name}: non-finite rows")
    acc = res.acceptance_rate().cpu().numpy()
    check(float(acc.mean()) > 0.0, f"{name}: nothing accepted")
    mean, sd = _check_posterior_mean(name, model, thetas, truth)
    print(f"pmmh-models[{name}]: {m.n_chains} chains x {MODELS_ITERS} iters (reduced from "
          f"{full_iters}), N={kw['n_particles']}, h={m.h} in {wall:.2f} s; acceptance per chain "
          f"{np.round(acc, 4).tolist()}; posterior mean {mean.round(4).tolist()} sd "
          f"{sd.round(4).tolist()} (truth {truth.tolist()}); {family} launches {launched}",
          flush=True)
    return launched


def phase_abc():
    dev = DEV
    cfg = PRESETS["sir_abc"]()
    model = build_model(cfg)
    a = cfg.abc
    y, _ = generate_dataset(cfg)
    priors = {n: (a.prior_lo, a.prior_hi) for n in model.theta_names}
    for batch in (a.batch_size, ABC_BIG_BATCH):
        before = _build.LAUNCHES["sir"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = abc_rejection(model, SEED + batch, torch.from_numpy(y).to(dev), a.n_samples,
                            a.threshold, priors, batch_size=batch,
                            steps_per_unit=a.steps_per_unit)
        wall = time.perf_counter() - t0
        launched = _build.LAUNCHES["sir"] - before
        check(res.backend == DEV.type, f"abc ran on {res.backend}")
        check(launched == res.trials // batch, f"abc: {launched} launches for {res.trials} trials")
        tr = res.trajectories
        check(tr.shape == (a.n_samples, y.shape[0], 3), f"abc trajectories {tr.shape}")
        check(bool(np.isfinite(tr).all() and (tr == np.round(tr)).all() and (tr >= 0).all()),
              "abc trajectories not finite non-negative counts")
        means = [float(res.posterior[n].mean()) for n in model.theta_names]
        check(all(abs(m_ - t_) <= ABC_TOL for m_, t_ in zip(means, TRUTH)),
              f"abc posterior means {means} too far from {TRUTH}")
        print(f"abc[batch {batch}]: {a.n_samples} samples, threshold {a.threshold}: trials "
              f"{res.trials}, acceptance {res.acceptance_rate:.5f}, {a.n_samples / wall:.1f} "
              f"samples/s ({wall:.3f} s), posterior mean beta {means[0]:.4f} gamma "
              f"{means[1]:.4f}; kernel launches {launched}", flush=True)


def phase_resume(model, obs, y):
    dev = DEV

    def run(**kw):
        return particle_mcmc_chains(
            model, obs, y.to(dev), list(TRUTH), 0.6, seed=SEED + 30, device=dev,
            n_chains=RESUME_CHAINS, n_iters=40, obs_param=0.1, n_particles=16, n_population=POP,
            mu=20.0, adaptive=True, adapt_start=8, pooled_adaptation=True,
            resample_every=4, **kw)

    whole = run(store_trajectories=True)
    a = run(store_trajectories=True, segment_len=20)
    b = run(store_trajectories=True, init_state=a.final_state, segment_len=20)
    for field in ("thetas", "log_likelihoods", "sampled_trajs"):
        joined = torch.cat([getattr(a, field), getattr(b, field)], dim=1)
        check(torch.equal(joined, getattr(whole, field)), f"resume: 20 + 20 rows differ in {field}")
    check(torch.equal(b.final_state.welford.m2, whole.final_state.welford.m2),
          "resume: final Welford state differs")
    theta_only = run(store_trajectories=False)
    check(torch.equal(theta_only.thetas, whole.thetas), "theta-only thetas differ from storing run's")
    check(torch.equal(theta_only.log_likelihoods, whole.log_likelihoods),
          "theta-only log-likelihoods differ from storing run's")
    print(f"resume: {RESUME_CHAINS} chains x 16 particles, 40 rows == 20 + 20 rows bit for bit "
          f"(thetas, log-likelihoods, trajectories, final state); theta-only thetas == "
          f"storing thetas; acceptance {float(whole.acceptance_rate().mean()):.4f}", flush=True)


# ---- phases 10-11: the runner's entry point and the app ---------------------

@contextlib.contextmanager
def _workdir(tag):
    """A fresh temporary working directory for one runner phase: the runner
    writes data/ and graphs/ under the working directory, never into the
    checkout's committed data/."""
    d = tempfile.mkdtemp(prefix=f"epitpu_smoke_{tag}_")
    old = os.getcwd()
    os.chdir(d)
    try:
        yield d
    finally:
        os.chdir(old)
        shutil.rmtree(d, ignore_errors=True)


def _cli(argv):
    """``epitpu_torch.cli.run.main(argv)`` on the smoke's device without
    plots, its stdout captured and returned."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(list(argv) + ["--device", DEV.type, "--no-plots"])
    except BaseException as e:
        e.add_note(f"runner output before the error:\n{buf.getvalue()[-3000:]}")
        raise
    check(rc == 0, f"runner {argv} returned {rc}")
    return buf.getvalue()


def _last_json(text):
    """The last JSON object the runner printed (indent=2)."""
    lines = text.splitlines()
    start = len(lines) - 1 - lines[::-1].index("{")
    return json.loads("\n".join(lines[start:]))


def _config_file(name, seed, path):
    cfg = PRESETS[name]()
    cfg.seed = seed
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return path


def _run_dirs(root, n_chains):
    """(thetas, log-likelihoods, trajectories) of every run<i>/ the runner
    wrote, stacked over chains."""
    runs = [load_pmmh_run(os.path.join(root, f"run{c + 1}")) for c in range(n_chains)]
    return tuple(np.stack(a) for a in zip(*runs))


def phase_cli_production(prod_thetas, prod_rate):
    """The production preset through the runner: the thetas of phase 5's
    direct call, bit for bit, with checkpoints and artifacts on top."""
    with _workdir("production") as d:
        out = _cli(["--config", _config_file("production", SEED, "production.json"),
                    "--iters", str(PROD_ITERS), "--checkpoint-every", str(CLI_CKPT_EVERY)])
        rep = _last_json(out)
        root = os.path.join(d, "data", "production")
        chains = PRESETS["production"]().mcmc.n_chains
        check(rep["iters_total"] == chains * PROD_ITERS, f"iters_total {rep['iters_total']}")
        check(rep["n_particles"] == 16, f"self-sized N {rep['n_particles']}")
        check(rep["iters_per_s"] > 0, "iters_per_s")
        for key in ("ess_rank", "gelman_rubin_rank"):
            check(len(rep[key]) == 2 and all(math.isfinite(v) for v in rep[key]),
                  f"{key} {rep[key]}")
        for c in (1, 2, 3):
            check(os.path.exists(os.path.join(root, f"run{c}", "thetas.csv")), f"run{c}/thetas.csv")
        check(not os.path.exists(os.path.join(root, "run4")), "run4/ written past 8 chains")
        with np.load(os.path.join(root, "chains.npz")) as z:
            thetas = z["thetas"]
            check("sampled_trajs" not in z.files, "theta-only run saved trajectories")
        check(thetas.shape == (chains, PROD_ITERS, 2), f"chains.npz thetas {thetas.shape}")
        ck = load_pmmh_checkpoint(os.path.join(root, "checkpoint.npz"), DEV)
        check(int(ck.state.step[0]) == PROD_ITERS - 1, f"checkpoint step {int(ck.state.step[0])}")
        check(np.array_equal(ck.thetas, thetas), "checkpoint history differs from chains.npz")
        check(np.array_equal(thetas, prod_thetas),
              "cli-production thetas differ from phase 5's direct call")
        segments = sum(ln.startswith("[pmmh] production: iter ") for ln in out.splitlines())
        check(segments == PROD_ITERS // CLI_CKPT_EVERY, f"{segments} progress lines")
    print(f"cli-production: main --config (production, seed {SEED}) --iters {PROD_ITERS} "
          f"--checkpoint-every {CLI_CKPT_EVERY}: N={rep['n_particles']}, "
          f"{rep['iters_per_s']:.1f} PMMH iters/s (phase 5's direct call {prod_rate:.1f}); "
          f"min rank-ESS {min(rep['ess_rank']):.1f}, max rank-Rhat "
          f"{max(rep['gelman_rubin_rank']):.4f}; run1..run3 + chains.npz {thetas.shape}, "
          f"checkpoint at step {int(ck.state.step[0])}; thetas == phase 5's bit for bit",
          flush=True)


class _Killed(Exception):
    pass


def phase_cli_resume():
    """A run killed after its first checkpointed segment and resumed from
    disk equals an uninterrupted run bit for bit; another seed is refused."""
    name, n_chains = "sir_underreported", PRESETS["sir_underreported"]().mcmc.n_chains
    argv = ["--preset", name, "--iters", str(CLI_RESUME_ITERS),
            "--checkpoint-every", str(CLI_RESUME_SEG)]
    with _workdir("resume-whole") as d:
        _cli(argv)
        whole = _run_dirs(os.path.join(d, "data", name), n_chains)
    with _workdir("resume") as d:
        root = os.path.join(d, "data", name)
        real = mcmc.particle_mcmc_chains

        def first_segment_only(*args, **kwargs):
            if os.path.exists(os.path.join(root, "checkpoint.npz")):
                raise _Killed
            return real(*args, **kwargs)

        mcmc.particle_mcmc_chains = first_segment_only
        try:
            _cli(argv)
            raise AssertionError("the wrapped sampler did not stop the run")
        except _Killed:
            pass
        finally:
            mcmc.particle_mcmc_chains = real
        ck = load_pmmh_checkpoint(os.path.join(root, "checkpoint.npz"), DEV)
        check(int(ck.state.step[0]) == CLI_RESUME_SEG - 1, f"killed at step {int(ck.state.step[0])}")
        check(not os.path.exists(os.path.join(root, "run1")), "a killed run wrote run1/")
        out = _cli(argv + ["--resume"])
        check(f"resuming {name} from checkpoint at iter {CLI_RESUME_SEG}/{CLI_RESUME_ITERS}" in out,
              "the resumed run did not report its checkpoint")
        resumed = _run_dirs(root, n_chains)
        for field, a, b in zip(("thetas", "log-likelihoods", "trajectories"), whole, resumed):
            check(a.shape == b.shape and np.array_equal(a, b), f"resumed {field} differ")
        other = _config_file(name, 1, "other_seed.json")
        try:
            _cli(["--config", other] + argv[2:] + ["--resume"])
            raise AssertionError("a resume under another seed was accepted")
        except ValueError as e:
            check("master key" in str(e), f"unexpected refusal: {e}")
    print(f"cli-resume: {name} x {CLI_RESUME_ITERS} iters, killed after the first "
          f"{CLI_RESUME_SEG}-row segment and resumed with --resume: thetas "
          f"{whole[0].shape}, log-likelihoods and trajectories {whole[2].shape} == the "
          f"uninterrupted run's bit for bit; --resume under seed 1 refused (master key)",
          flush=True)


def phase_cli_model(name):
    """A preset whose observation model no other phase runs, at
    MODELS_ITERS iterations, held to phase 7's posterior-mean bounds."""
    cfg = PRESETS[name]()
    model = build_model(cfg)
    truth = list(cfg.data.theta_true) + ([cfg.data.obs_param] if cfg.mcmc.infer_obs_param else [])
    truth = np.asarray(truth, dtype=np.float64)
    with _workdir(name) as d:
        rep = _last_json(_cli(["--preset", name, "--iters", str(MODELS_ITERS)]))
        thetas, lls, trajs = _run_dirs(os.path.join(d, "data", name), cfg.mcmc.n_chains)
    check(thetas.shape == (cfg.mcmc.n_chains, MODELS_ITERS, truth.size), f"{name} {thetas.shape}")
    check(bool(np.isfinite(thetas).all() and np.isfinite(lls).all()), f"{name}: non-finite rows")
    check(trajs.shape[1:] == (MODELS_ITERS, cfg.data.t_max + 1, 3), f"{name} trajs {trajs.shape}")
    if cfg.mcmc.infer_obs_param:
        p = thetas[..., -1]
        check(bool(((p >= 0) & (p <= 1)).all()), f"{name}: stored p outside [0, 1]")
    check(float(np.mean(rep["acceptance"])) > 1.0 / MODELS_ITERS, f"{name}: nothing accepted")
    mean, sd = _check_posterior_mean(name, model, thetas, truth)
    print(f"cli-models[{name}]: {cfg.data.observation} observations"
          f"{', p inferred' if cfg.mcmc.infer_obs_param else ''}, {cfg.mcmc.n_chains} chains x "
          f"{MODELS_ITERS} iters (reduced from {cfg.mcmc.n_iters}), N={rep['n_particles']}: "
          f"{rep['seconds']:.2f} s = {1e3 * rep['seconds'] / MODELS_ITERS:.2f} ms per iteration; "
          f"acceptance {np.round(rep['acceptance'], 4).tolist()}; posterior mean "
          f"{mean.round(4).tolist()} sd {sd.round(4).tolist()} (truth {truth.tolist()})",
          flush=True)


def phase_cli_extras():
    """The runner's optional stages on sir_underreported: forecast,
    likelihood surface, telemetry and the torch.profiler trace."""
    name = "sir_underreported"
    cfg = PRESETS[name]()
    with _workdir("extras") as d:
        prof = os.path.join(d, "prof")
        out = _cli(["--preset", name, "--iters", str(CLI_EXTRAS_ITERS), "--forecast", "5",
                    "--surface", str(CLI_SURFACE_POINTS), "--log-every", str(CLI_LOG_EVERY),
                    "--profile", prof])
        rep = _last_json(out)
        root = os.path.join(d, "data", name)
        tele = [ln for ln in out.splitlines() if ln.startswith("[pmmh] iter=")]
        rows = [i for i in range(1, CLI_EXTRAS_ITERS) if i % CLI_LOG_EVERY == 0]
        check([int(ln.split()[1][5:]) for ln in tele] == rows, f"telemetry lines {tele}")
        check(all(f"chains={cfg.mcmc.n_chains} " in ln for ln in tele), "telemetry not aggregated")
        fc = np.load(os.path.join(root, "forecast.npy"))
        burn = max(1, CLI_EXTRAS_ITERS // 5)
        check(fc.shape == (CLI_EXTRAS_ITERS - burn, 6, 3), f"forecast {fc.shape}")
        check(bool((fc == np.round(fc)).all() and (fc.sum(-1) == POP).all()),
              "forecast not integer or not conserving the population")
        surf = np.loadtxt(os.path.join(root, "surface.csv"), delimiter=",")
        check(surf.shape == (CLI_SURFACE_POINTS ** 2, 3), f"surface.csv {surf.shape}")
        finite = np.isfinite(surf[:, 2])
        check(int(finite.sum()) >= CLI_SURFACE_POINTS, f"{int(finite.sum())} finite surface points")
        arg = surf[int(np.argmax(np.where(finite, surf[:, 2], -np.inf))), :2]
        # the grid spans the truth +- surface_span; its argmax must be a
        # grid point next to the truth, not merely inside the span
        lo = np.maximum(1e-3, np.asarray(TRUTH) - cfg.surface_span)
        step = (np.asarray(TRUTH) + cfg.surface_span - lo) / (CLI_SURFACE_POINTS - 1)
        check(bool(np.all(np.abs(arg - np.asarray(TRUTH)) <= step)),
              f"surface argmax {arg.tolist()} more than a grid step {step.tolist()} from {TRUTH}")
        check(rep["surface"]["argmax_theta"] == arg.astype(np.float32).tolist(),
              f"report argmax {rep['surface']['argmax_theta']} vs surface.csv {arg.tolist()}")
        trace = os.path.join(prof, "pmmh_trace.json")
        with open(trace) as f:
            text = f.read()
        check("traj_kernel" in text, "the profiler trace names no traj_kernel launch")
        trace_mb = len(text) / 2 ** 20
    print(f"cli-extras: {name} x {CLI_EXTRAS_ITERS} iters --forecast 5 --surface "
          f"{CLI_SURFACE_POINTS} --log-every {CLI_LOG_EVERY} --profile: {len(tele)} telemetry "
          f"lines at rows {rows}; forecast {fc.shape} integer, conserving; surface "
          f"{surf.shape[0]} points, {int(finite.sum())} finite, argmax {arg.round(4).tolist()} "
          f"(truth {list(TRUTH)}); trace {trace_mb:.1f} MiB names traj_kernel; "
          f"{CLI_EXTRAS_ITERS * cfg.mcmc.n_chains / rep['seconds']:.1f} PMMH iters/s under "
          f"the profiler", flush=True)


def phase_cli_abc():
    with _workdir("abc") as d:
        rep = _last_json(_cli(["--preset", "sir_abc"]))
        with open(os.path.join(d, "data", "sir_abc", "posterior.json")) as f:
            post = json.load(f)
    cfg = PRESETS["sir_abc"]()
    check(sorted(post) == ["beta", "gamma"] and all(len(v) == cfg.abc.n_samples
                                                   for v in post.values()),
          "posterior.json")
    means = [float(np.mean(post[n])) for n in ("beta", "gamma")]
    check(all(abs(m_ - t_) <= ABC_TOL for m_, t_ in zip(means, TRUTH)),
          f"cli abc posterior means {means} too far from {TRUTH}")
    check(all(abs(rep["summary"][n]["mean"] - m_) < 1e-6 for n, m_ in zip(("beta", "gamma"), means)),
          "report summary differs from posterior.json")
    check(rep["samples_per_s"] > 0 and rep["samples"] == cfg.abc.n_samples, "abc report")
    print(f"cli-abc: main --preset sir_abc: {rep['samples']} samples of {rep['trials']} trials, "
          f"{rep['samples_per_s']:.1f} samples/s; posterior mean beta {means[0]:.4f} gamma "
          f"{means[1]:.4f}; posterior.json written", flush=True)


def phase_cli_sweep():
    with _workdir("sweep") as d:
        _cli(["--sweep", "tmps", "--iters", str(CLI_SWEEP_ITERS)])
        with open(os.path.join(d, "data", "tmps", "sweep_summary.json")) as f:
            summary = json.load(f)
    levels = summary["levels"]
    check([lv["level"] for lv in levels] == ["11", "7", "3"], f"sweep levels {levels}")
    for lv in levels:
        check(len(lv["pmse"]) == 2 and all(math.isfinite(v) for v in lv["pmse"]),
              f"{lv['name']} pmse {lv['pmse']}")
        check("converged" in lv, f"{lv['name']} has no convergence verdict")
    print(f"cli-sweep: main --sweep tmps --iters {CLI_SWEEP_ITERS}: levels "
          f"{[lv['level'] for lv in levels]}, pmse_mean "
          f"{[round(lv['pmse_mean'], 4) for lv in levels]}, converged "
          f"{[lv['converged'] for lv in levels]}, iters/s "
          f"{[round(lv['iters_per_s'], 1) for lv in levels]}", flush=True)


def phase_app():
    """simulate_overlay: the trajectory batch is one kernel launch, equal to
    the twin's bit for bit; the ODE is the host's."""
    from epitpu_torch.ode import integrate, sir_rhs
    from epitpu_torch.ops.tauleap_cuda import simulate_lanes_reference

    beta, gamma, s0, i0, t_end = APP_ARGS
    before = tauleap_cuda.launches()
    grid, traj, t_ode, sol = app.simulate_overlay(beta, gamma, s0, i0, t_end, n_traj=APP_TRAJ,
                                                  device=DEV.type)
    torch.cuda.synchronize()
    check(tauleap_cuda.launches() - before == 1, "the overlay is not one kernel launch")
    x0 = torch.tensor([s0, i0, 0.0], device=DEV).expand(APP_TRAJ, 3).contiguous()
    th = torch.tensor([beta, gamma], device=DEV).expand(APP_TRAJ, 2).contiguous()
    twin = simulate_lanes_reference(sir_model(), x0, th, 0, 0, t_end, 20)
    check(traj.shape == (t_end + 1, APP_TRAJ, 3) and grid.shape == (t_end + 1,),
          f"overlay shapes {traj.shape}")
    check(np.array_equal(traj, twin.transpose(0, 1).cpu().numpy()),
          "overlay trajectories differ from the twin")
    check(bool((traj.sum(-1) == s0 + i0).all()), "overlay trajectories do not conserve")
    host = integrate(sir_rhs, np.asarray([s0, i0, 0.0]), [beta, gamma], t_ode).numpy()
    check(np.array_equal(sol, host), "overlay ODE differs from the host's")
    print(f"app: simulate_overlay{APP_ARGS} x {APP_TRAJ} trajectories: 1 kernel launch, "
          f"trajectories {traj.shape} == twin bit for bit, conserving; ODE {sol.shape} == "
          f"host; final I mean {float(traj[-1, :, 1].mean()):.2f}, ODE {float(sol[-1, 1]):.2f}",
          flush=True)


# ---- the user models' path: the generated and plain routes ------------------

def _twin_data(model, x0, theta, seed):
    """15 daily states of one twin run from ``x0`` under ``theta`` and their
    binomial observation at p = 0.1, seeded: (y [15, C], states [15, C])."""
    lat = simulate(model, torch.tensor(x0, dtype=torch.float32),
                   torch.tensor(theta, dtype=torch.float32), PhiloxStream(seed), 14, 20)
    rng = np.random.default_rng(seed)
    y = rng.binomial(lat.numpy().astype(np.int64), 0.1).astype(np.float32)
    return torch.from_numpy(y), lat


def _hand_launches():
    return sum(_build.LAUNCHES[f] for f in tauleap_cuda.FAMILIES)


def phase_user_pmmh(obs, y):
    """SIRS PMMH at the production preset's shape: 2,048 chains x 16
    particles, pooled adaptive h = 0.6 from iteration 16, resample_every=4,
    theta only, USER_ITERS iterations, all through the generated functor."""
    model = sirs_model()
    kw = dict(seed=SEED + 91, device=DEV, n_chains=USER_CHAINS, n_iters=USER_ITERS,
              obs_param=0.1, n_particles=16, n_population=POP, mu=20.0, adaptive=True,
              adapt_start=16, pooled_adaptation=True, resample_every=4,
              store_trajectories=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = particle_mcmc_chains(model, obs, y.to(DEV), list(SIRS_TRUTH), 0.6, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, hand = _build.LAUNCHES["generated"], _hand_launches()
    check(hand == 0 and _build.LAUNCHES["plain"] == 0,
          f"user-models[pmmh]: {hand} hand launches, "
          f"{_build.LAUNCHES['plain']} plain runs")
    check(launched >= (USER_ITERS - 1) * (y.shape[0] - 1),
          f"user-models[pmmh]: {launched} generated launches")
    thetas = res.thetas.cpu().numpy()
    lls = res.log_likelihoods.cpu()
    check(thetas.shape == (USER_CHAINS, USER_ITERS, 3), f"user-models[pmmh] thetas {thetas.shape}")
    # a chain whose init search found no finite candidate holds -inf until its
    # first finite proposal, which it accepts (as in epitpu); none may stay there
    check(bool(np.isfinite(thetas).all() and not torch.isnan(lls).any()
               and torch.isfinite(lls[:, -1]).all()),
          f"user-models[pmmh]: NaN rows, or {int((~torch.isfinite(lls[:, -1])).sum())} chains "
          "ending at -inf")
    minus_inf = int((~torch.isfinite(lls)).sum())
    acc = float(res.acceptance_rate().mean())
    check(0.02 < acc < 0.9, f"user-models[pmmh]: pooled acceptance {acc}")
    mean, sd = _check_posterior_mean("user-models[pmmh] SIRS", model, thetas,
                                     np.asarray(SIRS_TRUTH, np.float64))
    print(f"user-models[pmmh]: SIRS (generated route) on its own simulated data (T=15, "
          f"population {POP:g}, binomial p=0.1), {USER_CHAINS} chains x 16 particles x "
          f"{USER_ITERS} iters, pooled adaptive h=0.6 from 16, resample_every=4, theta only, in "
          f"{wall:.2f} s = {USER_CHAINS * USER_ITERS / wall:.1f} PMMH iters/s; acceptance "
          f"{acc:.4f}; posterior mean {mean.round(4).tolist()} sd {sd.round(4).tolist()} (truth "
          f"{list(SIRS_TRUTH)}); -inf log-likelihood rows {minus_inf} of {lls.numel()} (chains "
          f"whose init search found no finite candidate, until their first accepted move); "
          f"generated launches {launched}, hand launches {hand}", flush=True)


def phase_user_one_chain(obs, y):
    """``particle_mcmc`` (one chain) against chain 0 of a one-chain
    ``particle_mcmc_chains`` run, bit for bit, then a 5-unit forecast from
    its USER_ONE_ITERS stored rows."""
    model = sirs_model()
    kw = dict(n_iters=USER_ONE_ITERS, obs_param=0.1, n_particles=16, n_population=POP, mu=20.0,
              n_init_attempts=4, resample_every=4, device=DEV)
    one = particle_mcmc(model, obs, SEED + 92, y.to(DEV), list(SIRS_TRUTH), 0.05, **kw)
    batch = particle_mcmc_chains(model, obs, y.to(DEV), list(SIRS_TRUTH), 0.05, seed=SEED + 92,
                                 n_chains=1, **kw)
    for field in ("thetas", "log_likelihoods", "sampled_trajs"):
        check(torch.equal(getattr(one, field), getattr(batch, field)[0]),
              f"particle_mcmc's {field} differ from chain 0 of particle_mcmc_chains")
    before = _build.LAUNCHES["generated"]
    fc = forecast_from_result(model, PhiloxStream(SEED + 93, DEV), one, 5)
    torch.cuda.synchronize()
    check(_build.LAUNCHES["generated"] == before + 1,
          "the SIRS forecast is not one generated launch")
    check(tuple(fc.shape) == (USER_ONE_ITERS, 6, 3), f"SIRS forecast shape {tuple(fc.shape)}")
    check(bool((fc == torch.round(fc)).all() and (fc >= 0).all() and (fc.sum(-1) == POP).all()),
          "SIRS forecast not non-negative conserving counts")
    print(f"user-models[one-chain]: particle_mcmc x {USER_ONE_ITERS} rows == chain 0 of "
          f"particle_mcmc_chains bit for bit (thetas, log-likelihoods, paths; acceptance "
          f"{float(one.acceptance_rate()):.4f}); 5-unit forecast {tuple(fc.shape)} in one "
          f"generated launch, integer, conserving", flush=True)


def phase_user_abc(lat):
    """ABC rejection on SIRS at batch 512 and 65,536: one generated launch a
    batch; every accepted trajectory within the threshold of the data."""
    model = sirs_model()
    priors = {"beta": (0.0, 5.0), "gamma": (0.0, 5.0), "omega": (0.0, 1.0)}
    obs_np = lat.numpy()
    for batch in (ABC_LANES, ABC_BIG_BATCH):
        before = _build.LAUNCHES["generated"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = abc_rejection(model, SEED + 94 + batch, lat.to(DEV), USER_ABC_SAMPLES,
                            USER_ABC_THRESHOLD, priors, batch_size=batch)
        wall = time.perf_counter() - t0
        launched = _build.LAUNCHES["generated"] - before
        check(res.backend == DEV.type, f"SIRS abc ran on {res.backend}")
        check(launched == res.trials // batch, f"SIRS abc: {launched} launches, {res.trials} trials")
        tr = res.trajectories
        check(tr.shape == (USER_ABC_SAMPLES, 15, 3), f"SIRS abc trajectories {tr.shape}")
        check(bool((tr == np.round(tr)).all() and (tr >= 0).all()
                   and (tr.sum(-1) == tr[:, :1].sum(-1)).all()),
              "SIRS abc trajectories not non-negative conserving counts")
        dist = 0.5 * (np.abs(tr[..., 1] - obs_np[:, 1]).mean(1)
                      + np.abs(tr[..., 2] - obs_np[:, 2]).mean(1))
        check(bool((dist <= USER_ABC_THRESHOLD * (1 + 1e-6)).all()),
              f"SIRS abc accepted a distance of {float(dist.max()):.2f}")
        means = [round(float(res.posterior[n].mean()), 4) for n in model.theta_names]
        print(f"user-models[abc batch {batch}]: SIRS, {USER_ABC_SAMPLES} samples, threshold "
              f"{USER_ABC_THRESHOLD:g}: trials {res.trials}, acceptance "
              f"{res.acceptance_rate:.5f}, {USER_ABC_SAMPLES / wall:.1f} samples/s; posterior "
              f"mean {means} (truth {list(SIRS_TRUTH)}); generated launches {launched}",
              flush=True)


def phase_user_k12(obs):
    """12-group SIR (past MAX_GROUPS, the generated route) through the
    filter: logZ on the card against the host."""
    model = sir_subgroups_model(12)
    beta = np.full((12, 12), 1.0) + 19.0 * np.eye(12)  # force over N_total: R0 about 2.6
    theta = beta.reshape(-1).tolist() + [1.0]
    x0 = [K12_POP - K12_MU, K12_MU, 0.0] * 12
    y, _ = _twin_data(model, x0, theta, SEED + 96)
    _filter_logz("sir_subgroups k=12 generated", model, obs, y, theta, [K12_POP] * 12,
                 [K12_MU] * 12)


def phase_user_competing(obs):
    """The competing-hazards model (I -> R and I -> D) through the filter on
    the plain route: logZ on the card against the host, no kernel launch."""
    model = sird_model()
    check(tauleap_cuda.route(model) == "plain", "the competing-hazards model is not plain")
    y, _ = _twin_data(model, [POP - 20.0, 20.0, 0.0, 0.0], SIRD_TRUTH, SEED + 97)
    _filter_logz("sird competing hazards, plain route", model, obs, y, SIRD_TRUTH, POP, 20.0)
    check(tauleap_cuda.launches() == 0,
          f"the plain route launched a kernel {tauleap_cuda.launches()} times")


# ---- the production study ----------------------------------------------------

def _repro_script():
    """repro_torch.py from the checkout's root, reloaded with REPRO_SMOKE set
    (it reads its sizes when it is imported)."""
    import importlib

    os.environ["REPRO_SMOKE"] = "1"
    try:
        import repro_torch

        return importlib.reload(repro_torch)
    finally:
        del os.environ["REPRO_SMOKE"]


def _finite_summary(where, summary):
    for name, st in summary.items():
        check(all(math.isfinite(st[k]) for k in ("mean", "median", "hdi_lo", "hdi_hi"))
              and st["hdi_lo"] <= st["mean"] <= st["hdi_hi"], f"{where} {name}: {st}")


def phase_repro():
    """repro_torch.py's whole study at repro.py's SMOKE sizes (60 iterations,
    3 chains x 16 particles, 5 substeps, 8 production chains) in one call of
    its main: finite summaries, coverage in [0, 1], the equivalence table,
    and --report on the printed lines equal to the record the run wrote."""
    rt = _repro_script()
    with _workdir("repro") as d:
        rt.OUT_DIR = os.path.join(d, "scratch")
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = rt.main(["--device", DEV.type, "--no-plots"])
        except BaseException as e:
            e.add_note(f"repro_torch output before the error:\n{buf.getvalue()[-3000:]}")
            raise
        check(rc == 0, f"repro_torch returned {rc}")
        with open("repro_torch_smoke.json") as f:
            direct = json.load(f)
        with open("run.log", "w") as f:
            f.write(buf.getvalue())
        with contextlib.redirect_stdout(io.StringIO()):
            check(rt.main(["--report", "run.log"]) == 0, "repro_torch --report failed")
        with open("repro_torch_smoke.json") as f:
            report = json.load(f)
    check([s["stage"] for s in direct["stages"]] == list(rt.STAGES),
          f"stages {[s['stage'] for s in direct['stages']]}")
    counts = {s["stage"]: s.get("n_levels") for s in direct["stages"]}
    check([counts[s] for s in rt.SWEEP_STAGES] == [6, 5, 3, 6, 6] and counts["forecast"] == 1,
          f"levels per stage {counts}")
    for s in direct["stages"]:
        recs = s["levels"] if s["kind"] == "sweep" else [s] if s["kind"] == "flagship" else []
        for rec in recs:
            where = f"repro {s['stage']} {rec.get('level', '')}"
            _finite_summary(where, rec["summary"])
            check(all(math.isfinite(v) for v in rec["pmse"]) and rec["ess_rank"]
                  and all(math.isfinite(v) for v in rec["ess_rank"]), f"{where}: pmse/ESS")
        if s["kind"] == "forecast":
            for lv in s["levels"]:
                cov = list(lv["coverage_5_95"].values()) + [lv["coverage_mean"]]
                check(all(0.0 <= v <= 1.0 for v in cov) and lv["fan_plot"] is None,
                      f"repro forecast T={lv['t_obs']}: {lv}")
    eq = direct["production_equivalence"]
    check(eq is not None and [r["level"] for r in eq["levels"]]
          == [lv["level"] for lv in direct["stages"][0]["levels"]]
          and all(math.isfinite(r["pmse_faithful"]) and math.isfinite(r["pmse_production"])
                  for r in eq["levels"]), f"repro production_equivalence {eq}")
    cmp_ = direct["comparison_with_reference"]
    check(cmp_["n_compared"] == 30, f"repro compared {cmp_['n_compared']} records of 30")
    check(direct["device"] == report["device"] and direct["device"].startswith(
        torch.cuda.get_device_name(0)), f"repro device {direct['device']!r}")
    for key in ("stages", "production_equivalence", "comparison_with_reference",
                "total_chain_iterations"):
        check(report[key] == direct[key], f"repro --report's {key} differs from the run's")
    walls = {s["stage"]: round(s["wall_s"], 1) for s in direct["stages"]}
    print(f"repro: repro_torch.py at SMOKE sizes, {len(direct['stages'])} stages "
          f"({sum(v or 1 for v in counts.values())} runs) in {direct['total_wall_s']:.1f} s, "
          f"{direct['total_chain_iterations']} chain-iterations; stage walls {walls}; "
          f"production equivalence all HDIs overlap {eq['all_hdi_overlap']}; forecast "
          f"coverage {direct['stages'][5]['levels'][0]['coverage_mean']:.2f}; "
          f"{cmp_['n_compared']} records held to repro.json ({cmp_['n_gated']} gated at this "
          f"size); --report == the run's record", flush=True)


# ---- the bench and the in-situ profile ---------------------------------------

# bench_torch.py's four arms at their full widths (32 chains x 4,096
# particles; 2,048 x 16) with the iterations cut; 32 tuned iterations so
# that the pooled covariance adapts (from iteration 16)
BENCH_SMOKE_ENV = {"BENCH_ITERS": "8", "BENCH_TUNED_ITERS": "32"}
INSITU_SHAPES = {  # the committed TPU records' workloads, 4 iterations
    "default": ["--resample-every", "4"],
    "production": ["--chains", "2048", "--particles", "16", "--resample-every", "4",
                   "--no-store-trajectories"],
}
INSITU_ITERS = 4


def phase_bench():
    """bench_torch.py's arms through its run_bench: finite chains, acceptance
    in (0, 1), the kernel launched in every arm's timed run."""
    import bench_torch

    settings = bench_torch.Settings.from_env(BENCH_SMOKE_ENV)
    out, diag, results = bench_torch.run_bench(DEV, settings, bench_torch.N_PARTICLES)
    check(sorted(results) == ["baseline", "eff", "ref", "tuned"], f"bench arms {sorted(results)}")
    for arm, res in results.items():
        # a chain whose two init attempts both fail starts at -inf
        # log-likelihood (bench.py's n_init_attempts=2): thetas only
        check(bool(torch.isfinite(res.thetas).all()), f"bench {arm}: non-finite theta rows")
        check(0.0 < diag[arm]["acceptance"] < 1.0, f"bench {arm}: acceptance {diag[arm]}")
        check(diag[arm]["k4_launches"] > 0, f"bench {arm} never launched the kernel")
    check(all(math.isfinite(out[k]) for k in ("value", "baseline_ess_per_s", "tuned_iters_per_s",
                                               "eff_iters_per_s", "ref_iters_per_s")),
          f"bench output {out}")
    print(f"bench: bench_torch.py's four arms, iterations cut to {settings.n_iters} / "
          f"{settings.n_iters_tuned}: {json.dumps(out)}; diag {json.dumps(diag)}", flush=True)


def phase_insitu():
    """insitu_profile_torch.py's measurement at both committed shapes, cut to
    INSITU_ITERS iterations: the phases hold the device time, the launches
    join, and the kernel lands in pf_propagate."""
    import insitu_profile_torch

    for shape, argv in INSITU_SHAPES.items():
        doc = insitu_profile_torch.measure(insitu_profile_torch.parse_args(
            argv + ["--iters", str(INSITU_ITERS), "--device", DEV.type]))
        pct = doc["phases_pct"]
        check(abs(sum(pct.values()) - 100.0) <= 0.5, f"insitu[{shape}] phases sum {pct}")
        check(doc["unmatched_pct"] <= 5.0, f"insitu[{shape}] unmatched {doc['unmatched_pct']} %")
        check(pct.get("pf_propagate", 0.0) > 0.0, f"insitu[{shape}] no pf_propagate: {pct}")
        traj = [op for op in doc["top_ops_us"] if "traj_kernel" in op["op"]]
        check(traj, f"insitu[{shape}] no traj_kernel among {[o['op'] for o in doc['top_ops_us']]}")
        check(all(op["phases"].get("pf_propagate", 0.0) > 0.99 for op in traj),
              f"insitu[{shape}] traj_kernel outside pf_propagate: {traj}")
        print(f"insitu[{shape}]: {doc['workload']}: {doc['per_iter_us']} device us an "
              f"iteration, device busy {doc['device_busy_pct']} % of "
              f"{doc['wall_s_unprofiled']} s unprofiled ({doc['wall_s']} s profiled); "
              f"phases {json.dumps(pct)}; unmatched {doc['unmatched_pct']} %; device events "
              f"by phase {json.dumps(doc['phases_launches'])}", flush=True)


# ---- the substep levels, population 10^6, and the study harnesses ----------

LARGE_FILTER_CHAINS, LARGE_FILTER_PARTICLES = 32, 1024  # scaling_bench --large-regime
LARGE_T = 100
LARGE_PMMH = dict(n_chains=2, n_iters=60, n_particles=64)  # tests/test_large_regime.py:110
SUBSTEP_LEVELS = (5, 80)  # substeps_study's extremes beside the presets' 20
STUDY_ITERS = 8  # the study harnesses' smoke length (their warm-up runs are shorter)


def _large_inputs(b, gen):
    """Lanes across the population-10^6 epidemic: each the rounded ODE state
    of a random day of scaling_bench_torch.large_dataset (S the rest of
    10^6), theta within 20 % of (0.3, 0.1)."""
    import scaling_bench_torch as sbt

    latent = torch.as_tensor(sbt.large_dataset()[1], dtype=torch.float32)
    day = torch.randint(0, LARGE_T, (b,), generator=gen)
    ir = torch.round(latent[day, 1:])
    x0 = torch.cat([sbt.LARGE_POP - ir.sum(-1, keepdim=True), ir], -1)
    theta = torch.tensor(sbt.LARGE_THETA) * (0.8 + 0.4 * torch.rand(b, 2, generator=gen))
    return x0.to(DEV).contiguous(), theta.to(DEV).contiguous(), 1


def phase_kernel_regimes():
    """The tau-leap kernel against its twin where this slice's harnesses
    take it: SIR at the filter shape at substeps_study's 5 and 80 substeps
    a unit, and at population 10^6 (the large regime's filter step, 32 x
    1,024 lanes, a theta row per chain; its full T = 100 trajectory at the
    ABC batch), timed with their bounds."""
    gen = torch.Generator().manual_seed(SEED + 11)
    model = sir_model()
    rows = [_kernel_case(model, f"filter s={n}", FILTER_LANES, 1, gen, n_sub=n)
            for n in SUBSTEP_LEVELS]
    lanes = LARGE_FILTER_CHAINS * LARGE_FILTER_PARTICLES
    rows.append(_kernel_case(model, "filter pop=1e6", lanes, 1, gen,
                             inputs=_large_inputs(lanes, gen), lpt=LARGE_FILTER_PARTICLES))
    rows.append(_kernel_case(model, f"abc pop=1e6 T={LARGE_T}", ABC_LANES, LARGE_T - 1, gen,
                             inputs=_large_inputs(ABC_LANES, gen), lean=True))
    return rows


def phase_large_regime():
    """tests/test_large_regime.py on the card: 64 lanes from (10^6 - 1,000,
    1,000, 0) over T = 100 exact integers below 2^24 that conserve 10^6; the
    128-particle filter finite, not degenerate, the truth beating (0.6,
    0.1) by more than 50; PMMH 2 x 60 x 64 recovering (0.3, 0.1) within
    0.05 / 0.03."""
    import scaling_bench_torch as sbt

    pop, truth = sbt.LARGE_POP, sbt.LARGE_THETA
    x0 = torch.tensor([pop - 1000.0, 1000.0, 0.0], device=DEV).expand(64, 3).contiguous()
    traj = simulate(sir_model(), x0, torch.tensor(truth, device=DEV), PhiloxStream(0, DEV),
                    LARGE_T, 20)
    check(traj.shape == (LARGE_T + 1, 64, 3) and bool((traj == torch.round(traj)).all())
          and float(traj.max()) < 2**24 and bool((traj >= 0).all())
          and bool((traj.sum(-1) == pop).all()),
          "large regime: states not exact integers below 2^24 conserving 10^6")
    y = torch.as_tensor(sbt.large_dataset()[0], device=DEV)
    obs = get_observation_model("gaussian")

    def logz(theta):
        stream, gen = filter_streams(1, DEV)
        res = particle_filter(sir_model(), obs, y, torch.tensor([theta], device=DEV), 0.05,
                              stream, gen, n_particles=128, n_population=pop, mu=1000.0,
                              steps_per_unit=20, record_history=False)
        return float(res.log_likelihood[0]), bool(res.degenerate[0])

    (ll, degen), (bad, _) = logz(truth), logz((0.6, 0.1))
    check(math.isfinite(ll) and not degen and (ll > bad + 50 or not math.isfinite(bad)),
          f"large regime filter: logZ {ll} (degenerate {degen}) at the truth, {bad} at (0.6, 0.1)")
    t0 = time.perf_counter()
    r = particle_mcmc_chains(sir_model(), obs, y, list(truth), 0.0005, seed=3, device=DEV,
                             obs_param=0.05, n_population=pop, mu=1000.0, steps_per_unit=20,
                             n_init_attempts=4, resample_every=4, store_trajectories=False,
                             **LARGE_PMMH)
    th = r.thetas.cpu().numpy().reshape(-1, 2)[20:]
    wall = time.perf_counter() - t0
    mean = th.mean(0)
    check(np.isfinite(th).all() and abs(mean[0] - 0.3) < 0.05 and abs(mean[1] - 0.1) < 0.03,
          f"large regime PMMH posterior mean {mean.tolist()} against (0.3, 0.1)")
    print(f"large-regime: 64 lanes x T={LARGE_T} exact integers below 2^24 conserving 10^6; "
          f"filter logZ {ll:.2f} at the truth, {bad:.2f} at (0.6, 0.1); PMMH "
          f"{LARGE_PMMH['n_chains']} x {LARGE_PMMH['n_iters']} x {LARGE_PMMH['n_particles']} "
          f"posterior mean {mean.round(4).tolist()} (bounds 0.05 / 0.03), "
          f"{LARGE_PMMH['n_chains'] * LARGE_PMMH['n_iters'] / wall:.1f} iters/s", flush=True)


def _record(name):
    with open(os.path.join(ROOT, name)) as f:
        return json.load(f)


def _check_covers(where, got, want, **kw):
    missing = missing_keys(got, want, **kw)
    check(not missing, f"{where}: the record lacks the TPU record's keys {missing}")


def phase_studies():
    """Every mode of substeps_study_torch.py, ess_study_torch.py and
    scaling_bench_torch.py at a smoke size on the card (the weak-scaling
    modes as gloo processes on the host, widths 1-2): each record holds the
    TPU record's keys and this card's name, and its decisions."""
    import ess_study_torch as est
    import scaling_bench_torch as sbt
    import substeps_study_torch as sst

    smi = card_name(DEV)
    doc = sst.measure(DEV, sst.Sizes(pf_reps=8, pf_particles=256, mcmc_iters=STUDY_ITERS,
                                     mcmc_chains=4, mcmc_particles=64), profile_iters=2)
    _check_covers("substeps", doc, _record("SUBSTEPS.json"))
    post = doc["posterior"].values()
    check(doc["device"] == smi and all(r["k4_launches"] > 0 and 0 < r["k4_device_pct"] < 100
                                       for r in post), f"substeps rows {list(post)}")
    parts = [f"substeps: choice {doc['smallest_unbiased_substeps']} (TPU "
             f"{doc['tpu_smallest_unbiased_substeps']}), kernel share of device time "
             + "/".join(f"{r['k4_device_pct']:.1f}" for r in post) + " %"]
    tpu_ess = _record("ESS_STUDY.json")
    with _workdir("studies") as d:
        out = os.path.join(d, "ess.json")
        for mode, key in est.SECTION.items():
            doc = est.run_mode(mode, DEV, out, rows=[0], n_iters=STUDY_ITERS, seeds=(1, 2))
            got = doc if key is None else doc[key]
            want = ({k: tpu_ess[k] for k in ("workload", "arms", "best_arm", "note")}
                    if key is None else tpu_ess[key])
            _check_covers(f"ess {mode}", got, want)
            row = got["arms" if key is None else "rows"][0]
            check(row["device"] == smi and math.isfinite(row["ess_per_s_mean"])
                  and row["iters_per_s_mean"] > 0, f"ess {mode} row {row}")
            parts.append(f"ess {mode} row 0 {row['iters_per_s_mean']} iters/s")
    tpu_sc = _record("SCALING.json")
    sections = {
        "gpu_chain_sweep": sbt.gpu_chain_sweep(DEV, chain_counts=(8, 128), n_iters=4),
        "large_regime": sbt.large_regime(DEV, n_iters=4),
        "abc_backend_comparison": sbt.abc_route_comparison(DEV, repeats=2),
        "resampler_crossover": sbt.resampler_crossover(DEV, ns=(4096,), reps=2),
        "ancestor_search": sbt.ancestor_search(DEV, ns=(8, 64, 1024), reps=3),
    }
    for key, spec in sbt.WEAK.items():
        tiny = dataclasses.replace(spec, per_shard=min(spec.per_shard, 4), n_iters=4, repeats=1,
                          reps_per_run=2)
        sections[key] = sbt.weak_scaling(tiny, widths=(1, 2) if key == "weak_scaling" else (2,))
    back = {v: k for k, v in sbt.JAX_KEYS.items()}
    for key, sec in sections.items():
        if back.get(key, key) in tpu_sc:
            _check_covers(f"scaling {key}", sec, tpu_sc[back.get(key, key)],
                          renamed=sbt.JAX_KEYS)
        check(sec["device"] == smi or (sec["device"] == "cpu" and sec["host_card"] == smi),
              f"scaling {key} device {sec['device']}")
    abc = sections["abc_backend_comparison"]
    check(abc["same_draws"] and [r["route"] for r in abc["rows"]] == ["hand", "generated"],
          f"scaling abc {abc['rows']}")
    check(all(r["same_ancestors"] for r in sections["ancestor_search"]["rows"]),
          "scaling ancestor_search: compare-reduce and searchsorted disagree")
    check(all(k > 0 for k in [r["k4_launches"] for r in sections["gpu_chain_sweep"]["rows"]]
              + [sections["large_regime"]["k4_launches"]]), "scaling: the kernel never ran")
    parts.append(f"scaling large regime {sections['large_regime']['iters_per_s']} iters/s, "
                 f"ABC generated/hand {abc['generated_speedup']}x, weak widths "
                 + ", ".join(f"{k} {[r['eff_wall'] for r in sections[k]['rows']]}"
                             for k in sbt.WEAK))
    print("studies: " + "; ".join(parts), flush=True)


# ---- the sharded runs and the exact SSA --------------------------------------

def phase_lane_map():
    """The kernel under a lane map (epitpu_torch.dist's sharded filter
    step): equal to its twin bit for bit after one substep at the filter
    and ABC shapes, and the lanes of a 2-shard filter step (by particles,
    then by chains), each launched under its map, equal the unsharded
    launch's lanes bit for bit."""
    gen = torch.Generator().manual_seed(SEED + 3)
    model = sir_model()
    sim, twin = tauleap_cuda.simulate_lanes, tauleap_cuda.simulate_lanes_reference
    parts = []
    for tag, b, t_max, lpt, lane_map in (
            ("filter", FILTER_LANES, 1, 16, (FILTER_LANES // 16, 16, 32, 16)),
            ("abc", ABC_LANES, 14, 1, (3, ABC_LANES, 2 * ABC_LANES, ABC_LANES))):
        x0, th, _ = _lane_inputs(model, b, gen)
        th = th[::lpt].contiguous()
        final = tag == "filter"
        seed = SEED + 11
        k1 = sim(model, x0, th, seed, 5, 1, 1, final, lpt, lane_map)
        p1 = twin(model, x0, th, seed, 5, 1, 1, final, lpt, lane_map=lane_map)
        k = sim(model, x0, th, seed, 5, t_max, 20, final, lpt, lane_map)
        p = twin(model, x0, th, seed, 5, t_max, 20, final, lpt, lane_map=lane_map)
        ident = sim(model, x0, th, seed, 5, 1, 1, final, lpt)
        torch.cuda.synchronize()
        check(torch.equal(k1, p1), f"lane-map {tag}: the kernel differs from its twin after "
                                   "one substep")
        check(not torch.equal(k1, ident), f"lane-map {tag}: the map changed no draw")
        same = float((k == p).reshape(b, -1).all(-1).float().mean())
        parts.append(f"{tag} {b} lanes, map {lane_map}: twin == kernel bit for bit after 1 "
                     f"substep, {same:.6f} of lanes after {t_max * 20}")
    # a 2-shard filter step: [2048 chains, 16 particles] split by particles
    # (8 a shard) and by chains (1,024 a shard)
    chains, n = FILTER_LANES // 16, 16
    x0, th, _ = _lane_inputs(model, FILTER_LANES, gen)
    cloud, th = x0.reshape(chains, n, 3), th[::n].contiguous()
    whole = sim(model, x0, th, SEED, 9, 1, 20, True, n).reshape(chains, n, 3)
    for p0 in (0, n // 2):
        part = cloud[:, p0:p0 + n // 2].reshape(-1, 3).contiguous()
        got = sim(model, part, th, SEED, 9, 1, 20, True, n // 2, (0, n // 2, n, p0))
        check(torch.equal(got.reshape(chains, n // 2, 3), whole[:, p0:p0 + n // 2]),
              f"particle shard at {p0}: lanes differ from the unsharded launch's")
    for c0 in (0, chains // 2):
        part = cloud[c0:c0 + chains // 2].reshape(-1, 3).contiguous()
        got = sim(model, part, th[c0:c0 + chains // 2].contiguous(), SEED, 9, 1, 20, True, n,
                  (c0, n, n, 0))
        check(torch.equal(got.reshape(chains // 2, n, 3), whole[c0:c0 + chains // 2]),
              f"chain shard at {c0}: lanes differ from the unsharded launch's")
    print(f"kernel[lane-map]: {'; '.join(parts)}; a 2-shard filter step ({chains} chains x "
          f"{n} particles, by particles and by chains) == the unsharded launch's lanes bit "
          "for bit", flush=True)


def phase_exact():
    """The exact SSA on the card (plain torch, epitpu_torch.sim.exact)
    against K4 at 40 substeps, with tests/test_sim.py's moment bounds: SIR
    at population 4,820, K = 2 subgroups; ``sampler="exact"`` through
    ``simulate`` on the card; the absorbing state stays frozen in both."""
    from epitpu_torch.sim import (advance, default_max_events, exact_advance,
                                  exact_simulate_grid, simulate)

    model = sir_model()
    theta = torch.tensor(TRUTH, device=DEV)
    cloud = torch.tensor([4800.0, 20.0, 0.0], device=DEV).expand(EXACT_LANES, 3).contiguous()
    t0 = time.perf_counter()
    ex = exact_simulate_grid(model, SEED + 50, cloud, theta, EXACT_UNITS,
                             default_max_events(model, [POP]))
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    tl = simulate(model, cloud, theta, PhiloxStream(SEED + 51, DEV), EXACT_UNITS, 40)
    torch.cuda.synchronize()
    t_tl = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(SEED + 52)
    t0 = time.perf_counter()
    eb = simulate(model, cloud, theta, PhiloxStream(SEED + 53, DEV), EXACT_UNITS, 40,
                  sampler="exact", generator=gen)
    torch.cuda.synchronize()
    t_eb = time.perf_counter() - t0
    check(ex.device.type == eb.device.type == "cuda", "the exact paths left the card")
    check(bool((ex.sum(-1) == POP).all() and (eb.sum(-1) == POP).all()),
          "exact paths do not conserve the population")
    rows = []
    for t in (3, 5, 8):
        me, se = float(ex[t, :, 1].mean()), float(ex[t, :, 1].std())
        for name, out in (("K4", tl), ("sampler=exact", eb)):
            mt, st = float(out[t, :, 1].mean()), float(out[t, :, 1].std())
            check(abs(mt - me) < 0.05 * max(me, 50.0) and abs(st - se) < 0.15 * max(se, 10.0),
                  f"exact: {name} I({t}) mean/sd {mt:.2f}/{st:.2f} vs SSA {me:.2f}/{se:.2f}")
        rows.append(f"t={t} SSA {me:.1f}/{se:.1f} K4 {float(tl[t, :, 1].mean()):.1f}/"
                    f"{float(tl[t, :, 1].std()):.1f} exact-binomial "
                    f"{float(eb[t, :, 1].mean()):.1f}/{float(eb[t, :, 1].std()):.1f}")
    sub = sir_subgroups_model(2)
    th2 = torch.tensor([5.0, 2.0, 1.0, 3.0, 0.5], device=DEV)
    x2 = torch.tensor([2000.0, 30.0, 0.0, 3000.0, 40.0, 0.0], device=DEV).expand(512, 6)
    ex2 = exact_simulate_grid(sub, SEED + 54, x2.contiguous(), th2, 6,
                              default_max_events(sub, [2030, 3040]))
    tl2 = simulate(sub, x2.contiguous(), th2, PhiloxStream(SEED + 55, DEV), 6, 40)
    for t in (2, 4):
        for c in (1, 4):
            me, mt = float(ex2[t, :, c].mean()), float(tl2[t, :, c].mean())
            check(abs(mt - me) < 0.08 * max(me, 30.0),
                  f"exact: K=2 I[{c}]({t}) K4 {mt:.2f} vs SSA {me:.2f}")
    dead = torch.tensor([[100.0, 0.0, 20.0]], device=DEV)
    frozen = exact_advance(model, gen, dead, theta, 5.0, 64)
    frozen_tl = advance(model, dead, theta, PhiloxStream(SEED + 56, DEV))
    check(torch.equal(frozen, dead) and torch.equal(frozen_tl, dead),
          "the absorbing state moved")
    print(f"exact: SIR {EXACT_LANES} lanes x {EXACT_UNITS} units, exact SSA {t_exact:.3f} s, "
          f"K4 (40 substeps) {1e3 * t_tl:.3f} ms, sampler='exact' {t_eb:.3f} s (host clock); "
          f"I(t) mean/sd: {'; '.join(rows)}; K=2 subgroups "
          f"512 lanes K4 within 8 % of the SSA; sampler='exact' on the card within the bounds; "
          "absorbing state frozen", flush=True)


def _spawn(phase, world, env_extra=None):
    """Run ``world`` children of this script for ``phase`` (each under
    CHILD_TIMEOUT seconds), all on the one card; returns each rank's JSON
    report and rank 0's arrays.  A child that fails fails the phase."""
    d = tempfile.mkdtemp(prefix=f"epitpu_smoke_{phase}_")
    env = dict(os.environ, **(env_extra or {}))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", phase,
                               str(r), str(world), d], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"{phase} rank {r} of {world} exited {p.returncode}:\n"
                                     f"{out[-3000:]}")
        reports = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        with np.load(os.path.join(d, "result.npz")) as z:
            arrays = dict(z)
        return reports, arrays
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(d, ignore_errors=True)


def _arrays(arr):
    return arr["thetas"], arr["log_likelihoods"], arr["sampled_trajs"]


def on_child_path(name, families, reports):
    """The launch counts of a path run in child processes, summed over
    them; every child must have launched each family."""
    counts = dict.fromkeys(_build.LAUNCHES, 0)
    for r, rep in enumerate(reports):
        for f in families:
            check(rep["launches"][f] > 0, f"{name}: rank {r} never launched the {f} kernel")
        for f, v in rep["launches"].items():
            counts[f] += v
    PATH_LAUNCHES[name] = counts


def compare_rows(label, got, want):
    """Gathered sharded chains against the unsharded run, bit for bit:
    thetas, log-likelihoods and paths.  ``got``/``want``: (thetas [chains,
    rows, d], log-likelihoods [chains, rows], sampled paths [chains, rows,
    T, C]) numpy arrays."""
    for what, g, w in zip(("thetas", "log-likelihoods", "paths"), got, want):
        check(g.shape == w.shape, f"{label}: {what} {g.shape} vs {w.shape}")
        same = g == w
        check(bool(same.all()), f"{label}: {what} differ from the unsharded run in "
                                f"{int(same.size - same.sum())} of {same.size} values")
    return "== the unsharded run bit for bit" + (", paths too" if got[2].size else "")


def _rows(res):
    return (res.thetas.cpu().numpy(), res.log_likelihoods.cpu().numpy(),
            res.sampled_trajs.cpu().numpy())


def _production_arguments(model, obs, y, rows, device):
    cfg = PRESETS["production"]()
    cfg.seed = SEED + 40
    cfg.mcmc.n_iters = rows
    kw, _ = pmmh_arguments(cfg, model, obs, y, device)
    return kw


def phase_dist_chains(model, obs, y):
    """The production preset's chains on a 2 x 1 mesh: two processes over
    gloo sharing the one card (1,024 chains each), DIST_CHAIN_ROWS rows,
    against a single-process run of the same rows."""
    reports, arr = _spawn("dist-chains", 2)
    on_child_path("dist-chains", ["sir"], reports)
    kw = _production_arguments(model, obs, y, DIST_CHAIN_ROWS, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = particle_mcmc_chains(model, obs, y.to(DEV), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(rep["n_particles"] == kw["n_particles"] for rep in reports),
          f"self-sized N differs: {[rep['n_particles'] for rep in reports]} vs "
          f"{kw['n_particles']}")
    verdict = compare_rows("dist-chains", _arrays(arr), _rows(res))
    n = kw["n_chains"] * DIST_CHAIN_ROWS
    rate = n / max(rep["seconds"] for rep in reports)
    print(f"dist-chains: production preset ({kw['n_chains']} chains x N={kw['n_particles']}, "
          f"pooled adaptive h={kw['h']} from {kw['adapt_start']}, resample_every="
          f"{kw['resample_every']}, theta only) on a 2 x 1 mesh, two processes over gloo "
          f"sharing one card, {DIST_CHAIN_ROWS} rows: gathered chains {verdict}; two "
          f"processes {rate:.1f} PMMH iters/s, one process {n / wall:.1f} (two processes "
          f"sharing one card: not a scaling result); launches per rank "
          f"{[rep['launches']['sir'] for rep in reports]}",
          flush=True)


def phase_dist_particles(model, obs, y):
    """SIR binomial p = 0.1 with each chain's particles on a 1 x 2 mesh
    (two processes over gloo on the card), with paths; and
    ``sharded_particle_filter``'s logZ at the truth."""
    reports, arr = _spawn("dist-particles", 2)
    on_child_path("dist-particles", ["sir"], reports)
    res = particle_mcmc_chains(model, obs, y.to(DEV), **_particle_kw(DEV))
    verdict = compare_rows("dist-particles", _arrays(arr), _rows(res))
    stream, gen = filter_streams(SEED + 60, DEV)
    want = particle_filter(model, obs, y.to(DEV), torch.tensor([TRUTH] * DIST_PART_CHAINS,
                                                                 device=DEV),
                           0.1, stream, gen, n_particles=DIST_PART_PARTICLES, n_population=POP,
                           mu=20.0, record_history=False).log_likelihood.cpu().numpy()
    got = arr["logz"]
    same = np.array_equal(got, want)
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(same or rel <= 1e-5, f"sharded filter logZ differs by {rel:.3g} relative")
    rate = DIST_PART_CHAINS * DIST_PART_ROWS / max(rep["seconds"] for rep in reports)
    print(f"dist-particles: SIR binomial p=0.1, {DIST_PART_CHAINS} chains x "
          f"{DIST_PART_PARTICLES} particles on a 1 x 2 mesh ({DIST_PART_PARTICLES // 2} a rank, "
          f"two processes over gloo on one card), {DIST_PART_ROWS} rows with paths: thetas and "
          f"log-likelihoods {verdict}; sharded_particle_filter logZ at the truth "
          f"({DIST_PART_CHAINS} replicates) {'==' if same else f'within {rel:.3g} of'} the "
          f"unsharded filter's (mean {float(np.mean(got)):.4f}); {rate:.1f} PMMH iters/s on "
          f"two processes; launches per rank {[rep['launches']['sir'] for rep in reports]}",
          flush=True)


def _particle_kw(device):
    return dict(parameters=list(TRUTH), h=0.05, seed=SEED + 61, device=device,
                n_chains=DIST_PART_CHAINS, n_iters=DIST_PART_ROWS, obs_param=0.1,
                n_particles=DIST_PART_PARTICLES, n_population=POP, mu=20.0, n_init_attempts=4,
                store_trajectories=True)


def _nccl_kw(device):
    return dict(parameters=list(TRUTH), h=0.6, seed=SEED + 70, device=device,
                n_chains=NCCL_CHAINS, n_iters=NCCL_ROWS, obs_param=0.1, n_particles=16,
                n_population=POP, mu=20.0, adaptive=True, adapt_start=8, pooled_adaptation=True,
                resample_every=4, store_trajectories=True)


def phase_dist_nccl(model, obs, y):
    """One process joins a 1-rank group through the env triple and
    ``initialize_multihost`` (NCCL for the card, the process bound to card
    ``LOCAL_RANK``), and runs ``sharded_pmmh`` on its 1 x 1 mesh with paths
    and pooled adaptation (a mesh axis of one shard runs no collective); an
    all-gather of the run's log-likelihoods over the NCCL group, on the
    card, must give them back unchanged."""
    port = free_port()
    reports, arr = _spawn("dist-nccl", 1, {"EPITPU_COORDINATOR": f"localhost:{port}",
                                           "EPITPU_NUM_PROCESSES": "1",
                                           "EPITPU_PROCESS_ID": "0", "LOCAL_RANK": "0"})
    on_child_path("dist-nccl", ["sir"], reports)
    check("cuda:nccl" in reports[0]["backend"], f"dist-nccl group on {reports[0]['backend']}")
    check(reports[0]["current_device"] == 0 and reports[0]["mesh_device"] == "cuda:0",
          f"dist-nccl: LOCAL_RANK 0 but current device {reports[0]['current_device']}, "
          f"mesh on {reports[0]['mesh_device']}")
    check(reports[0]["nccl_gather"], "dist-nccl: the all-gather over NCCL changed its input")
    res = particle_mcmc_chains(model, obs, y.to(DEV), **_nccl_kw(DEV))
    verdict = compare_rows("dist-nccl", _arrays(arr), _rows(res))
    print(f"dist-nccl: 1-rank group from the env triple (initialize_multihost -> "
          f"{reports[0]['multi']}) on {reports[0]['backend']}, bound to card "
          f"{reports[0]['current_device']} = LOCAL_RANK, all-gather on the card "
          f"unchanged, sharded_pmmh "
          f"{NCCL_CHAINS} chains x 16, pooled adaptive, paths, {NCCL_ROWS} rows: {verdict}; "
          f"launches {reports[0]['launches']['sir']}", flush=True)


def phase_cli_multihost():
    """The runner with --multihost under a 1-process env triple."""
    port = free_port()
    reports, _ = _spawn("cli-multihost", 1, {"EPITPU_COORDINATOR": f"localhost:{port}",
                                             "EPITPU_NUM_PROCESSES": "1",
                                             "EPITPU_PROCESS_ID": "0"})
    on_child_path("cli-multihost", ["sir"], reports)
    rep = reports[0]
    check(rep["joined"] == [True, 1], f"the runner did not join the group: {rep['joined']}")
    report = rep["report"]
    n_chains = PRESETS["sir_underreported"]().mcmc.n_chains
    check(report["iters_total"] == n_chains * CLI_MULTIHOST_ITERS,
          f"cli-multihost iters_total {report['iters_total']}")
    check(all(math.isfinite(v) for v in report["gelman_rubin_rank"]), "cli-multihost rhat")
    print(f"cli-multihost: main --multihost --preset sir_underreported --iters "
          f"{CLI_MULTIHOST_ITERS} under a 1-process env triple: joined a group of 1; N="
          f"{report['n_particles']}, {report['iters_per_s']:.1f} PMMH iters/s, acceptance "
          f"{np.round(report['acceptance'], 4).tolist()}; launches {rep['launches']['sir']}",
          flush=True)


MULTICHIP_RANKS = 4  # a 2 x 2 mesh: chain shards at full width, split over particles too


def phase_multichip():
    """``multichip_torch.py``'s checks at its full sizes with four ranks over
    gloo sharing the card (NCCL refuses two ranks on one card): epitpu's
    dryrun (shard check replicated, pooled != unpooled, the 1 x 4 filter's
    logZ within 5.0 of the unsharded one) and its three gathered runs
    (production 4 x 1, bench.py's shape 1 x 4, the 2 x 2 mesh with paths),
    each equal to the same run unsharded on the card, bit for bit.  The
    chain shards of the 2 x 2 mesh are where a row reduction that rounds by
    its row count shows (``smc.filter``)."""
    import multichip_torch

    world = MULTICHIP_RANKS
    rec = multichip_torch.run(world, "gloo", torch.device("cuda", 0), multichip_torch.FULL,
                              distinct_cards=False)
    on_child_path("multichip[1 card]", ["sir"], rec["ranks"])
    dr = rec["dryrun"]
    runs = "; ".join(f"{name} {r['mesh'][0]} x {r['mesh'][1]} ({r['chains']} chains x "
                     f"{r['particles']} x {r['rows']} rows) == unsharded bit for bit"
                     for name, r in rec["runs"].items())
    print(f"multichip[1 card]: multichip_torch.py --gloo {world} --device cuda: dryrun "
          f"{dr['mesh'][0]} x {dr['mesh'][1]} shards replicated, pooled != unpooled, "
          f"1 x {world} filter logZ {dr['sharded_logz']:.4f} vs unsharded "
          f"{dr['unsharded_logz']:.4f}; {runs}; groups {rec['ranks'][0]['backends']}; "
          f"launches per rank {[rep['launches']['sir'] for rep in rec['ranks']]}; ranks took "
          f"{rec['spawn_seconds']:.1f} s", flush=True)


def child_main(phase, rank, world, d):
    """One rank of a sharded phase: run it, then write ``rank{r}.json``
    (launch counts, seconds) and, on rank 0, ``result.npz``."""
    import datetime

    import torch.distributed as dist

    from epitpu_torch.dist import (gather_result, initialize_multihost, make_mesh,
                                   sharded_particle_filter, sharded_pmmh)
    from epitpu_torch.dist.mesh import all_gather_cat

    model, obs = sir_model(), get_observation_model("binomial")
    y = dataset_from_csv(os.path.join(DATA, "dataset.csv"), DEV)
    report, arrays = {}, {}
    if phase == "cli-multihost":
        with _workdir("cli-multihost"):
            out = _cli(["--multihost", "--preset", "sir_underreported", "--iters",
                        str(CLI_MULTIHOST_ITERS)])
        report.update(report=_last_json(out),
                      joined=[dist.is_initialized(), dist.get_world_size()])
    else:
        if phase == "dist-nccl":
            report["multi"] = initialize_multihost()
            report["current_device"] = torch.cuda.current_device()
            mesh = make_mesh()  # cuda:$LOCAL_RANK
            report["mesh_device"] = str(mesh.device)
            report["backend"] = dist.get_backend_config()  # e.g. "cpu:gloo,cuda:nccl"
            kw = _nccl_kw(mesh.device)
        else:
            dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}",
                                    world_size=world, rank=rank,
                                    timeout=datetime.timedelta(seconds=CHILD_TIMEOUT // 2))
            if phase == "dist-chains":
                mesh = make_mesh(2, 1, device=DEV, backend="gloo")
                kw = _production_arguments(model, obs, y, DIST_CHAIN_ROWS, mesh.device)
                report["n_particles"] = kw["n_particles"]
            else:
                mesh = make_mesh(1, 2, device=DEV, backend="gloo")
                kw = _particle_kw(mesh.device)
        kw = dict(kw, device=mesh.device)
        head = [kw.pop(k) for k in ("seed", "parameters", "h", "n_chains")]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shard = sharded_pmmh(mesh, model, obs, head[0], y, *head[1:], **kw)
        torch.cuda.synchronize()
        report["seconds"] = time.perf_counter() - t0
        gathered = gather_result(shard, mesh)
        arrays.update(zip(("thetas", "log_likelihoods", "sampled_trajs"), _rows(gathered)))
        if phase == "dist-nccl":
            ll = gathered.log_likelihoods.to(mesh.device)
            report["nccl_gather"] = torch.equal(all_gather_cat(ll, dist.group.WORLD), ll)
        if phase == "dist-particles":
            theta = torch.tensor([TRUTH] * DIST_PART_CHAINS, device=mesh.device)
            f = sharded_particle_filter(mesh, model, obs, SEED + 60, y, theta, 0.1,
                                        DIST_PART_PARTICLES, n_population=POP, mu=20.0,
                                        record_history=False)
            arrays["logz"] = gather_result(f, mesh).log_likelihood.cpu().numpy()
    torch.cuda.synchronize()
    report["launches"] = dict(_build.LAUNCHES)  # this process's: the child starts at 0
    with open(os.path.join(d, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    if rank == 0:
        np.savez(os.path.join(d, "result.npz"), **arrays)
    if dist.is_initialized():
        dist.destroy_process_group()


IDENTITY_KEYS = ("model", "k", "transpose", "against", "shape", "lanes", "t_max", "n_sub",
                 "lanes_per_theta", "same_1sub", "same_1sub_final", "same_full",
                 "same_full_final", "max_abs_err", "off_by_one_1sub")
TIMING_KEYS = ("mode", "ms", "b2b_ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
               "b2b_bound_share", "library_ms", "ops", "bytes", "draws", "small_draws",
               "cdf_terms", "us_per_substep", "ns_per_lane_substep", "sm_clock")


HEADLINE = {"generated": "sirs generated"}  # the user model's cases head its entry


def kernel_entries(rows):
    """One entry per kernel family and one for the generated functors: the
    filter-shape case (the production path's launch; SIRS for the generated
    route) as the headline, its ABC case beside it, and every case it was
    held to its twin (or hand functor) at."""
    entries = []
    for fam in tauleap_cuda.KERNEL_PATHS:
        cases = rows[fam]
        head = [c for c in cases if c["model"] == HEADLINE.get(fam, c["model"])]
        main = next(c for c in head if c["shape"] == "filter")
        abc = next(c for c in head if c["shape"] == "abc")
        entries.append({
            "name": KERNEL_NAMES[fam],
            "route": "cuda",
            "kernel_route": "generated" if fam == "generated" else "hand",
            "source": ("epitpu_torch/csrc/tauleap_kernel.cuh" if fam == "generated" else
                       "epitpu_torch/csrc/tauleap.cu"),
            "replaces": "epitpu/ops/tauleap_pallas.py:207",
            "launches": sum(p.get(fam, 0) for p in PATH_LAUNCHES.values()),
            "launches_by_path": {n: p[fam] for n, p in PATH_LAUNCHES.items() if p.get(fam)},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "bound_share": main["bound_share"],
            "b2b_ms": main["b2b_ms"],
            "library_ms": None,  # no single PyTorch call computes tau-leap trajectories
            "abc_ms": abc["ms"],
            "abc_b2b_ms": abc["b2b_ms"],
            "abc_plain_ms": abc["plain_ms"],
            "abc_bound_ms": abc["bound_ms"],
            "abc_bound_share": abc["bound_share"],
            "instantiations": [
                {key: c[key] for key in IDENTITY_KEYS + (TIMING_KEYS if c["ms"] else ())
                 + ("hand_b2b_ms",) if key in c}
                for c in cases
            ],
        })
    return entries


def hand_entry(name, key, source, result):
    """The JSON entry of a hand kernel held to its twin bit for bit
    (``_time_against_twin``, ``_pmmh_against_twin``): its 2,048 x 16 case as
    the headline, the 32 x 4,096 case beside it."""
    main = result["rows"][0]
    return {
        "name": name,
        "route": "cuda",
        "kernel_route": "hand",
        "source": source,
        # epitpu leaves the weighting (epitpu/observe/models.py:28-97), the
        # update (epitpu/smc/filter.py:208-233) and the resampling
        # (epitpu/smc/resample.py:systematic_resample, the gather at
        # epitpu/smc/filter.py:172) to XLA
        "replaces": None,
        "launches": sum(p.get(key, 0) for p in PATH_LAUNCHES.values()),
        "launches_by_path": {n: p[key] for n, p in PATH_LAUNCHES.items() if p.get(key)},
        "max_abs_err": 0.0,  # bit for bit
        **{k: main[k] for k in ("ms", "b2b_ms", "plain_ms", "bound_ms", "bound_by",
                                "bound_share")},
        "library_ms": None,  # no single PyTorch call computes any of them
        "cases": result["rows"],
        **{k: result[k] for k in ("registers", "pmmh_launches", "pmmh_filter_steps")
           if k in result},
    }


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    timed("build", phase_build)  # before any child process: children only load the libraries
    rows = timed("kernel", phase_kernel)
    rows["sir"] += timed("kernel[regimes]", phase_kernel_regimes)
    rows["generated"] = timed("kernel[generated]", phase_generated)
    timed("advance[t_span]", phase_advance_span)
    timed("kernel[lane-map]", phase_lane_map)
    model = sir_model()
    obs = get_observation_model("binomial")
    y = dataset_from_csv(os.path.join(DATA, "dataset.csv"), DEV)
    weight = timed("weight_kernel", phase_weight_kernel, model, obs, y)
    loglik = timed("loglik_kernel", phase_loglik_kernel, model, obs, y)
    resample = timed("resample_kernel", phase_resample_kernel, model, obs, y)
    seir_cell = timed("seir_cell", phase_seir_cell)
    timed("filter", phase_filter, obs, y)
    prod = on_main_path("pmmh", ["sir"], phase_pmmh, model, obs, y)
    on_main_path("forecast", ["sir"], phase_forecast, model, obs, y)
    for k, name in enumerate(MODEL_PRESETS):
        fam = build_model(PRESETS[name]()).kernel.family
        on_main_path(f"pmmh-models[{name}]", [fam], phase_pmmh_model, name, obs, k)
    on_main_path("abc", ["sir"], phase_abc)
    on_main_path("resume", ["sir"], phase_resume, model, obs, y)
    on_main_path("cli-production", ["sir"], phase_cli_production, *prod)
    on_main_path("cli-resume", ["sir"], phase_cli_resume)
    for name in CLI_MODEL_PRESETS:
        on_main_path(f"cli-models[{name}]", ["sir"], phase_cli_model, name)
    on_main_path("cli-extras", ["sir"], phase_cli_extras)
    on_main_path("cli-abc", ["sir"], phase_cli_abc)
    on_main_path("cli-sweep", ["sir"], phase_cli_sweep)
    on_main_path("app", ["sir"], phase_app)
    on_main_path("exact", ["sir", "sir_subgroups"], phase_exact)
    y_sirs, lat_sirs = _twin_data(sirs_model(), [POP - 20.0, 20.0, 0.0], SIRS_TRUTH, SEED + 90)
    on_main_path("user-models[pmmh]", ["generated"], phase_user_pmmh, obs, y_sirs)
    on_main_path("user-models[one-chain]", ["generated"], phase_user_one_chain, obs, y_sirs)
    on_main_path("user-models[abc]", ["generated"], phase_user_abc, lat_sirs)
    on_main_path("user-models[k=12 filter]", ["generated"], phase_user_k12, obs)
    on_main_path("user-models[competing]", ["plain"], phase_user_competing, obs)
    on_main_path("repro", ["sir", "seir", "sir_subgroups"], phase_repro)
    on_main_path("bench", ["sir"], phase_bench)
    on_main_path("insitu", ["sir"], phase_insitu)
    on_main_path("large-regime", ["sir"], phase_large_regime)
    on_main_path("studies", ["sir", "generated"], phase_studies)
    timed("dist-chains", phase_dist_chains, model, obs, y)
    timed("dist-particles", phase_dist_particles, model, obs, y)
    timed("dist-nccl", phase_dist_nccl, model, obs, y)
    timed("cli-multihost", phase_cli_multihost)
    timed("multichip[1 card]", phase_multichip)
    routes = {name: {"hand": sum(p.get(f, 0) for f in tauleap_cuda.FAMILIES),
                     "generated": p.get("generated", 0), "plain": p.get("plain", 0),
                     "obs_weight": p.get("obs_weight", 0), "pf_loglik": p.get("pf_loglik", 0),
                     "pf_resample": p.get("pf_resample", 0)}
              for name, p in PATH_LAUNCHES.items()}
    print(f"routes: launches (plain: calls of the twin on the card; obs_weight: the "
          f"weighting kernel's; pf_loglik: the likelihood-update kernel's; pf_resample: the "
          f"resampling kernel's) per main path: {json.dumps(routes)}", flush=True)
    print(f"phase seconds (host clock): {json.dumps(PHASE_SECONDS)}", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s on {smi}", flush=True)
    hand = [hand_entry("obs_binomial_kernel", "obs_weight", "epitpu_torch/csrc/obs_binomial.cu",
                       weight),
            hand_entry("loglik_kernel", "pf_loglik", "epitpu_torch/csrc/pf_loglik.cu", loglik),
            hand_entry("resample_kernel", "pf_resample", "epitpu_torch/csrc/pf_resample.cu",
                       resample)]
    print(json.dumps({"kernels": kernel_entries(rows) + hand, "routes": routes,
                      "seir_cell": seir_cell}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        sys.exit(main())
