"""epitpu's multi-chip contract on cards -> MULTICHIP_torch.json.

    python3 multichip_torch.py --cards 4                  # one rank a card, NCCL (the record)
    python3 multichip_torch.py --gloo 2 --device cuda --tiny --out X.json   # ranks sharing card 0
    python3 multichip_torch.py --gloo 4 --device cpu --tiny --out X.json    # CPU rehearsal

``__graft_entry__.dryrun_multichip(n)`` through ``epitpu_torch.dist``, one
process a rank (``--child``), plus the port's own rule: a gathered sharded
run equals the unsharded run bit for bit.  With ``--cards n`` every rank
joins through ``initialize_multihost`` (torchrun's variables, a free port on
localhost), is bound to card ``LOCAL_RANK`` and lays its meshes over NCCL;
fewer than n visible cards raise, nothing falls back to gloo or fewer ranks.
``--gloo n`` joins n ranks through a ``FileStore`` over gloo, all on
``--device`` (the CPU, or card 0 shared).  In order, every rank:

1. runs the dryrun as epitpu's (``__graft_entry__.py:65-180``): SIR binomial
   p = 0.1 on bench.py's data (T = 15), a (n/2 x 2) mesh, ``sharded_pmmh``
   over 2 chains a chain shard, 3 iterations, 512 particles a chain,
   ``steps_per_unit=4``, adaptive from 1, ``n_init_attempts=2``, with
   ``return_shard_check``, pooled and unpooled; then a 1 x n particle-sharded
   filter at 512 particles a shard;
2. runs the three gathered runs, each timed after a warm-up segment:
   ``production`` (the preset's chains split n x 1, 2,048 a card, N = 16),
   ``bench`` (bench.py's 32 chains x 4,096 particles split 1 x n, 20
   substeps, paths) and ``mesh`` (the (n/2 x 2) mesh, pooled adaptive, paths);
3. reports its card (current device, PCI bus id, ``nvidia-smi``'s name and
   power limit), the backend of every group it joined, its tau-leap kernel
   launches and the lane maps its launches took, and the time each run
   spent in ``all_gather_cat`` (CUDA events) by site: the filter's gathers
   (every filter step), the paths' and the chains' (every row).

The parent then holds the dryrun to epitpu's checks (every particle shard of
a chain the same chain; pooled != unpooled; the 1 x n filter's logZ within
5.0 of an unsharded filter of 512 x n particles), runs each gathered run
unsharded on its own device (rank 0's card) and requires every rank's
gathered thetas, log-likelihoods and paths to equal it bit for bit.  The
last line is ``{"ok": true, "cards": n}``.  A rank that hangs past
``CHILD_TIMEOUT`` is killed and fails the run, with each rank's last phase.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = "MULTICHIP_torch.json"
CHILD_TIMEOUT = 900  # seconds for all ranks of a spawn
COLLECTIVE_TIMEOUT = 300  # seconds, each collective (init_process_group's timeout)
LOGZ_BOUND = 5.0  # __graft_entry__.py:177
THETA = (2.0, 1.0)
SEED = 20261017
DRYRUN = dict(n_iters=3, n_particles=512, steps_per_unit=4, adaptive=True, adapt_start=1,
              n_init_attempts=2)
DRYRUN_FILTER_PARTICLES = 512  # a shard
RUNS = ("production", "bench", "mesh")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The gathered runs' shapes: chains (the production preset's a rank),
    particles a chain (global), rows; bench.py's substeps."""

    prod_chains_per_rank: int = 2048
    prod_particles: int = 16
    bench_chains: int = 32
    bench_particles: int = 4096
    bench_steps: int = 20
    mesh_chains: int = 32
    mesh_particles: int = 2048
    rows: int = 40
    warm_rows: int = 4


FULL = Sizes()
TINY = Sizes(prod_chains_per_rank=4, bench_chains=4, bench_particles=64, bench_steps=4,
             mesh_chains=4, mesh_particles=32, rows=20, warm_rows=2)


class MultichipError(RuntimeError):
    """A check of the multi-chip contract failed."""


def require(cond, msg):
    if not cond:
        raise MultichipError(msg)


def mesh_shape(world, axis):
    """(chain shards, particle shards) of a run over ``world`` ranks:
    "chain" n x 1, "particle" 1 x n, "both" epitpu's (n/2 x 2) (n x 1 for
    an odd n)."""
    if axis == "chain":
        return world, 1
    if axis == "particle":
        return 1, world
    half = 2 if world % 2 == 0 and world > 1 else 1
    return world // half, half


def workloads(world, sizes: Sizes, device):
    """name -> (mesh axis, data y, ``particle_mcmc_chains`` keywords) of the
    three gathered runs."""
    from bench_torch import dataset
    from epitpu_torch.cli.run import PRESETS, generate_dataset, pmmh_arguments
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model

    cfg = PRESETS["production"]()
    cfg.seed = SEED
    cfg.mcmc.n_chains = sizes.prod_chains_per_rank * world
    cfg.mcmc.n_iters = sizes.rows
    cfg.mcmc.n_particles = sizes.prod_particles
    cfg.mcmc.auto_particles = None  # N fixed at 16, the preset's self-sized value
    y_prod = torch.from_numpy(generate_dataset(cfg)[0]).to(device)
    prod_kw, _ = pmmh_arguments(cfg, sir_model(), get_observation_model("binomial"), y_prod,
                                device)
    y = torch.as_tensor(dataset(), device=device)
    common = dict(parameters=list(THETA), device=device, n_iters=sizes.rows, obs_param=0.1,
                  n_population=4820, mu=20.0, n_init_attempts=2, sampler="fast_rbg",
                  resample_every=4)
    bench_kw = dict(common, h=0.05, seed=SEED + 1, n_chains=sizes.bench_chains,
                    n_particles=sizes.bench_particles, steps_per_unit=sizes.bench_steps)
    mesh_kw = dict(common, h=0.6, seed=SEED + 2, n_chains=sizes.mesh_chains,
                   n_particles=sizes.mesh_particles, steps_per_unit=sizes.bench_steps,
                   adaptive=True, adapt_start=sizes.rows // 4, pooled_adaptation=True,
                   store_trajectories=True)
    return {"production": ("chain", y_prod, prod_kw), "bench": ("particle", y, bench_kw),
            "mesh": ("both", y, mesh_kw)}


def dryrun_data(device):
    """``__graft_entry__._dataset(t_max=14)``: bench.py's observations."""
    from bench_torch import dataset

    return torch.as_tensor(dataset(), device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---- one rank ---------------------------------------------------------------

# where a gather is called from: the filter's gathers come every filter step
# (log-weights, the cloud), the paths' every row (hidden, ancestry, terminal
# weights), the rest (pmmh's chain gathers, pooled adaptation) every row
GATHER_SITES = {"filter.py": "filter", "paths.py": "paths"}


def _gather_site():
    """The site of the ``all_gather_cat`` being called: the first caller
    outside ``dist/mesh.py``."""
    frame = sys._getframe(2)
    while frame is not None and frame.f_code.co_filename.endswith(os.path.join("dist", "mesh.py")):
        frame = frame.f_back
    return GATHER_SITES.get(os.path.basename(frame.f_code.co_filename), "mcmc")


class GatherTimer:
    """Times every ``all_gather_cat`` while entered (CUDA events on the
    card, the host clock on the CPU), by its site (``GATHER_SITES``), and
    counts the bytes it returns."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans, self.bytes = {}, {}

    def __enter__(self):
        from epitpu_torch.dist import mesh as mesh_module

        self._module, self._gather = mesh_module, mesh_module.all_gather_cat

        def timed(t, group, dim=0):
            site = _gather_site()
            if self.cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = self._gather(t, group, dim)
                end.record()
                span = (start, end)
            else:
                t0 = time.perf_counter()
                out = self._gather(t, group, dim)
                span = 1e3 * (time.perf_counter() - t0)
            self.spans.setdefault(site, []).append(span)
            self.bytes[site] = self.bytes.get(site, 0) + out.numel() * out.element_size()
            return out

        mesh_module.all_gather_cat = timed
        return self

    def __exit__(self, *exc):
        self._module.all_gather_cat = self._gather

    def ms(self):
        """site -> milliseconds in its gathers."""
        if self.cuda:
            torch.cuda.synchronize()
        return {site: sum(s[0].elapsed_time(s[1]) if self.cuda else s for s in spans)
                for site, spans in self.spans.items()}

    def counts(self):
        return {site: len(spans) for site, spans in self.spans.items()}


class LaneMaps:
    """Records the lane map of every tau-leap launch while entered."""

    def __enter__(self):
        from epitpu_torch.ops import tauleap_cuda

        self.seen, self._simulate = set(), tauleap_cuda.simulate_lanes
        signature = inspect.signature(self._simulate)

        def recording(*args, **kwargs):
            lane_map = signature.bind(*args, **kwargs).arguments.get("lane_map")
            self.seen.add(tuple(int(v) for v in lane_map) if lane_map is not None else None)
            return self._simulate(*args, **kwargs)

        tauleap_cuda.simulate_lanes = recording
        return self

    def __exit__(self, *exc):
        from epitpu_torch.ops import tauleap_cuda

        tauleap_cuda.simulate_lanes = self._simulate


def card_identity(device):
    """This rank's card: the current CUDA device, its UUID and PCI bus id as
    CUDA gives them, and ``nvidia-smi``'s name and power limit of the card
    with that UUID (of that index, where torch gives no UUID)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"current_device": None, "cuda_uuid": None, "pci_bus_id": None, "card": "cpu"}
    index = torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    uuid = str(getattr(props, "uuid", "") or "").removeprefix("GPU-") or None
    rows = [line.split(", ") for line in subprocess.run(
        ["nvidia-smi", "--query-gpu=index,uuid,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()]
    row = next(r for r in rows if (r[1].removeprefix("GPU-") == uuid if uuid
                                   else r[0] == str(index)))
    pci = tuple(getattr(props, f"pci_{k}_id", None) for k in ("domain", "bus", "device"))
    return {"current_device": index, "cuda_uuid": uuid,
            "pci_bus_id": None if None in pci else "{:08X}:{:02X}:{:02X}.0".format(*pci),
            "card": ", ".join(row[2:4])}


def _group_backends(prefix, mesh):
    import torch.distributed as dist

    return {f"{prefix}.{axis}": dist.get_backend(group)
            for axis, group in (("chain", mesh.chain_group), ("particle", mesh.particle_group))
            if group is not None}


def _rows(res):
    return (res.thetas.cpu().numpy(), res.log_likelihoods.cpu().numpy(),
            res.sampled_trajs.cpu().numpy())


def child_main(job_path):
    """One rank: join, run the dryrun and the three gathered runs, write
    ``rank{r}.json`` (the report) and ``rank{r}.npz`` (gathered arrays)."""
    import torch.distributed as dist

    from epitpu_torch.dist import (gather_result, initialize_multihost, make_mesh,
                                   sharded_particle_filter, sharded_pmmh)
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model
    from epitpu_torch.ops import _build

    with open(job_path) as f:
        job = json.load(f)
    rank, world, backend = job["rank"], job["world"], job["backend"]
    sizes = Sizes(**job["sizes"])
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT)

    def phase(name):
        print(f"[rank {rank}] {name} at {time.perf_counter() - t_start:.1f} s", flush=True)

    t_start = time.perf_counter()
    if backend == "nccl":
        require(initialize_multihost(timeout=timeout), f"rank {rank}: the group did not form")
        device = None  # make_mesh's default: cuda:$LOCAL_RANK
    else:
        if job["device"] == "cpu":
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{job['store']}",
                                world_size=world, rank=rank, timeout=timeout)
        device = job["device"]
    require(dist.get_world_size() == world and dist.get_rank() == rank,
            f"rank {rank}: joined as {dist.get_rank()} of {dist.get_world_size()}")
    mesh_backend = None if backend == "nccl" else "gloo"
    phase("joined")
    model, obs = sir_model(), get_observation_model("binomial")
    report = {"rank": rank, "world": world, "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
              "world_backend": dist.get_backend_config(), "backends": {}, "runs": {},
              "dryrun": {}}
    arrays = {}
    meshes = {}
    with LaneMaps() as lane_maps:
        # 1. the dryrun, as epitpu's
        for axis in ("both", "particle"):
            meshes[axis] = make_mesh(*mesh_shape(world, axis), device=device,
                                     backend=mesh_backend)
            meshes[axis].connect()
            report["backends"].update(_group_backends(axis, meshes[axis]))
        mesh = meshes["both"]
        device = mesh.device
        report.update(card_identity(device), mesh_device=str(device))
        y = dryrun_data(device)
        for pooled in (True, False):
            tag = "pooled" if pooled else "unpooled"
            shard, per_shard = sharded_pmmh(
                mesh, model, obs, SEED + 3, y, list(THETA), 0.05, 2 * mesh.n_chain_shards,
                pooled_adaptation=pooled, return_shard_check=True, device=device, **DRYRUN)
            report["dryrun"][f"{tag}_replicated"] = bool((per_shard == per_shard[:1]).all())
            report["shard_check_shape"] = list(per_shard.shape)
            arrays[f"dryrun.{tag}.thetas"] = gather_result(shard, mesh).thetas.cpu().numpy()
            arrays[f"dryrun.{tag}.per_shard"] = mesh.gather_chains(per_shard, dim=1).cpu().numpy()
            arrays[f"dryrun.{tag}.offset"] = np.int64(shard.chain_offset)
            phase(f"dryrun pmmh {tag}")
        f = sharded_particle_filter(meshes["particle"], model, obs, SEED + 4, y, list(THETA),
                                    0.1, DRYRUN_FILTER_PARTICLES * world, steps_per_unit=4,
                                    record_history=False)
        arrays["dryrun.logz"] = gather_result(f, meshes["particle"]).log_likelihood.cpu().numpy()
        phase("dryrun filter")

        # 2. the gathered runs, each timed after a warm-up segment
        meshes["chain"] = make_mesh(*mesh_shape(world, "chain"), device=device,
                                    backend=mesh_backend)
        meshes["chain"].connect()
        report["backends"].update(_group_backends("chain", meshes["chain"]))
        for name, (axis, y_run, kw) in workloads(world, sizes, device).items():
            mesh = meshes[axis]
            kw = dict(kw)
            head = [kw.pop(k) for k in ("seed", "parameters", "h", "n_chains")]
            sharded_pmmh(mesh, model, obs, head[0], y_run, *head[1:],
                         segment_len=sizes.warm_rows, **kw).result.thetas.cpu()
            dist.barrier()
            _sync(device)
            with GatherTimer(device) as gathers:
                t0 = time.perf_counter()
                shard = sharded_pmmh(mesh, model, obs, head[0], y_run, *head[1:], **kw)
                _sync(device)
                seconds = time.perf_counter() - t0
            gathered = gather_result(shard, mesh)
            arrays.update({f"{name}.{k}": v for k, v in zip(
                ("thetas", "log_likelihoods", "sampled_trajs"), _rows(gathered))})
            report["runs"][name] = {
                "mesh": [mesh.n_chain_shards, mesh.n_particle_shards],
                "seconds": seconds, "chain_offset": shard.chain_offset,
                "particle_offset": mesh.particle_index * kw["n_particles"]
                // mesh.n_particle_shards,
                "gathers": gathers.counts(), "gather_ms": gathers.ms(),
                "gather_bytes": gathers.bytes,
                "filter_steps": sizes.rows * (y_run.shape[0] - 1),
            }
            phase(f"run {name} ({seconds:.3f} s)")
    _sync(device)
    report["launches"] = dict(_build.LAUNCHES)  # this process's: the worker starts at 0
    report["lane_maps"] = sorted(m for m in lane_maps.seen if m is not None)
    report["identity_launches"] = None in lane_maps.seen
    if device.type == "cuda":
        report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    with open(os.path.join(job["dir"], f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    np.savez(os.path.join(job["dir"], f"rank{rank}.npz"), **arrays)
    dist.barrier()
    dist.destroy_process_group()
    phase("done")


# ---- the parent ---------------------------------------------------------------

def _tail(path, n=3000):
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def spawn(world, backend, device, sizes: Sizes, out_dir, timeout=CHILD_TIMEOUT):
    """Run ``world`` ranks of this script (``--child``) and wait for all,
    at most ``timeout`` seconds; a rank that fails or hangs kills the rest
    and raises with every rank's log tail.  Returns (reports, arrays), one
    of each a rank."""
    from epitpu_torch.dist import free_port

    env = {k: v for k, v in os.environ.items()
           if k not in ("EPITPU_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                        "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=HERE + os.pathsep + env.get("PYTHONPATH", ""),
               CUDA_DEVICE_ORDER="PCI_BUS_ID")
    if backend == "nccl":
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(world))
    elif torch.device(device).type == "cpu":
        env.update(OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for rank in range(world):
            job = {"rank": rank, "world": world, "backend": backend, "device": str(device),
                   "sizes": dataclasses.asdict(sizes), "dir": str(out_dir),
                   "store": os.path.join(out_dir, "store")}
            path = os.path.join(out_dir, f"rank{rank}.job.json")
            with open(path, "w") as f:
                json.dump(job, f)
            logs.append(os.path.join(out_dir, f"rank{rank}.log"))
            rank_env = dict(env, RANK=str(rank), LOCAL_RANK=str(rank)) if backend == "nccl" \
                else env
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(HERE, "multichip_torch.py"), "--child", path],
                    env=rank_env, cwd=HERE, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            late = time.monotonic() > deadline
            if failed or late:
                why = (f"rank(s) {failed} exited {[procs[r].returncode for r in failed]}"
                       if failed else f"ranks still running after {timeout} s")
                raise MultichipError(f"{world} ranks over {backend}: {why}\n" + "\n".join(
                    f"--- rank {r} ---\n{_tail(p)}" for r, p in enumerate(logs)))
            time.sleep(0.2)
        for r, p in enumerate(procs):
            require(p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n"
                                       f"{_tail(logs[r])}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports, arrays = [], []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            arrays.append(dict(z))
    return reports, arrays


def check_ranks(reports, backend, distinct_cards):
    """Each rank's proof of where it ran: every group on ``backend``, the
    tau-leap kernel launched on every rank (on a card), and with
    ``distinct_cards`` each rank on its own card (current device its
    LOCAL_RANK, distinct PCI bus ids)."""
    for rep in reports:
        r = rep["rank"]
        require(rep["backends"] and all(b == backend for b in rep["backends"].values()),
                f"rank {r}: groups on {rep['backends']}, not all {backend}")
        if rep["current_device"] is not None:
            require(rep["launches"].get("sir", 0) > 0, f"rank {r} never launched the kernel")
    if distinct_cards:
        for rep in reports:
            require(rep["current_device"] == rep["local_rank"],
                    f"rank {rep['rank']} on device {rep['current_device']}, "
                    f"LOCAL_RANK {rep['local_rank']}")
        for key in ("pci_bus_id", "cuda_uuid"):
            ids = [rep[key] for rep in reports if rep[key] is not None]
            require(len(set(ids)) == len(ids) and (key == "cuda_uuid" or len(ids) == len(reports)),
                    f"ranks share a card: {key} {ids}")


def check_dryrun(arrays, world):
    """epitpu's dryrun checks on every rank's gathered arrays: finite
    thetas of shape (2 n_chain, 3, 2); every particle shard of a chain the
    same chain, bit for bit, and equal to the gathered chain; pooling
    changes the chains."""
    n_chain, n_particle = mesh_shape(world, "both")
    for r, arr in enumerate(arrays):
        for tag in ("pooled", "unpooled"):
            th, ps = arr[f"dryrun.{tag}.thetas"], arr[f"dryrun.{tag}.per_shard"]
            require(th.shape == (2 * n_chain, DRYRUN["n_iters"], 2) and np.isfinite(th).all(),
                    f"rank {r} {tag}: thetas {th.shape}, finite {np.isfinite(th).all()}")
            require(ps.shape == (n_particle,) + th.shape, f"rank {r} {tag}: per_shard {ps.shape}")
            require(np.array_equal(ps, np.broadcast_to(ps[:1], ps.shape)),
                    f"rank {r} {tag}: chain state diverged across particle shards")
            require(np.array_equal(ps[0], th), f"rank {r} {tag}: shard check != the chains")
        require(not np.array_equal(arr["dryrun.pooled.thetas"], arr["dryrun.unpooled.thetas"]),
                f"rank {r}: pooled adaptation had no effect on the proposal covariance")


def unsharded_logz(world, device):
    """The dryrun filter's seed and particles, unsharded."""
    from epitpu_torch.dist import filter_streams
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model
    from epitpu_torch.smc import particle_filter

    stream, gen = filter_streams(SEED + 4, device)
    theta = torch.tensor([THETA], device=device)
    return particle_filter(sir_model(), get_observation_model("binomial"),
                           dryrun_data(device), theta, 0.1, stream, gen,
                           n_particles=DRYRUN_FILTER_PARTICLES * world, n_population=4820,
                           mu=20.0, steps_per_unit=4,
                           record_history=False).log_likelihood.cpu().numpy()


def unsharded_run(workload, sizes: Sizes):
    """(thetas, log-likelihoods, paths) of a gathered run's ``workload``
    unsharded on its device, and its seconds after a warm-up segment."""
    from epitpu_torch.mcmc import particle_mcmc_chains
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model

    _, y, kw = workload
    device = kw["device"]
    model, obs = sir_model(), get_observation_model("binomial")
    particle_mcmc_chains(model, obs, y, segment_len=sizes.warm_rows, **kw).thetas.cpu()
    _sync(device)
    t0 = time.perf_counter()
    res = particle_mcmc_chains(model, obs, y, **kw)
    _sync(device)
    return _rows(res), time.perf_counter() - t0


def check_identical(label, got, want):
    """Gathered thetas, log-likelihoods and paths equal the unsharded
    run's, bit for bit."""
    for what, g, w in zip(("thetas", "log-likelihoods", "paths"), got, want):
        require(g.shape == w.shape, f"{label}: {what} {g.shape} vs {w.shape}")
        same = g == w
        require(bool(same.all()), f"{label}: {what} differ from the unsharded run in "
                                  f"{int(same.size - same.sum())} of {same.size} values")


def run(world, backend, device, sizes: Sizes, distinct_cards):
    """Spawn the ranks, check them, run every gathered run unsharded on
    ``device`` and compare; returns the record."""
    from epitpu_torch.ops import _build

    device = torch.device(device)
    if device.type == "cuda":
        _build.build()  # once, before the ranks load it
    with tempfile.TemporaryDirectory(prefix="epitpu_multichip_") as d:
        t0 = time.perf_counter()
        reports, arrays = spawn(world, backend, device, sizes, d)
        spawn_s = time.perf_counter() - t0
    check_ranks(reports, backend, distinct_cards)
    check_dryrun(arrays, world)
    want_logz = unsharded_logz(world, device)
    for r, arr in enumerate(arrays):
        got = arr["dryrun.logz"]
        require(np.isfinite(got).all() and abs(float(got[0] - want_logz[0])) < LOGZ_BOUND,
                f"rank {r}: sharded logZ {got} vs unsharded {want_logz}")
    n_chain, n_particle = mesh_shape(world, "both")
    record = {
        "script": "multichip_torch.py", "world": world, "backend": backend,
        "device": str(device), "sizes": dataclasses.asdict(sizes),
        "unsharded_on": card_identity(device), "host_cpus": len(os.sched_getaffinity(0)),
        "spawn_seconds": spawn_s,
        "dryrun": {
            "mesh": [n_chain, n_particle], "chains": 2 * n_chain, **DRYRUN,
            "replicated": all(all(rep["dryrun"].values()) for rep in reports),
            "pooled_differs": True,
            "filter_particles": DRYRUN_FILTER_PARTICLES * world,
            "sharded_logz": float(arrays[0]["dryrun.logz"][0]),
            "unsharded_logz": float(want_logz[0]),
            "logz_bit_for_bit": bool(np.array_equal(arrays[0]["dryrun.logz"], want_logz)),
            "logz_bound": LOGZ_BOUND,
        },
        "runs": {},
        "ranks": reports,
    }
    loads = workloads(world, sizes, device)
    for name in RUNS:
        want, seconds = unsharded_run(loads[name], sizes)
        for r, arr in enumerate(arrays):
            check_identical(f"{name} rank {r}",
                            tuple(arr[f"{name}.{k}"] for k in
                                  ("thetas", "log_likelihoods", "sampled_trajs")), want)
        chains, rows = want[0].shape[:2]
        slowest = max(rep["runs"][name]["seconds"] for rep in reports)
        ranks = [rep["runs"][name] for rep in reports]
        record["runs"][name] = {
            "cards": [rep["card"] for rep in reports],
            "unsharded_card": record["unsharded_on"]["card"],
            "mesh": ranks[0]["mesh"], "chains": chains, "rows": rows,
            "particles": loads[name][2]["n_particles"],
            "bit_for_bit": True,
            "slowest_rank_s": slowest, "iters_per_s": chains * rows / slowest,
            "unsharded_s": seconds, "unsharded_iters_per_s": chains * rows / seconds,
            "rank_seconds": [x["seconds"] for x in ranks],
            "gathers_rank0": ranks[0]["gathers"],
            "gather_ms_rank0": ranks[0]["gather_ms"],
            "gather_bytes_rank0": ranks[0]["gather_bytes"],
            # the filter's gathers only, over rows x (T - 1) filter steps
            "gather_ms_per_filter_step_rank0":
                ranks[0]["gather_ms"].get("filter", 0.0) / ranks[0]["filter_steps"],
            "gather_ms_per_row_rank0": {
                site: ms / rows for site, ms in ranks[0]["gather_ms"].items()
                if site != "filter"},
            "filter_steps": ranks[0]["filter_steps"],
        }
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    how = ap.add_mutually_exclusive_group(required=True)
    how.add_argument("--cards", type=int, help="one rank a card over NCCL, this many cards")
    how.add_argument("--gloo", type=int, help="this many ranks over gloo on --device")
    how.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cpu", help="--gloo's device: cpu or cuda (card 0)")
    ap.add_argument("--tiny", action="store_true", help="the gathered runs at test sizes")
    ap.add_argument("--out", help=f"the record (default {DEFAULT_OUT} for --cards)")
    args = ap.parse_args(argv)
    if args.child:
        child_main(args.child)
        return 0
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")  # card i = nvidia-smi's i
    sizes = TINY if args.tiny else FULL
    if args.cards is not None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.cards < 2 or visible < args.cards:
            raise RuntimeError(f"--cards {args.cards} needs at least 2 and at most the visible "
                               f"CUDA devices ({visible}); there is no fallback")
        world, backend, device = args.cards, "nccl", torch.device("cuda", 0)
        out = args.out or DEFAULT_OUT
    else:
        if args.gloo < 2:
            raise RuntimeError("--gloo needs at least 2 ranks")
        world, backend, device = args.gloo, "gloo", torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", 0)
        if args.out is None:
            ap.error("a --gloo run needs --out: the default is the four-card record")
        out = args.out
    record = run(world, backend, device, sizes, distinct_cards=args.cards is not None)
    with open(out, "w") as f:
        json.dump(record, f, indent=2)
    dr = record["dryrun"]
    print(f"[multichip] dryrun {dr['mesh'][0]} x {dr['mesh'][1]}: shards replicated, pooled "
          f"!= unpooled; 1 x {world} filter logZ {dr['sharded_logz']} vs unsharded "
          f"{dr['unsharded_logz']} (bit for bit: {dr['logz_bit_for_bit']})", flush=True)
    for rep in record["ranks"]:
        print(f"[multichip] rank {rep['rank']}: device {rep['current_device']} "
              f"bus {rep['pci_bus_id']} ({rep['card']}), groups {rep['backends']}, "
              f"launches {rep['launches']}, lane maps {rep['lane_maps']}", flush=True)
    for name, r in record["runs"].items():
        print(f"[multichip] {name} {r['mesh'][0]} x {r['mesh'][1]}, {r['chains']} chains x "
              f"{r['particles']} x {r['rows']} rows: == unsharded bit for bit; "
              f"{r['iters_per_s']} iters/s (slowest rank) vs {r['unsharded_iters_per_s']} "
              f"unsharded; gathers {r['gather_ms_per_filter_step_rank0']} ms a filter step, "
              f"{r['gather_ms_per_row_rank0']} ms a row outside the filter (rank 0)", flush=True)
    print(json.dumps({"ok": True, "cards": world}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
