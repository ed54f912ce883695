"""What a chain shard's row padding costs (``smc.filter.at_global_rows``: a
chain shard runs its ESS and resampling on every chain's rows, so that they
round as in the unsharded run; the likelihood update needs no padding).  A
helper script, not
collected by pytest:

    python3 tests/shard_padding_probe.py --device cuda --out X.json       # on a card
    python3 tests/shard_padding_probe.py --device cpu --tiny --out X.json # rehearsal

1. ``ops``: the padded row work of one filter step (systematic
   resampling of ``[chains, N]``) on a shard's rows alone and padded to
   every chain's rows, for 1, 2, 4 and 8 chain shards, at the production
   shape (2,048 chains a shard x 16) and at the 2 x 2 mesh's (16 chains a
   shard x 2,048): ms a step from CUDA events (the host clock on the CPU),
   the least and the median of ``BLOCKS`` blocks of ``REPS`` steps, the
   variants alternating; and the bytes of the padded tensor.
2. ``production``: ``multichip_torch.py``'s production run split 4 x 1 over
   four gloo ranks sharing ``--device``, timed with the padding and with
   ``at_global_rows`` replaced by the shard's rows alone (its draws then
   differ, so its chains are not compared), in the order padded, alone,
   alone, padded after a warm-up of each: the slowest rank's iters/s, the
   best of the two repeats.
"""
import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import multichip_torch as mc  # noqa: E402
from epitpu_torch.smc import filter as filt  # noqa: E402
from epitpu_torch.smc.resample import resample_particles  # noqa: E402

WORLD = 4
SHARDS = (1, 2, 4, 8)
REPS = 100  # steps a block
BLOCKS = 7  # blocks a variant, alternating
ORDER = ("padded", "alone", "alone", "padded")


def _alone(fn, t, c0, n_rows):
    return fn(t)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _block_ms(step, device, reps):
    """ms a step over ``reps`` steps: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    return 1e3 * (time.perf_counter() - t0) / reps


def op_times(device, shapes, reps, blocks):
    """shape -> shards -> {alone_ms, padded_ms, padded_bytes}: a filter
    step's row work on the last chain shard's rows, the two variants timed
    in alternating blocks of ``reps`` steps; the least and the median block."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    for label, (chains, n) in shapes.items():
        t = torch.randn(chains, n, device=device) * 3
        out[label] = {}
        for shards in SHARDS:
            c0, n_rows = (shards - 1) * chains, shards * chains
            steps = {}
            for variant, rows in (("alone", _alone), ("padded", filt.at_global_rows)):
                def step(rows=rows):
                    rows(lambda u: resample_particles("systematic", u, gen)[0], t, c0, n_rows)

                steps[variant] = step
                for _ in range(5):
                    step()
            _sync(device)
            times = {variant: [] for variant in steps}
            for _ in range(blocks):
                for variant, step in steps.items():
                    times[variant].append(_block_ms(step, device, reps))
            row = {"chains_per_shard": chains, "n": n,
                   "padded_bytes": n_rows * n * t.element_size()}
            for variant, ms in times.items():
                row[f"{variant}_ms"] = min(ms)
                row[f"{variant}_median_ms"] = sorted(ms)[len(ms) // 2]
            out[label][shards] = row
    return out


def child(job_path):
    """One rank of the production split: the run padded and alone."""
    import torch.distributed as dist

    from epitpu_torch.dist import make_mesh, sharded_pmmh
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model

    with open(job_path) as f:
        job = json.load(f)
    rank, device = job["rank"], torch.device(job["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['store']}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    sizes = mc.TINY if job["tiny"] else mc.FULL
    mesh = make_mesh(WORLD, 1, device=device, backend="gloo")
    mesh.connect()
    model, obs = sir_model(), get_observation_model("binomial")
    _, y, kw = mc.workloads(WORLD, sizes, device)["production"]
    kw = dict(kw)
    head = [kw.pop(k) for k in ("seed", "parameters", "h", "n_chains")]

    def run(variant, **extra):
        filt.at_global_rows = real if variant == "padded" else _alone
        dist.barrier()
        _sync(device)
        t0 = time.perf_counter()
        sharded_pmmh(mesh, model, obs, head[0], y, *head[1:], **kw, **extra).result.thetas.cpu()
        _sync(device)
        return time.perf_counter() - t0

    real = filt.at_global_rows
    for variant in ("padded", "alone"):
        run(variant, segment_len=sizes.warm_rows)
    seconds = {"padded": [], "alone": []}
    for variant in ORDER:
        seconds[variant].append(run(variant))
    with open(os.path.join(job["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(seconds, f)
    dist.barrier()
    dist.destroy_process_group()


def production(device, tiny, timeout=600):
    """The production split's slowest-rank seconds, padded and alone."""
    sizes = mc.TINY if tiny else mc.FULL
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="epitpu_padding_") as d:
        procs = []
        try:
            for rank in range(WORLD):
                path = os.path.join(d, f"rank{rank}.job.json")
                with open(path, "w") as f:
                    json.dump({"rank": rank, "device": str(device), "tiny": tiny, "dir": d,
                               "store": os.path.join(d, "store")}, f)
                procs.append(subprocess.Popen([sys.executable, __file__, "--child", path],
                                              env=env))
            deadline = time.monotonic() + timeout
            for p in procs:
                if p.wait(timeout=max(1.0, deadline - time.monotonic())) != 0:
                    raise RuntimeError(f"a rank exited {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for rank in range(WORLD):
            with open(os.path.join(d, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
    chains, rows = sizes.prod_chains_per_rank * WORLD, sizes.rows
    out = {"mesh": [WORLD, 1], "chains": chains, "particles": sizes.prod_particles, "rows": rows,
           "order": list(ORDER), "rank_seconds": ranks}
    for variant in ("padded", "alone"):
        slowest = [max(r[variant][k] for r in ranks) for k in range(2)]
        out[f"{variant}_slowest_rank_s"] = slowest
        out[f"{variant}_iters_per_s"] = chains * rows / min(slowest)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    if args.out is None:
        ap.error("--out is required")
    device = torch.device(args.device)
    if device.type == "cuda":
        from epitpu_torch.ops import _build

        device = torch.device("cuda", 0)
        _build.build()  # once, before the ranks load it
    shapes = {"production": (4, 16), "mesh": (2, 32)} if args.tiny else \
        {"production": (2048, 16), "mesh": (16, 2048)}
    record = {"script": "tests/shard_padding_probe.py", "device": str(device),
              "card": mc.card_identity(device)["card"],
              "ops": op_times(device, shapes, *((5, 2) if args.tiny else (REPS, BLOCKS))),
              "production": production(device, args.tiny)}
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    for label, by_shards in record["ops"].items():
        print(f"[padding] {label}: " + "; ".join(
            f"{s} shards {r['alone_ms']} -> {r['padded_ms']} ms a step (least) "
            f"({r['padded_bytes']} B padded)" for s, r in by_shards.items()), flush=True)
    p = record["production"]
    print(f"[padding] production {WORLD} x 1 ({p['chains']} chains x {p['particles']} x "
          f"{p['rows']} rows) on {record['card']}: padded {p['padded_iters_per_s']} iters/s, "
          f"alone {p['alone_iters_per_s']} iters/s (slowest rank, best of 2)", flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
