"""multichip_torch.py's checks on the CPU, and the two repairs that one
process a card needs.

One spawn of four gloo ranks (``multichip_torch.spawn``: a ``FileStore`` in
the test's temporary directory, the ranks under one timeout) runs the
script's children at its ``TINY`` sizes with ``device="cpu"``; the tests
hold what they gathered to the script's checks, to the unsharded runs made
here, and to epitpu's ``sharded_pmmh(..., return_shard_check=True)`` and
``sharded_particle_filter`` on the virtual CPU mesh (conftest's 8 devices).

The repairs, with ``torch.cuda`` and the process group faked:
``initialize_multihost`` binds the process to card ``LOCAL_RANK`` before it
joins (and refuses a local rank past the cards); the runner under
``--multihost`` runs on the rank's card, and only on the primary (rank 0),
so only the primary writes.
"""
import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import multichip_torch as mc
from epitpu_torch.dist import initialize_multihost

WORLD = 4
ENV_KEYS = ("EPITPU_COORDINATOR", "EPITPU_NUM_PROCESSES", "EPITPU_PROCESS_ID", "MASTER_ADDR",
            "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("multichip")
    return mc.spawn(WORLD, "gloo", "cpu", mc.TINY, str(d), timeout=300)


@pytest.fixture(scope="module")
def cpu_loads():
    return mc.workloads(WORLD, mc.TINY, torch.device("cpu"))


def test_dryrun_shards_replicated_and_pooling_changes_the_chains(ranks):
    reports, arrays = ranks
    mc.check_dryrun(arrays, WORLD)  # raises on a diverged shard or pooling without effect
    assert all(rep["dryrun"] == {"pooled_replicated": True, "unpooled_replicated": True}
               for rep in reports)
    for arr in arrays[1:]:
        for tag in ("pooled", "unpooled"):
            np.testing.assert_array_equal(arr[f"dryrun.{tag}.per_shard"],
                                          arrays[0][f"dryrun.{tag}.per_shard"])
    assert [int(a["dryrun.pooled.offset"]) for a in arrays] == [0, 0, 2, 2]


def test_shard_check_matches_epitpus(ranks):
    """epitpu's ``return_shard_check`` on a 2 x 2 mesh of the virtual CPU
    devices, the dryrun's arguments: the same global shape, each rank's
    slice of it, and the same invariant (every particle shard holds its
    chains' thetas)."""
    import jax
    import jax.numpy as jnp

    from epitpu.dist import make_mesh as jmake_mesh
    from epitpu.dist import sharded_pmmh as jsharded_pmmh
    from epitpu.models import sir_model as jsir
    from epitpu.observe import get_observation_model as jobs

    reports, arrays = ranks
    n_chain, n_particle = mc.mesh_shape(WORLD, "both")
    mesh = jmake_mesh(n_chain_shards=n_chain, n_particle_shards=n_particle,
                      devices=jax.devices()[:WORLD])
    res, per_shard = jsharded_pmmh(
        mesh, jsir(), jobs("binomial"), jax.random.PRNGKey(0),
        jnp.asarray(mc.dryrun_data("cpu").numpy()), jnp.array(mc.THETA), 0.05,
        n_chains_total=2 * n_chain, pooled_adaptation=True, return_shard_check=True,
        **mc.DRYRUN)
    want, want_th = np.asarray(per_shard), np.asarray(res.thetas)
    got, got_th = arrays[0]["dryrun.pooled.per_shard"], arrays[0]["dryrun.pooled.thetas"]
    assert got.shape == want.shape == (n_particle, 2 * n_chain, mc.DRYRUN["n_iters"], 2)
    for rep in reports:  # [p_shards, chains_local, rows, d]
        assert rep["shard_check_shape"] == [n_particle, 2, mc.DRYRUN["n_iters"], 2]
    for ps, th in ((want, want_th), (got, got_th)):
        assert np.array_equal(ps, np.broadcast_to(ps[:1], ps.shape))
        assert np.array_equal(ps[0], th)
        assert np.isfinite(ps).all() and (ps > 0).all()


def test_four_shard_filter_logz_within_epitpus_bound(ranks):
    """The 1 x 4 filter at 512 particles a shard: every rank's logZ equals
    the unsharded filter's of 2,048 particles (the port's rule) and lies
    within 5.0 of epitpu's ``sharded_particle_filter`` on four virtual CPU
    devices (``__graft_entry__.py:177``)."""
    import jax

    from epitpu.dist import make_mesh as jmake_mesh
    from epitpu.dist import sharded_particle_filter as jsharded
    from epitpu.models import sir_model as jsir
    from epitpu.observe import get_observation_model as jobs

    _, arrays = ranks
    want = mc.unsharded_logz(WORLD, "cpu")
    for arr in arrays:
        np.testing.assert_array_equal(arr["dryrun.logz"], want)
    mesh = jmake_mesh(n_chain_shards=1, n_particle_shards=WORLD, devices=jax.devices()[:WORLD])
    ref = float(jsharded(mesh, jsir(), jobs("binomial"), jax.random.PRNGKey(1),
                         mc.dryrun_data("cpu").numpy(), np.array(mc.THETA, np.float32), 0.1,
                         n_particles_total=mc.DRYRUN_FILTER_PARTICLES * WORLD,
                         steps_per_unit=4).log_likelihood)
    assert np.isfinite(ref) and abs(float(want[0]) - ref) < mc.LOGZ_BOUND, (want, ref)


@pytest.mark.parametrize("name", mc.RUNS)
def test_gathered_run_equals_unsharded(ranks, cpu_loads, name):
    reports, arrays = ranks
    want, _ = mc.unsharded_run(cpu_loads[name], mc.TINY)
    assert want[0].shape[:2] == (cpu_loads[name][2]["n_chains"], mc.TINY.rows)
    for r, arr in enumerate(arrays):
        mc.check_identical(f"{name} rank {r}", tuple(
            arr[f"{name}.{k}"] for k in ("thetas", "log_likelihoods", "sampled_trajs")), want)
    meshes = {"production": [WORLD, 1], "bench": [1, WORLD], "mesh": [2, 2]}
    assert all(rep["runs"][name]["mesh"] == meshes[name] for rep in reports)
    if name != "production":
        assert want[2].size  # paths compared too


def test_ranks_report_groups_and_the_lane_map_of_their_particle_offset(ranks, cpu_loads):
    reports, _ = ranks
    mc.check_ranks(reports, "gloo", distinct_cards=False)
    n_total = cpu_loads["bench"][2]["n_particles"]
    n_local = n_total // WORLD
    for rep in reports:
        r = rep["rank"]
        assert set(rep["backends"]) == {"both.chain", "both.particle", "particle.particle",
                                        "chain.chain"}
        assert rep["runs"]["bench"]["particle_offset"] == r * n_local
        assert [0, n_local, n_total, r * n_local] in rep["lane_maps"]
        assert not rep["identity_launches"]
        bench = rep["runs"]["bench"]
        assert set(bench["gathers"]) <= set(mc.GATHER_SITES.values()) | {"mcmc"}
        assert bench["gathers"]["filter"] > 0 and bench["gather_bytes"]["filter"] > 0
        assert set(bench["gather_ms"]) == set(bench["gathers"])


def _card_reports():
    return [{"rank": r, "local_rank": r, "current_device": r, "pci_bus_id": f"0000:{r}:00.0",
             "cuda_uuid": f"uuid-{r}", "backends": {"both.chain": "nccl", "chain.chain": "nccl"},
             "launches": {"sir": 10}} for r in range(WORLD)]


BREAKS = {
    "shared card": lambda reps: reps[3].update(pci_bus_id=reps[0]["pci_bus_id"]),
    "shared uuid": lambda reps: reps[2].update(cuda_uuid=reps[1]["cuda_uuid"]),
    "a gloo group": lambda reps: reps[1]["backends"].update({"chain.chain": "gloo"}),
    "no launch": lambda reps: reps[2].update(launches={"sir": 0}),
    "wrong device": lambda reps: reps[1].update(current_device=0),
}


@pytest.mark.parametrize("broken", [None, *BREAKS])
def test_check_ranks_refuses_ranks_not_on_their_own_card(broken):
    reps = _card_reports()
    if broken is None:
        mc.check_ranks(reps, "nccl", distinct_cards=True)
        return
    BREAKS[broken](reps)
    with pytest.raises(mc.MultichipError):
        mc.check_ranks(reps, "nccl", distinct_cards=True)


@pytest.mark.parametrize("available", [True, False])
def test_cards_refused_with_fewer_visible_cards(monkeypatch, available):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mc, "spawn", lambda *a, **k: pytest.fail("spawned ranks"))
    with pytest.raises(RuntimeError, match="visible CUDA devices"):
        mc.main(["--cards", "4"])


@pytest.mark.parametrize("schedule", [dict(resample_every=1), dict(resample_every=4),
                                      dict(resample_threshold=0.5)],
                         ids=["every step", "every 4th", "ess below half"])
def test_sharded_filter_reduces_at_the_unsharded_row_count(monkeypatch, schedule):
    """On the card the rounding of a torch row reduction or a row's
    cumulative sum follows the number of rows (found on four cards: the 2 x 2
    mesh's log-likelihoods differed from the unsharded run's in their last
    bits).  Here ``logsumexp``, ``cumsum`` and ``sum`` are made to round by
    row count (each resampling schedule), and each chain shard of a 2 x 1
    mesh (one process, no collective on that axis) must still give the
    unsharded filter's rows bit for bit.  The ``cumsum`` and ``sum`` patches
    guard the resampling's and the ESS's padding to the unsharded rows; the
    ``logsumexp`` patch no longer reaches ``pf_loglik``, whose update
    (``ops/loglik_cuda.py``) sums each row in an order fixed by N alone and
    pads nothing: ``tests/test_torch_loglik.py``'s row-independence tests
    stand in for it there."""
    from epitpu_torch.dist import Mesh, filter_streams
    from epitpu_torch.models import sir_model
    from epitpu_torch.observe import get_observation_model
    from epitpu_torch.smc import particle_filter

    n = 32

    def by_rows(real, scale):
        """``real``, its result scaled by the row count on ``[rows, N]``."""
        def fake(t, dim):
            out = real(t, dim)
            return out * (1.0 + scale * t.shape[0]) if t.shape[-1:] == (n,) else out
        return fake

    monkeypatch.setattr(torch, "logsumexp", by_rows(torch.logsumexp, 2.0 ** -12))
    monkeypatch.setattr(torch, "cumsum", by_rows(torch.cumsum, 2.0 ** -12))
    monkeypatch.setattr(torch, "sum", by_rows(torch.sum, 2.0 ** -3))
    theta = torch.tensor([[2.0, 1.0], [2.2, 0.9], [1.8, 1.1], [2.1, 1.0]])
    y = mc.dryrun_data("cpu")[:8]
    kw = dict(n_particles=n, n_population=4820.0, mu=20.0, steps_per_unit=2, **schedule)

    def run(mesh, rows):
        stream, gen = filter_streams(7, "cpu")
        return particle_filter(sir_model(), get_observation_model("binomial"), y, theta[rows],
                               0.1, stream, gen, mesh=mesh, **kw)

    want = run(None, slice(0, 4))
    for c in (0, 1):
        mesh = Mesh(2, 1, c, 0, None, None, torch.device("cpu"))
        got = run(mesh, slice(2 * c, 2 * c + 2))
        for f in ("log_likelihood", "log_zetas", "hidden", "ancestry"):
            assert torch.equal(getattr(got, f), getattr(want, f)[2 * c:2 * c + 2]), (c, f)


# ---- the repairs ---------------------------------------------------------------

def _fake_cards(monkeypatch, count, calls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(("init", kw)))
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: WORLD)


def _launcher_env(monkeypatch, how, rank):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    if how == "torchrun":
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("WORLD_SIZE", str(WORLD))
        monkeypatch.setenv("RANK", str(rank))
        return {"init_method": "env://"}
    monkeypatch.setenv("EPITPU_COORDINATOR", "localhost:8476")
    monkeypatch.setenv("EPITPU_NUM_PROCESSES", str(WORLD))
    monkeypatch.setenv("EPITPU_PROCESS_ID", str(rank))
    return {"init_method": "tcp://localhost:8476", "world_size": WORLD, "rank": rank}


@pytest.mark.parametrize("how", ["torchrun", "env triple"])
def test_initialize_multihost_binds_the_rank_to_its_card(monkeypatch, how):
    calls = []
    _fake_cards(monkeypatch, 4, calls)
    want = _launcher_env(monkeypatch, how, 2)
    timeout = datetime.timedelta(seconds=30)
    assert initialize_multihost(timeout=timeout) is True
    assert calls == [("set_device", 2),
                     ("init", dict(want, backend="cpu:gloo,cuda:nccl",
                                   device_id=torch.device("cuda", 2), timeout=timeout))]


def test_a_local_rank_past_the_cards_raises(monkeypatch):
    calls = []
    _fake_cards(monkeypatch, 4, calls)
    _launcher_env(monkeypatch, "torchrun", 4)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=4 but only 4"):
        initialize_multihost()
    assert calls == []  # neither wrapped onto card 0 nor joined


def test_without_cuda_the_join_is_unchanged(monkeypatch):
    calls = []
    _fake_cards(monkeypatch, 0, calls)
    want = _launcher_env(monkeypatch, "torchrun", 1)
    assert initialize_multihost() is True
    assert calls == [("init", want)]


def _fake_rank(monkeypatch, rank, cards, local_rank=None):
    """A joined group of WORLD ranks in which this process is ``rank``, on
    card ``local_rank`` (``rank`` by default)."""
    calls = []
    _fake_cards(monkeypatch, cards, calls)
    _launcher_env(monkeypatch, "torchrun", rank)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    return calls


def test_runner_multihost_runs_on_the_ranks_card(monkeypatch):
    from epitpu_torch.cli import run as runner

    calls = _fake_rank(monkeypatch, 0, 4, local_rank=3)
    seen = []
    monkeypatch.setattr(runner, "run_experiment", lambda cfg, **kw: seen.append(kw))
    runner.main(["--preset", "sir_underreported", "--multihost", "--no-plots"])
    assert calls[0] == ("set_device", 3)
    assert seen == [{"device": "cuda:3"}]
    seen.clear()
    runner.main(["--preset", "sir_underreported", "--multihost", "--no-plots",
                 "--device", "cuda:1"])
    assert seen[0]["device"] == "cuda:1"  # an explicit card stays as asked
    seen.clear()
    calls = _fake_rank(monkeypatch, 3, 4)
    assert runner.main(["--preset", "sir_underreported", "--multihost", "--no-plots"]) == 0
    assert calls[0] == ("set_device", 3) and seen == []  # bound and joined, then stopped


@pytest.mark.parametrize("rank", [0, 1])
def test_runner_multihost_only_the_primary_writes(monkeypatch, tmp_path, capsys, rank):
    from epitpu_torch.cli import main

    _fake_rank(monkeypatch, rank, 0)
    monkeypatch.chdir(tmp_path)
    main(["--preset", "sir_underreported", "--device", "cpu", "--no-plots", "--iters", "4",
          "--chains", "2", "--particles", "16", "--checkpoint-every", "2", "--multihost"])
    out = capsys.readouterr().out
    written = sorted(os.path.relpath(os.path.join(root, f), tmp_path)
                     for root, _, files in os.walk(tmp_path) for f in files)
    if rank == 0:
        assert "data/sir_underreported/checkpoint.npz" in written
        assert "data/sir_underreported/run2/thetas.csv" in written
        assert '"iters_total": 8' in out
    else:
        assert written == [] and out == ""


def test_committed_four_card_record():
    """``MULTICHIP_torch.json`` comes from ``--cards 4``: four ranks, each
    on its own card over NCCL with the kernel launched, every gathered run
    equal to its unsharded run, and a card beside every run's numbers."""
    import json

    with open(os.path.join(mc.HERE, mc.DEFAULT_OUT)) as f:
        rec = json.load(f)
    assert rec["world"] == WORLD and rec["backend"] == "nccl"
    mc.check_ranks(rec["ranks"], "nccl", distinct_cards=True)
    assert rec["dryrun"]["replicated"] and rec["dryrun"]["logz_bit_for_bit"]
    assert set(rec["runs"]) == set(mc.RUNS)
    for run in rec["runs"].values():
        assert run["bit_for_bit"] and len(run["cards"]) == WORLD
        assert all(c.startswith("NVIDIA") for c in run["cards"] + [run["unsharded_card"]])
        assert run["iters_per_s"] > 0 and run["unsharded_iters_per_s"] > 0
