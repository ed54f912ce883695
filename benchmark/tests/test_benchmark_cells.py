"""Each cell, cut to a tiny size, runs through the program's CPU path; the
reference agrees with it there, the result line has the contract's keys,
and a run breaks when the program underneath is broken."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark.run import Catalog, run_cell

from .conftest import SEED, TINY

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_on_the_cpu_and_the_reference_agrees(cell, trace):
    result = run_cell(cell, SEED, 0.3, bool(trace), "cpu", traffic_overrides=TINY[cell])
    assert set(result) == KEYS | ({"breakdown"} if trace else set())
    assert list(result)[-1] == "checks"  # the numbers compared come last
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0.0 for c in result["checks"].values())
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"  # never a device metric from a CPU run
    if trace:
        assert not any(m.endswith("roofline.pmmh") or m.endswith("roofline.abc")
                       for m in result["metrics"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # every end-to-end metric on the host's clock; one taken from the
        # device's trace is never read from a CPU run
        catalog = Catalog()
        e2e = {m["name"]: m["source"] for m in catalog.metrics(catalog.cell(cell), False)}
        assert "setup_s" in result["metrics"]
        assert set(result["metrics"]) == {n for n, src in e2e.items() if src == "host_clock"}
    json.dumps(result)


# --- faults planted under the harness: each must make `correct` false -------

def _pmmh_fault(kind):
    def hook(driver):
        call = driver.call

        def broken(**kw):
            res = call(**kw)
            if kw.get("init_state") is None:  # the warm-up's init call stays sound
                return res
            thetas = res.thetas.clone()
            if kind == "unchanged":  # the step returns the state it was given
                thetas[:] = kw["init_state"].theta[:, None]
            elif kind == "half":  # half of the chains left out of the step
                half = thetas.shape[0] // 2
                thetas[half:] = kw["init_state"].theta[half:, None]
            else:  # an answer altered where it is produced
                thetas = thetas + 1e-3
            return dataclasses.replace(res, thetas=thetas)

        driver.call = broken
    return hook


def _abc_fault(kind):
    def hook(driver):
        call = driver.call

        def broken(seed):
            res = call(seed)
            n = res.trajectories.shape[0]
            if kind == "unchanged":  # the candidates' initial states returned unsimulated
                trajs = np.repeat(res.trajectories[:, :1], res.trajectories.shape[1], axis=1)
            elif kind == "half":  # half of the samples left out, the rest repeated
                trajs = np.concatenate([res.trajectories[: (n + 1) // 2]] * 2)[:n]
                res.posterior = {k: np.concatenate([v[: (n + 1) // 2]] * 2)[:n]
                                 for k, v in res.posterior.items()}
            else:  # an answer altered where it is produced
                trajs = res.trajectories + 1.0
            res.trajectories = trajs
            return res

        driver.call = broken
    return hook


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_broken_program_is_not_correct(cell, kind):
    fault = _abc_fault if cell.startswith("sir_abc") else _pmmh_fault
    overrides = dict(TINY[cell])
    if cell.startswith("sir_abc"):
        overrides["n_samples"] = 8
    result = run_cell(cell, SEED, 0.3, False, "cpu", traffic_overrides=overrides,
                      driver_hook=fault(kind))
    assert not result["correct"], result["checks"]


def test_the_control_fails_where_the_program_passes():
    """The reference in bfloat16, put in the program's place, reads past
    every cell's limit on some number; the program itself reads 0."""
    from benchmark.control import readings
    from benchmark.run import Catalog

    catalog = Catalog()
    for cell in sorted(TINY):
        limits = catalog.traffic(catalog.cell(cell))["limits"]
        for seed, sound, control in readings(cell, [SEED], 0.2, "cpu", TINY[cell], catalog):
            assert all(sound[k] <= limits[k] for k in limits), (cell, sound)
            assert any(control[k] > limits[k] for k in limits), (cell, control)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_fails_on_the_card_at_the_cells_size(cell, card):
    """The control at the cell's own size on three seeds, on the card."""
    from benchmark.control import readings
    from benchmark.run import Catalog

    catalog = Catalog()
    limits = catalog.traffic(catalog.cell(cell))["limits"]
    for seed, sound, control in readings(cell, [11, 12, 13], 3.0, card, None, catalog):
        assert all(sound[k] <= limits[k] for k in limits), (cell, seed, sound)
        assert any(control[k] > limits[k] for k in limits), (cell, seed, control)
    torch.cuda.empty_cache()
