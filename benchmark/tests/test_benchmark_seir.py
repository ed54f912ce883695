"""The SEIR cell, ``seir_binomial.chains2048``: cut to 8 chains x 8 particles
it runs through the program's CPU path and the reference agrees; a planted
fault is not ``correct``, nor is the bfloat16 control; its data is the
runner's ``seir_underreported`` data; the plain reference model is the
program's, bit for bit; its driver counts K4's bound at SEIR's rate
operations; a program without K4's draw-slot counters is refused before any
work; and the idle-thread metric reads the counters."""
from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from benchmark import roofline, spans
from benchmark.drivers import pmmh, pmmh_rates
from benchmark.reference import model_seir
from benchmark.run import Catalog, run_cell

from .conftest import SEED

CELL = "seir_binomial.chains2048"
TINY = {"chains": 8, "particles": 8, "warmup_rows": 20, "segment_len": 4, "check_rows": 3,
        "trace_segments": 1}


@pytest.fixture(scope="module")
def catalog():
    return Catalog()


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu_and_the_reference_agrees(trace):
    result = run_cell(CELL, SEED, 0.3, bool(trace), "cpu", traffic_overrides=TINY)
    assert result["correct"], result["checks"]
    assert result["checks"] == {"row_mismatch_pct": {"value": 0.0, "limit": 2.0}}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    if trace:
        # the CPU's twin launches no K4, so no slot is counted and no
        # device metric is read
        assert "k4_idle_thread_pct" not in result["metrics"]
        assert "k4_roofline.pmmh" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"setup_s"}
    json.dumps(result)


def _fault(kind):
    def hook(driver):
        call = driver.call

        def broken(**kw):
            res = call(**kw)
            if kw.get("init_state") is None:  # the warm-up's init call stays sound
                return res
            if kind == "theta":
                return dataclasses.replace(res, thetas=res.thetas + 1e-3)
            return dataclasses.replace(res, log_likelihoods=res.log_likelihoods * 1.01)

        driver.call = broken
    return hook


@pytest.mark.parametrize("kind", ["theta", "log_likelihood"])
def test_an_altered_answer_is_not_correct(kind):
    result = run_cell(CELL, SEED, 0.3, False, "cpu", traffic_overrides=TINY,
                      driver_hook=_fault(kind))
    assert not result["correct"], result["checks"]


def test_the_control_fails_where_the_program_passes(catalog):
    from benchmark.control import readings

    limits = catalog.traffic(catalog.cell(CELL))["limits"]
    for seed, sound, control in readings(CELL, [SEED], 0.2, "cpu", TINY, catalog):
        assert all(sound[k] <= limits[k] for k in limits), sound
        assert any(control[k] > limits[k] for k in limits), control


def test_the_data_is_the_runners_seir_underreported_data(catalog):
    from epitpu_torch.cli import PRESETS, generate_dataset

    from benchmark import dataset

    config = catalog.config(catalog.cell(CELL))
    ours = dataset.observations(config["data"], model_seir)
    theirs, _ = generate_dataset(PRESETS["seir_underreported"]())
    assert ours.shape == (15, 4) and ours.dtype == np.float32
    assert np.array_equal(ours, np.asarray(theirs))


def test_the_reference_model_is_the_programs_bit_for_bit():
    from epitpu_torch.models import seir_model
    from epitpu_torch.ode.solve import seir_rhs

    model = seir_model()
    assert model.num_compartments == model_seir.COMPARTMENTS
    assert tuple(map(tuple, model.stoich.tolist())) == model_seir.STOICH
    assert tuple(model.source.tolist()) == model_seir.SOURCE
    g = torch.Generator().manual_seed(7)
    for _ in range(4):
        x = torch.floor(torch.rand((257, 4), generator=g) * 5000.0)
        x[:3, 2] = 0.0  # no infectious
        theta = 6.0 * torch.rand((257, 3), generator=g)
        assert torch.equal(model_seir.rates(x, theta), model.rate_fn(x, theta))
        for y, th in zip(x[:16] + 0.37, theta[:16]):
            assert torch.equal(model_seir.ode_rhs(y, th), seir_rhs(y, th))
    for seed in (0, 11, 2 ** 40 + 3):
        ours = model_seir.initial_cloud(torch.Generator().manual_seed(seed % 2 ** 63), (6, 32),
                                        4820.0, 20.0)
        theirs = model.init_fn(torch.Generator().manual_seed(seed % 2 ** 63), (6, 32), 4820.0,
                               20.0)
        assert torch.equal(ours, theirs)


class _Trace:
    def kernel_us(self, pattern):
        return 1000.0


def test_the_k4_bound_counts_seirs_rate_operations(catalog):
    cell = catalog.cell(CELL)
    config, traffic = catalog.config(cell), catalog.traffic(cell)
    from epitpu_torch.models import seir_model
    from epitpu_torch.ops.rate_trace import trace_rates

    assert config["k4"]["rate_ops"] == trace_rates(seir_model()).operations() == 8
    assert roofline.rate_ops(config["k4"]["groups"]) == 6
    driver = pmmh_rates.Driver(config, traffic, SEED, "cpu")
    rows = 32
    ours = driver.trace_facts(_Trace(), rows)
    sirs = pmmh.Driver.trace_facts(driver, _Trace(), rows)
    lanes = traffic["chains"] * traffic["particles"]
    substeps = config["sampler"]["steps_per_unit"]
    steps = rows * 14
    assert ours["filter_steps"] == sirs["filter_steps"] == steps
    # bound by operations at this shape, so 2 more a lane-substep add their time
    extra = 2 * lanes * substeps * steps / roofline.PEAK_OPS
    assert ours["k4_bound_s"] == pytest.approx(sirs["k4_bound_s"] + extra, rel=1e-12)
    assert {k: v for k, v in ours.items() if k != "k4_bound_s"} == \
        {k: v for k, v in sirs.items() if k != "k4_bound_s"}


def test_a_program_without_the_slot_counters_is_refused_before_any_work(monkeypatch,
                                                                        catalog):
    from epitpu_torch import profiling

    cell = catalog.cell(CELL)
    monkeypatch.setattr(profiling, "COUNTERS", ("abc.batches", "pf.resample_launches"))
    hooked = []
    with pytest.raises(SystemExit, match="k4.thread_slots"):
        run_cell(CELL, SEED, 0.3, False, "cpu", traffic_overrides=TINY,
                 driver_hook=hooked.append)
    assert hooked == []
    with pytest.raises(SystemExit, match="k4.thread_slots"):
        pmmh_rates.Driver(catalog.config(cell), catalog.traffic(cell), SEED, "cpu")


def test_the_idle_thread_metric_reads_the_slot_counters(catalog):
    read = catalog.reader(next(m for m in catalog.doc["per_layer"]
                               if m["name"] == "k4_idle_thread_pct"))
    rec = types.SimpleNamespace(counters={"k4.thread_slots": 262144,
                                          "k4.reaction_slots": 196608})
    assert read({"kind": "pmmh", "trace": None, "profiled_spans": rec}) == 25.0
    rec.counters = {"k4.thread_slots": 131072, "k4.reaction_slots": 131072}
    assert read({"kind": "pmmh", "trace": None, "profiled_spans": rec}) == 0.0
    # a program that counts no slots, or has no recorder, reads nothing
    rec.counters = {"pf.resample_launches": 3}
    assert read({"kind": "pmmh", "trace": None, "profiled_spans": rec}) is None
    assert read({"kind": "pmmh", "trace": None, "profiled_spans": spans.NO_RECORDER}) is None
    assert read({"kind": "abc", "trace": None}) is None


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cells_size(card, catalog):
    """The control at the cell's own size on three seeds, on the card."""
    from benchmark.control import readings

    limits = catalog.traffic(catalog.cell(CELL))["limits"]
    for seed, sound, control in readings(CELL, [11, 12, 13], 3.0, card, None, catalog):
        assert all(sound[k] <= limits[k] for k in limits), (seed, sound)
        assert any(control[k] > limits[k] for k in limits), (seed, control)
    torch.cuda.empty_cache()
