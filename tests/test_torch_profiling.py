"""The port's span recorder (``epitpu_torch.profiling``): nothing recorded
when off; spans that nest as the program does, one ``pmmh_row`` a row and
one ``pf_weight`` a filter step; self times that add up to their parents'
times; runs with spans on equal to runs with them off; the ABC loop's
counters; and, under a profiler, each span laid on its ``record_function``
twin through the recording's clock anchor.  A timing comparison has at
least 2 ms of tolerance."""
import collections
import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch

from epitpu_torch import profiling
from epitpu_torch.abc import abc_rejection
from epitpu_torch.cli import PRESETS, generate_dataset
from epitpu_torch.mcmc import particle_mcmc_chains
from epitpu_torch.models import sir_model
from epitpu_torch.observe import get_observation_model

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "sir_underreported", "dataset.csv")
T_LEN = 15  # the dataset's T: T - 1 = 14 filter steps a filter
TOL_NS = 2_000_000


def _y():
    return torch.from_numpy(np.loadtxt(DATA, delimiter=",").astype(np.float32))


def _pmmh(**kw):
    args = dict(seed=3, n_chains=2, n_iters=4, n_particles=8, steps_per_unit=2,
                n_init_attempts=2, device="cpu")
    args.update(kw)
    return particle_mcmc_chains(sir_model(), get_observation_model("binomial"), _y(),
                                [2.0, 1.0], 0.05, **args)


def _abc(**kw):
    """The sir_abc preset's exact data at a loose threshold."""
    args = dict(n_samples=6, threshold=400.0, priors={"beta": (0.0, 5.0), "gamma": (0.0, 5.0)},
                batch_size=128, device="cpu")
    args.update(kw)
    y, _ = generate_dataset(PRESETS["sir_abc"]())
    return abc_rejection(sir_model(), 5, y, **args)


@pytest.fixture(autouse=True)
def _nothing_left_under_the_profiler():
    profiling.take_profiled()
    yield
    profiling.take_profiled()


def _children(spans):
    out = collections.defaultdict(list)
    for i, s in enumerate(spans):
        out[s.parent].append(i)
    return out


def _names(spans, idx):
    return [spans[i].name for i in idx]


def test_off_records_nothing():
    for name in profiling.PHASES + profiling.SPANS:
        assert profiling.scope(name) is profiling.NULL_SCOPE
        assert profiling.scope(name, 3) is profiling.NULL_SCOPE
    profiling.count("abc.batches")
    _pmmh()
    _abc()
    assert profiling.take_profiled() is None
    with profiling.recording() as rec:
        assert profiling.scope("pf_weight") is not profiling.NULL_SCOPE
    assert profiling.scope("pf_weight") is profiling.NULL_SCOPE
    assert rec.spans == [] and rec.counters == {}


@pytest.mark.parametrize("resample_every", [1, 4])
def test_spans_nest_in_one_pmmh_call(resample_every):
    with profiling.recording() as rec:
        res = _pmmh(resample_every=resample_every)
    spans, kids = rec.spans, _children(rec.spans)
    assert len(rec.anchor) == 2 and rec.anchor[0][1] < spans[0].start_ns
    assert spans[-1].end_ns <= rec.anchor[1][1]
    (top,) = kids[-1]
    assert spans[top].name == "pmmh_call"
    assert _names(spans, kids[top]) == ["pmmh_init", "pmmh_scan"]
    init, scan = kids[top]
    rows = [spans[i] for i in kids[scan]]
    # one pmmh_row a MH iteration, its id the row; row 0 is the init search
    assert [r.name for r in rows] == ["pmmh_row"] * 3 and [r.id for r in rows] == [1, 2, 3]
    assert res.thetas.shape[1] == 1 + len(rows)
    for i in kids[scan]:
        assert _names(spans, kids[i])[0] == "mh_propose"
        assert set(_names(spans, kids[i])) == {"mh_propose", "pf_init", "pf_scan", "path_sample",
                                                "mh_accept", "adapt_welford"}
    # (T - 1) pf_weight a filter run, the init search's run included
    count = collections.Counter(s.name for s in spans)
    assert count["pf_scan"] == 1 + len(rows) and count["pmmh_call"] == 1
    assert count["pf_weight"] == count["pf_propagate"] == (T_LEN - 1) * count["pf_scan"]
    for i, s in enumerate(spans):
        if s.name in ("pf_weight", "pf_loglik", "pf_resample", "pf_propagate"):
            assert spans[s.parent].name == "pf_scan"
        if s.name == "pf_scan":
            assert spans[s.parent].name in ("pmmh_init", "pmmh_row")
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # a resumed call continues the row ids
    with profiling.recording() as more:
        _pmmh(resample_every=resample_every, n_iters=8, init_state=res.final_state,
              segment_len=2)
    assert [s.id for s in more.spans if s.name == "pmmh_row"] == [4, 5]
    assert not [s for s in more.spans if s.name == "pmmh_init"]


def test_self_times_add_up_to_the_parents_times():
    def sleep_ms(ms):
        time.sleep(ms * 1e-3)

    with profiling.recording() as rec:
        with profiling.scope("pmmh_call"):
            sleep_ms(5)
            with profiling.scope("pmmh_row", 1):
                sleep_ms(20)
                with profiling.scope("pf_weight"):
                    sleep_ms(10)
            with profiling.scope("pmmh_row", 2):
                sleep_ms(10)
    spans, kids = rec.spans, _children(rec.spans)
    own = {i: (s.end_ns - s.start_ns) - sum(spans[c].end_ns - spans[c].start_ns
                                             for c in kids[i])
           for i, s in enumerate(spans)}
    assert sum(own.values()) == spans[0].end_ns - spans[0].start_ns
    for i, s in enumerate(spans):
        assert own[i] + sum(spans[c].end_ns - spans[c].start_ns for c in kids[i]) \
            == s.end_ns - s.start_ns
    slept = {"pmmh_call": 5, "pmmh_row": 20, "pf_weight": 10}
    assert [s.name for s in spans] == ["pmmh_call", "pmmh_row", "pf_weight", "pmmh_row"]
    for i, s in enumerate(spans):
        ms = 10 if (s.name, s.id) == ("pmmh_row", 2) else slept[s.name]
        assert own[i] >= ms * 1e6 - TOL_NS, s
        # the sleeps' overshoot on a loaded host, with room
        assert own[i] <= ms * 1e6 + 100 * TOL_NS, s


@pytest.mark.parametrize("store_trajectories", [True, False])
def test_pmmh_with_spans_on_equals_spans_off(store_trajectories):
    off = _pmmh(store_trajectories=store_trajectories)
    with profiling.recording() as rec:
        on = _pmmh(store_trajectories=store_trajectories)
    assert rec.spans
    for field in ("thetas", "log_likelihoods", "sampled_trajs", "acceptances"):
        assert torch.equal(getattr(off, field), getattr(on, field)), field


def test_abc_with_spans_on_equals_spans_off():
    off = _abc()
    with profiling.recording() as rec:
        on = _abc()
    assert rec.spans and on.trials == off.trials
    np.testing.assert_array_equal(on.trajectories, off.trajectories)
    for name in off.posterior:
        np.testing.assert_array_equal(on.posterior[name], off.posterior[name])


def test_abc_counters_count_batches_and_host_copies(monkeypatch):
    copies = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        copies.append(tuple(self.shape))
        return cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    with profiling.recording() as rec:
        res = _abc(n_samples=12)
    batches = rec.counters["abc.batches"]
    assert batches * 128 == res.trials and batches > 1
    assert rec.counters["abc.host_copies"] == len(copies)
    names = collections.Counter(s.name for s in rec.spans)
    assert names["abc_call"] == 1 and names["abc_mask_sync"] == batches
    assert [s.id for s in rec.spans if s.name == "abc_batch_launch"] == list(range(batches))
    # a mask a batch, two copies a batch with accepted rows
    assert rec.counters["abc.host_copies"] == batches + 2 * names["abc_fetch"]
    for s in rec.spans:
        if s.name != "abc_call":
            assert rec.spans[s.parent].name == "abc_call"


def _unix(rec, perf_ns):
    """A span's time as Unix-epoch ns, through the recording's anchor."""
    (w0, p0), (w1, p1) = rec.anchor
    return w0 + (perf_ns - p0) * (w1 - w0) / (p1 - p0)


def _twins(path):
    with open(path) as fh:
        doc = json.load(fh)
    base = doc["baseTimeNanoseconds"]
    out = collections.defaultdict(list)
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            t0 = base + float(e["ts"]) * 1e3
            out[e["name"]].append((t0, t0 + float(e["dur"]) * 1e3))
    return out


@pytest.mark.parametrize("how", ["take_profiled", "recording"])
def test_spans_fall_on_their_profiler_twins(tmp_path, how):
    with profiling.recording() if how == "recording" else contextlib.nullcontext() as rec:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _pmmh(n_iters=3)
            _abc()
    if how == "take_profiled":
        rec = profiling.take_profiled()
    assert profiling.take_profiled() is None
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    twins = _twins(path)
    mine = collections.defaultdict(list)
    for s in rec.spans:
        mine[s.name].append((_unix(rec, s.start_ns), _unix(rec, s.end_ns)))
    assert set(mine) == set(profiling.PHASES + profiling.SPANS)
    for name, spans in mine.items():
        assert len(twins[name]) == len(spans), name
        for (a0, a1), (b0, b1) in zip(sorted(twins[name]), sorted(spans)):
            assert abs(a0 - b0) <= TOL_NS and abs(a1 - b1) <= TOL_NS, name
    assert rec.counters["abc.batches"] >= 1


def test_take_profiled_returns_the_profilers_spans_once():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.scope("pmmh_call"):
            profiling.count("abc.batches", 2)
    rec = profiling.take_profiled()
    assert [s.name for s in rec.spans] == ["pmmh_call"] and rec.counters == {"abc.batches": 2}
    assert profiling.take_profiled() is None
    # an open recording takes the spans of a profiled block itself
    with profiling.recording() as own:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.scope("abc_call"):
                pass
    assert [s.name for s in own.spans] == ["abc_call"]
    assert profiling.take_profiled() is None


def test_recordings_do_not_nest_and_counters_start_afresh():
    with profiling.recording() as first:
        profiling.count("abc.host_copies", 3)
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.recording():
                pass
    with profiling.recording() as second:
        profiling.count("abc.host_copies")
    assert first.counters == {"abc.host_copies": 3} and second.counters == {"abc.host_copies": 1}
    # a span still open when the recording stops ends with it
    with profiling.recording() as rec:
        span = profiling.scope("pmmh_call")
        span.__enter__()
    span.__exit__(None, None, None)
    assert rec.spans[0].end_ns == rec.anchor[1][1]
    doc = json.loads(json.dumps(rec.to_json()))
    assert doc["fields"] == ["name", "start_ns", "end_ns", "parent", "id"]
    assert doc["spans"][0][0] == "pmmh_call" and len(doc["anchor"]) == 2
