"""``benchmark/spans.py`` and its readers: on synthetic spans and a
synthetic trace with known self times, idle gaps and clock offsets they
give the expected values; a ``--trace 0`` run records no span outside the
profiler; the span window gives every host-time metric on the CPU."""
from __future__ import annotations

import types

import pytest

from benchmark import spans
from benchmark.run import Catalog, run_cell
from benchmark.trace import Trace
from epitpu_torch import profiling

from .conftest import SEED, TINY

MS = 1_000_000  # ns
# a Unix time whose trace base is known: 2 s past the start of an interval
BASE_NS = 230 * spans.TRIMONTH_S * 10 ** 9
W0, P0 = BASE_NS + 2 * 10 ** 9, 5 * 10 ** 12


@pytest.fixture(autouse=True)
def _nothing_left_under_the_profiler():
    profiling.take_profiled()
    yield
    profiling.take_profiled()


def _rec(rows, counters=None, anchor=((W0, P0), (W0 + 10 ** 9, P0 + 10 ** 9))):
    """A recording of ``rows`` ``(name, start ms, end ms, parent, id)``,
    times in ms after ``P0``."""
    return types.SimpleNamespace(
        anchor=[tuple(a) for a in anchor], counters=dict(counters or {}),
        spans=[profiling.Span(n, P0 + int(a * MS), P0 + int(b * MS), p, i)
               for n, a, b, p, i in rows])


def _us(ms):
    """The trace's ts (us) of ``ms`` after ``P0``, on the anchor above."""
    return 2e6 + ms * 1e3


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


# one PMMH call of two rows, a filter step each:
#  pmmh_call [0, 100] > pmmh_scan [10, 95] > pmmh_row 1 [10, 50], 2 [50, 95];
#  row 1 > pf_scan [15, 45] > pf_weight [16, 30], pf_resample [30, 34], pf_propagate [34, 44]
#  row 2 > pf_scan [55, 90] > pf_weight [56, 76], pf_resample [76, 78], pf_propagate [78, 88]
PMMH = [
    ("pmmh_call", 0, 100, -1, None), ("pmmh_scan", 10, 95, 0, None),
    ("pmmh_row", 10, 50, 1, 1), ("pf_scan", 15, 45, 2, None), ("pf_weight", 16, 30, 3, None),
    ("pf_resample", 30, 34, 3, None), ("pf_propagate", 34, 44, 3, None),
    ("pmmh_row", 50, 95, 1, 2), ("pf_scan", 55, 90, 7, None), ("pf_weight", 56, 76, 8, None),
    ("pf_resample", 76, 78, 8, None), ("pf_propagate", 78, 88, 8, None),
]


def test_self_times_and_the_pmmh_host_metrics():
    rec = _rec(PMMH)
    own = spans.self_ns(rec.spans)
    assert own[0] == 15 * MS and own[3] == 30 * MS - 28 * MS and own[8] == 3 * MS
    assert sum(own) == 100 * MS
    by = spans.by_name(rec.spans)
    assert by["pf_scan"] == (2, 65 * MS, 5 * MS) and by["pmmh_row"] == (2, 85 * MS, 20 * MS)
    got = spans.pmmh_host(rec)
    assert got == pytest.approx({
        "filter_step_host_us": 65e3 / 2, "weight_host_us": 34e3 / 2,
        "resample_host_us": 6e3 / 2, "propagate_host_us": 20e3 / 2,
        "chain_host_us_per_row": (100e3 - 65e3) / 2})
    assert spans.pmmh_host(_rec(PMMH[:2])) is None  # no filter step


def test_the_abc_host_metrics():
    rows = [("abc_call", 0, 100, -1, None), ("abc_batch_launch", 0, 5, 0, 0),
            ("abc_mask_sync", 5, 45, 0, None), ("abc_batch_launch", 45, 50, 0, 1),
            ("abc_fetch", 50, 80, 0, None), ("abc_mask_sync", 80, 95, 0, None),
            ("abc_fetch", 95, 100, 0, None)]
    got = spans.abc_host(_rec(rows, {"abc.batches": 2, "abc.host_copies": 6}))
    assert got == pytest.approx({"abc_sync_wait_pct": 55.0, "abc_fetch_pct": 35.0,
                                 "abc_host_copies_per_batch": 3.0})
    assert spans.abc_host(_rec(rows)) is None  # no batch counted


def _trace(offset_us=0.0):
    """The PMMH call's phase scopes as the profiler saw them, ``offset_us``
    off the anchor's clock (each opened 5 us before its span), and device
    events leaving known gaps (ms): [0.5, 12] and [96, 99] in pmmh_call's
    own time, [20, 28] in pf_weight, [46, 47] in pmmh_row 1, [101, 103]
    outside every span."""
    ev = [_x("user_annotation", n, _us(a) - 5 + offset_us, (b - a) * 1e3)
          for n, a, b, _, _ in PMMH if n in ("pmmh_scan", "pf_scan", "pf_weight",
                                           "pf_resample", "pf_propagate")]
    busy = [(0, 0.5), (12, 20), (28, 46), (47, 96), (99, 101), (103, 104)]
    ev += [_x("kernel", "k", _us(a) + offset_us, (b - a) * 1e3, tid=9) for a, b in busy]
    return Trace(ev)


def test_idle_gaps_go_to_the_innermost_span_on_the_trace_clock():
    tr = _trace()
    on, stats = spans.on_trace(_rec(PMMH), tr, log=False)
    assert stats["twins"] == 9 and stats["median_us"] == pytest.approx(5.0, abs=1e-3)
    assert stats["fitted_us"] == 0.0
    by = spans.idle_by_span(tr, on)
    assert by == pytest.approx({"pmmh_call": 14.5e-3, "pf_weight": 8e-3, "pmmh_row": 1e-3,
                                spans.OUTSIDE: 2e-3})


def test_an_offset_clock_is_fitted_from_the_twins():
    tr = _trace(offset_us=700.0)
    on, stats = spans.on_trace(_rec(PMMH), tr, log=False)
    assert stats["anchor_median_us"] == pytest.approx(695.0, abs=1e-3)
    assert stats["fitted_us"] == pytest.approx(695.0, abs=1e-3)
    assert stats["median_us"] == pytest.approx(0.0, abs=1e-3)
    assert spans.idle_by_span(tr, on)[spans.OUTSIDE] == pytest.approx(2e-3)


def test_twins_pair_with_the_last_spans_of_a_recording():
    """Spans of an earlier profiled window in the same recording are not
    paired with this window's twins."""
    early = [(n, a - 500, b - 500, p, i) for n, a, b, p, i in PMMH]
    shift = len(early)
    late = [(n, a, b, p + shift if p >= 0 else -1, i) for n, a, b, p, i in PMMH]
    on, stats = spans.on_trace(_rec(early + late), _trace(), log=False)
    assert stats["twins"] == 9 and stats["median_us"] == pytest.approx(5.0, abs=1e-3)


def test_the_reader_of_idle_outside_spans(monkeypatch):
    tr = _trace()
    facts = {"kind": "pmmh", "trace": tr}
    monkeypatch.setattr(profiling, "take_profiled", lambda: _rec(PMMH))
    read = Catalog().reader({"name": "idle_outside_spans_pct.pmmh"})
    assert read(facts) == pytest.approx(100.0 * 2 / 25.5)
    assert read({"kind": "abc", "trace": tr}) is None
    # a program without the recorder: no gap lies in a span
    monkeypatch.delattr(profiling, "take_profiled")
    assert read({"kind": "pmmh", "trace": tr}) == 100.0
    # no device event, no idle gap: nothing to read
    assert read({"kind": "pmmh", "trace": Trace([])}) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_trace_0_run_records_no_span_outside_the_profiler(cell):
    """The warm-up and the untraced window run with spans off; only a PMMH
    cell's profiler window (its device metric) records, one call of it."""
    result = run_cell(cell, SEED, 0.3, False, "cpu", traffic_overrides=TINY[cell])
    assert result["correct"]
    rec = profiling.take_profiled()
    if cell.startswith("sir_abc"):
        assert rec is None
    else:
        calls = [s for s in rec.spans if s.name == "pmmh_call"]
        assert len(calls) == TINY[cell]["trace_segments"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_span_window_reads_every_host_metric_on_the_cpu(cell):
    from benchmark.span_window import run

    line = run(cell, SEED, 0.3, "cpu", TINY[cell])
    assert line["correct"]
    keys = ({"abc_sync_wait_pct", "abc_fetch_pct", "abc_host_copies_per_batch"}
            if cell.startswith("sir_abc") else
            {"filter_step_host_us", "weight_host_us", "resample_host_us", "propagate_host_us",
             "chain_host_us_per_row"})
    assert set(line["span_window"]) == keys
    assert all(v > 0 for v in line["span_window"].values())
    rates = line["host_rate"]
    assert rates["untraced"] > 0 and rates["profiler_window"] > 0
    assert len(rates["spans_on"]) == len(rates["spans_off"]) == 3
    assert all(v > 0 for v in rates["spans_on"] + rates["spans_off"])
    # a CPU run has no device trace: nothing of the device is read
    assert "idle_outside_spans_pct.pmmh" not in line["metrics"]
    assert "idle_outside_spans_pct.abc" not in line["metrics"]


def test_the_span_windows_outside_gaps_and_collector_pauses():
    from benchmark.span_window import _outside

    # a collection from 100.5 to 102 ms: 1 ms of it inside the gap [101, 103]
    pauses = [[P0 + int(100.5 * MS), P0 + 102 * MS], [P0 + 50 * MS, P0 + 51 * MS]]
    got = _outside(_trace(), _rec(PMMH), pauses)
    assert got == pytest.approx({"gaps": 1, "s": 2e-3, "longest_ms": 2.0, "collector_s": 1e-3})
    assert _outside(Trace([]), _rec(PMMH), pauses) is None
