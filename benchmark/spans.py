"""The program's host-clock spans (``epitpu_torch.profiling``) beside the
device's trace: the clock that lays them on the trace, each span's own
(self) time, and the device's idle gaps put down to the span the host was
in.

**The clock.**  A recording's anchor pairs Unix-epoch time with
``perf_counter_ns``.  A ``torch.profiler`` Chrome trace gives an event at
``baseTimeNanoseconds + ts * 1000`` Unix time, and kineto sets its base to
the start of the current 7,889,238-second interval of Unix time
(``TRIMONTH_S``, libkineto's ``ChromeTraceBaseTime``), so a span maps onto
the trace's ``ts`` without the exported file.  The mapping is checked
against each span's ``record_function`` twin among the trace's phase
scopes (``trace.PHASES``): the gaps' median and 95th percentile go to
standard error, and where the median is over ``TWIN_GAP_US`` the offset
is fitted from the twins instead (the median of their differences).

**The spans of the traced window.**  While a profiler runs, the program
keeps its spans until ``profiling.take_profiled()`` takes them; a run takes
them once, after the traced window, and keeps them in the run's facts.  A
program without the recorder records no span, so no idle gap lies in one:
its idle share outside spans is 100 %.
"""
from __future__ import annotations

import collections
import sys

import numpy as np

from .trace import _innermost, _scope_index

TRIMONTH_S = 7_889_238
TWIN_GAP_US = 50.0
OUTSIDE = "outside every span"
TOP = 10
NO_RECORDER = "no recorder"


def profiled(facts):
    """The program's recording of the traced window, taken once a run and
    kept in ``facts``; ``NO_RECORDER`` where the program has none, None
    where it recorded nothing."""
    if "profiled_spans" not in facts:
        from epitpu_torch import profiling

        take = getattr(profiling, "take_profiled", None)
        facts["profiled_spans"] = NO_RECORDER if take is None else take()
    return facts["profiled_spans"]


def trace_base_ns(unix_ns):
    """The Unix time a Chrome trace's ``ts`` counts from (module docstring)."""
    return unix_ns // 10 ** 9 // TRIMONTH_S * TRIMONTH_S * 10 ** 9


def to_trace_us(anchor):
    """A function from ``perf_counter_ns`` to the trace's ``ts`` (us),
    through the recording's anchor: linear between its first and last
    pair."""
    (w0, p0), (w1, p1) = anchor[0], anchor[-1]
    slope = (w1 - w0) / (p1 - p0) if p1 != p0 else 1.0
    base = trace_base_ns(w0)
    return lambda p: (w0 - base + (p - p0) * slope) * 1e-3


def twin_gaps(spans_us, trace):
    """Twin start less span start (us) for each span whose name the trace's
    program thread opened as a phase scope: the last n spans of a name
    against its n twins, in order (the traced window is the last a
    recording holds)."""
    if trace.main is None:
        return []
    starts, _, names, _ = trace.index[trace.main]
    twins = collections.defaultdict(list)
    for t0, name in zip(starts, names):
        twins[name].append(t0)
    own = collections.defaultdict(list)
    for t0, _, name in spans_us:
        if name in twins:
            own[name].append(t0)
    gaps = []
    for name, ts in twins.items():
        mine = sorted(own[name])[-len(ts):]
        if len(mine) == len(ts):
            gaps.extend(t - s for t, s in zip(sorted(ts), mine))
    return gaps


def _gap_stats(gaps):
    a = np.abs(np.asarray(gaps, dtype=float))
    return {"twins": int(a.size), "median_us": float(np.median(a)),
            "p95_us": float(np.percentile(a, 95))}


def on_trace(rec, trace, log=True):
    """The recording's spans as ``(start_us, end_us, name)`` on the trace's
    clock, and the mapping's check: twins compared, the gap's median and
    95th percentile (us), and the offset fitted from the twins (0.0 where
    the anchor held)."""
    to_us = to_trace_us(rec.anchor)
    spans = [(to_us(s.start_ns), to_us(s.end_ns), s.name) for s in rec.spans]
    gaps = twin_gaps(spans, trace)
    stats = {"twins": 0, "fitted_us": 0.0}
    if gaps:
        stats.update(_gap_stats(gaps))
        if stats["median_us"] > TWIN_GAP_US:
            shift = float(np.median(gaps))
            spans = [(a + shift, b + shift, name) for a, b, name in spans]
            stats.update(_gap_stats(twin_gaps(spans, trace)), fitted_us=shift,
                         anchor_median_us=stats["median_us"])
    if log:
        print(f"[benchmark] spans on the trace's clock: {stats}", file=sys.stderr, flush=True)
    return spans, stats


def idle_by_span(trace, spans_us):
    """The device's idle gaps between its first and last event, summed by
    the innermost span around each gap's middle: ``{name: seconds}``, with
    ``OUTSIDE`` for gaps in no span."""
    merged = trace._busy_intervals()
    index = _scope_index(spans_us)
    by = collections.Counter()
    for (_, a), (b, _) in zip(merged, merged[1:]):
        by[_innermost(index, 0.5 * (a + b)) or OUTSIDE] += (b - a) * 1e-6
    return by


def idle_outside_pct(facts):
    """The share of the traced window's device idle time (between its first
    and last event) whose gap middle lies in no program span, in percent;
    None without a gap, or where the program's recorder recorded nothing."""
    trace = facts["trace"]
    merged = trace._busy_intervals()
    total = sum(b - a for (_, a), (b, _) in zip(merged, merged[1:]))
    if total <= 0:
        return None
    rec = profiled(facts)
    if rec is NO_RECORDER:
        return 100.0
    if rec is None or not rec.spans:
        return None
    spans, _ = on_trace(rec, trace)
    by = idle_by_span(trace, spans)
    print(f"[benchmark] idle gaps by innermost span: "
          f"{[[n, s] for n, s in by.most_common(TOP)]}", file=sys.stderr, flush=True)
    return 100.0 * by[OUTSIDE] / sum(by.values())


# --- host time by span, over a recording made with the profiler off --------

def self_ns(spans):
    """Each span's own time (ns): its time less its children's."""
    own = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def by_name(spans):
    """``{name: (count, total ns, self ns)}``."""
    out = collections.defaultdict(lambda: [0, 0, 0])
    for s, own in zip(spans, self_ns(spans)):
        row = out[s.name]
        row[0] += 1
        row[1] += s.end_ns - s.start_ns
        row[2] += own
    return {k: tuple(v) for k, v in out.items()}


def _inside(spans, i, name):
    """Whether span ``i`` has an ancestor named ``name``."""
    p = spans[i].parent
    while p >= 0:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def pmmh_host(rec):
    """The PMMH host-time metrics of a recording (us): ``pf_scan`` time, and
    ``pf_weight``, ``pf_resample`` and ``pf_propagate`` self time, per filter
    step (one ``pf_weight`` a step); ``pmmh_call`` time less its ``pf_scan``
    descendants, per MH row.  None without a filter step or a row."""
    spans, names = rec.spans, by_name(rec.spans)
    steps = names.get("pf_weight", (0,))[0]
    rows = names.get("pmmh_row", (0,))[0]
    if not steps or not rows or "pmmh_call" not in names:
        return None
    scans = sum(s.end_ns - s.start_ns for i, s in enumerate(spans)
                if s.name == "pf_scan" and _inside(spans, i, "pmmh_call"))
    per_step = lambda name, col: names.get(name, (0, 0, 0))[col] / steps * 1e-3
    return {"filter_step_host_us": per_step("pf_scan", 1),
            "weight_host_us": per_step("pf_weight", 2),
            "resample_host_us": per_step("pf_resample", 2),
            "propagate_host_us": per_step("pf_propagate", 2),
            "chain_host_us_per_row": (names["pmmh_call"][1] - scans) / rows * 1e-3}


def abc_host(rec):
    """The ABC loop's metrics of a recording: ``abc_mask_sync`` and
    ``abc_fetch`` time over ``abc_call`` time (%), and blocking host copies
    per candidate batch.  None without a call or a batch."""
    names = by_name(rec.spans)
    call = names.get("abc_call", (0, 0))[1]
    batches = rec.counters.get("abc.batches", 0)
    if not call or not batches:
        return None
    return {"abc_sync_wait_pct": 100.0 * names.get("abc_mask_sync", (0, 0))[1] / call,
            "abc_fetch_pct": 100.0 * names.get("abc_fetch", (0, 0))[1] / call,
            "abc_host_copies_per_batch": rec.counters.get("abc.host_copies", 0) / batches}
