"""A cell's traced run with a span window after it: the program's host time
by span at the speed it runs without the profiler.

    python3 -m benchmark.span_window --workload <cell> --seeds 1,2,3 [--seconds 45]

Each seed makes one ``--trace 1`` run of the cell (``run.run_cell``), and
after its profiler window, once the trace's facts are taken, runs the
traffic's traced window once more with the program's span recording on and
the profiler off (the span window), then ``PAIRS - 1`` more times with
spans on and ``PAIRS`` times with them off, in turns (off after on), to
compare host rates in one process state.  One JSON line a seed: the run's
per-layer metrics, the span window's host-time metrics (``spans.pmmh_host``
or ``spans.abc_host``, means over the span window), its spans by name, and
the host rate of the untraced and profiler windows and of each window with
spans on and off, the pauses of Python's collector in the untraced window,
and the profiler window's idle gaps that lie in no span with the
collector's pauses inside them; last, the cost of a scope off and on, timed
by a loop of scopes in this process.  The benchmark's own runs do not make
these windows.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import spans
from .drivers import common
from .run import run_cell
from .trace import _innermost, _scope_index

SCOPE_LOOP = 200_000
PAIRS = 3


def _rate(driver, units, seconds):
    """Chain-rows (PMMH) or accepted samples (ABC) a second."""
    per = driver.traffic["chains"] if driver.kind == "pmmh" else 1
    return units * per / seconds if seconds else None


def _outside(trace, rec, pauses):
    """The traced window's idle gaps whose middle lies in no span: how many,
    their seconds, the longest, and the seconds of the collector's pauses
    (``[start_ns, end_ns]`` on ``perf_counter_ns``) inside them."""
    merged = trace._busy_intervals()
    if len(merged) < 2 or rec is None:
        return None
    on, stats = spans.on_trace(rec, trace, log=False)
    index = _scope_index(on)
    gaps = [(a, b) for (_, a), (b, _) in zip(merged, merged[1:])
            if _innermost(index, 0.5 * (a + b)) is None]
    to_us = spans.to_trace_us(rec.anchor)
    shift = stats["fitted_us"]
    paused = [(to_us(p0) + shift, to_us(p1) + shift) for p0, p1 in pauses if p1]
    in_gc = sum(max(0.0, min(b, p1) - max(a, p0)) for a, b in gaps for p0, p1 in paused)
    return {"gaps": len(gaps), "s": sum(b - a for a, b in gaps) * 1e-6,
            "longest_ms": max((b - a for a, b in gaps), default=0.0) * 1e-3,
            "collector_s": in_gc * 1e-6}


def run(name, seed, seconds, device="cuda:0", traffic_overrides=None):
    """One traced run of cell ``name`` with its span window; the line's dict."""
    from epitpu_torch import profiling

    seen = {}
    pauses = []  # [start_ns, end_ns, generation] of each collection

    def on_gc(phase, info):
        if phase == "start":
            pauses.append([time.perf_counter_ns(), 0, info["generation"]])
        else:
            pauses[-1][1] = time.perf_counter_ns()

    def hook(driver):
        window, trace_facts = driver.window, driver.trace_facts

        def timed_window(secs):
            t0 = time.perf_counter_ns()
            done, window_s = window(secs)
            seen["untraced_ns"] = (t0, time.perf_counter_ns())
            units = done if driver.kind == "pmmh" else driver.window_samples
            seen["untraced"] = _rate(driver, units, window_s)
            return done, window_s

        def timed():
            common.synchronize(device)
            t0 = time.perf_counter()
            rows = driver.traced_window()
            common.synchronize(device)
            units = rows if driver.kind == "pmmh" else driver.samples
            return _rate(driver, units, time.perf_counter() - t0)

        def with_span_window(trace, traced):
            facts = trace_facts(trace, traced)
            # the readers take the profiler window's spans from the facts
            facts["profiled_spans"] = profiling.take_profiled()
            seen["outside"] = _outside(trace, facts["profiled_spans"],
                                       [p[:2] for p in pauses])
            seen["profiler_units"] = traced if driver.kind == "pmmh" else driver.samples
            seen.update(driver=driver, on=[], off=[])
            for _ in range(PAIRS):
                with profiling.recording() as rec:
                    seen["on"].append(timed())
                seen.setdefault("rec", rec)
                seen["off"].append(timed())
            return facts

        driver.window, driver.trace_facts = timed_window, with_span_window

    gc.callbacks.append(on_gc)
    try:
        result = run_cell(name, seed, seconds, True, device,
                          traffic_overrides=traffic_overrides, driver_hook=hook)
    finally:
        gc.callbacks.remove(on_gc)
    w0, w1 = seen["untraced_ns"]
    collections_by_gen = {}
    for p0, p1, gen in pauses:
        if w0 <= p0 and p1 <= w1:
            n, ms = collections_by_gen.get(gen, (0, 0.0))
            collections_by_gen[gen] = (n + 1, ms + (p1 - p0) * 1e-6)
    driver, rec = seen["driver"], seen["rec"]
    host = spans.pmmh_host(rec) if driver.kind == "pmmh" else spans.abc_host(rec)
    names = spans.by_name(rec.spans)
    return {
        "workload": name, "seed": seed, "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "span_window": host,
        "spans_by_name": {k: {"count": n, "total_ms": t * 1e-6, "self_ms": o * 1e-6}
                          for k, (n, t, o) in sorted(names.items())},
        "counters": dict(rec.counters),
        "spans_a_row": len(rec.spans) / names["pmmh_row"][0] if "pmmh_row" in names else None,
        "host_rate": {"untraced": seen["untraced"],
                      "profiler_window": _rate(driver, seen["profiler_units"],
                                               result["device"]["window_s"]),
                      "spans_on": seen["on"], "spans_off": seen["off"]},
        "outside_spans": seen["outside"],
        # the collector's pauses inside the untraced window, by generation
        "untraced_collections": {str(g): {"count": n, "ms": ms}
                                 for g, (n, ms) in sorted(collections_by_gen.items())},
        "untraced_s": (w1 - w0) * 1e-9,
        "device": result["device"],
    }


def scope_cost(loops=SCOPE_LOOP):
    """ns a ``with scope(...)`` costs off, on (a recording open) and, for
    scale, for an empty ``with`` of ``NULL_SCOPE``."""
    from epitpu_torch import profiling

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(loops):
            with profiling.scope("pf_weight"):
                pass
        return (time.perf_counter_ns() - t0) / loops

    null = profiling.NULL_SCOPE
    t0 = time.perf_counter_ns()
    for _ in range(loops):
        with null:
            pass
    empty = (time.perf_counter_ns() - t0) / loops
    off = loop()
    with profiling.recording():
        on = loop()
    return {"off_ns": off, "on_ns": on, "empty_with_ns": empty}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(run(args.workload, seed, args.seconds, args.device)), flush=True)
    print(json.dumps({"scope_cost": scope_cost()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
