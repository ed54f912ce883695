"""In the traced window, the share of the device's idle time (between its
first and last event) whose gap middle falls in no span of the program's,
in percent: the spans the program recorded under the profiler, laid on the
trace's clock (``benchmark/spans.py``).  A program without the span
recorder reads 100 (no gap lies in a span)."""
from benchmark import spans


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f:
        return None
    return spans.idle_outside_pct(f)
