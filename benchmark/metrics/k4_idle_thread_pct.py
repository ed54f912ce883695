"""The share of K4's draw slots in the traced window that no reaction fills,
in percent: ``100 (1 - k4.reaction_slots / k4.thread_slots)``, the
program's counters in its recording of the window (``benchmark/spans.py``).
A lane of R reactions takes a group of the next power of two at or above R
threads (``tauleap_cuda.launch_geometry``): SEIR's 3 reactions leave one
thread in four idle.  None where the program counts no slots."""
from benchmark import spans


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f:
        return None
    rec = spans.profiled(f)
    if rec is None or rec is spans.NO_RECORDER:
        return None
    threads = rec.counters.get("k4.thread_slots")
    if not threads:
        return None
    return 100.0 * (1.0 - rec.counters.get("k4.reaction_slots", 0) / threads)
