"""What a ``torch.profiler`` trace of the window says: device time and
device events by the program's phase, the device's busy time, and the
breakdown the result line carries.

The join of a device event to its phase is a frozen copy of
insitu_profile_torch.py at commit 0f2ab30 (``RNG_KERNEL_RE``,
``_scope_index``, ``_innermost``, ``attribute``): each device event
(kernel, memcpy, memset) is joined by its correlation id to the runtime or
driver call that launched it, and given to the innermost phase scope
(``epitpu_torch.profiling.scope``'s ``record_function`` ranges, named by
``PHASES``) around that call on the host thread; a launch outside every
scope goes to ``other``, torch's random-number kernels inside
``pf_propagate`` to ``pf_propagate_rng``, an event whose launch is not in
the trace to ``unmatched``.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
from pathlib import Path

# the program's phase names (epitpu_torch/profiling.py:PHASES at commit
# 0f2ab30); the benchmark keeps its own list, so a phase the program adds
# later is counted as ``other`` until a benchmark change names it
PHASES = ("pf_propagate", "pf_weight", "pf_resample", "pf_loglik", "pf_init", "path_sample",
          "mh_propose", "mh_accept", "adapt_welford", "pmmh_init", "pf_scan", "pmmh_scan")
RNG_KERNEL_RE = re.compile(
    r"philox|curand|distribution_elementwise|normal_and_transform"
    r"|uniform_and_transform|random_from_to|randperm|bernoulli|multinomial", re.I
)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160
KERNELS = Path(__file__).resolve().parent / "kernels"


def k4_kernels(folder=KERNELS) -> str:
    """A pattern that matches the names of K4's kernels: every line of every
    ``k4*.txt`` in ``benchmark/kernels/`` (``traj_kernel``, csrc/
    tauleap_kernel.cuh at commit 0f2ab30).  Both K4 rooflines divide the
    bound by the device time of these kernels alone; a K4 under another
    name is added as another file."""
    lines = (line.strip() for f in sorted(folder.glob("k4*.txt")) for line in open(f))
    return "|".join(f"(?:{line})" for line in lines if line)


def chrome_events(prof):
    """The Chrome-trace events of a finished ``torch.profiler.profile``,
    through a temporary file under ``TMPDIR``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh).get("traceEvents", [])
    finally:
        os.remove(path)


def _scope_index(intervals):
    intervals = sorted(intervals, key=lambda s: (s[0], -s[1]))
    starts, ends, names, parents, stack = [], [], [], [], []
    for i, (t0, t1, name) in enumerate(intervals):
        while stack and ends[stack[-1]] <= t0:
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        starts.append(t0)
        ends.append(t1)
        names.append(name)
        stack.append(i)
    return starts, ends, names, parents


def _innermost(index, t):
    starts, ends, names, parents = index
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ends[i] < t:
        i = parents[i]
    return names[i] if i >= 0 else None


class Trace:
    """The device side of one traced window."""

    def __init__(self, events):
        scopes = collections.defaultdict(list)
        launches, self.device = {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            if cat == "user_annotation" and e.get("name") in PHASES:
                t0 = float(e["ts"])
                scopes[(e["pid"], e["tid"])].append((t0, t0 + float(e.get("dur", 0.0)), e["name"]))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (e["pid"], e["tid"], float(e["ts"]))
            elif cat in DEVICE_CATS:
                self.device.append((str(e.get("name", "")), float(e["ts"]),
                                    float(e.get("dur", 0.0)), args.get("correlation")))
        self.index = {key: _scope_index(v) for key, v in scopes.items()}
        # the host thread that opened most scopes runs the program
        self.main = max(scopes, key=lambda k: len(scopes[k])) if scopes else None
        self.phase_us = collections.Counter()
        self.phase_events = collections.Counter()
        self.by_name = collections.Counter()
        for name, _, dur, corr in self.device:
            self.by_name[name] += dur
            launch = launches.get(corr)
            if launch is None:
                phase = "unmatched"
            else:
                pid, tid, ts = launch
                phase = (_innermost(self.index[(pid, tid)], ts)
                         if (pid, tid) in self.index else None) or "other"
                if phase == "pf_propagate" and RNG_KERNEL_RE.search(name):
                    phase = "pf_propagate_rng"
            self.phase_us[phase] += dur
            self.phase_events[phase] += 1

    @property
    def events(self) -> int:
        return len(self.device)

    @property
    def device_us(self) -> float:
        return float(sum(self.by_name.values()))

    def kernel_us(self, pattern) -> float:
        """Device time of the events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return float(sum(us for name, us in self.by_name.items() if rx.search(name)))

    def _busy_intervals(self):
        spans = sorted((ts, ts + dur) for _, ts, dur, _ in self.device)
        merged = []
        for t0, t1 in spans:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged

    def busy_s(self) -> float:
        """Seconds in which some device event ran (the union of their
        intervals)."""
        return sum(t1 - t0 for t0, t1 in self._busy_intervals()) * 1e-6

    def idle_gaps(self):
        """The device's idle gaps between its first and last event, summed
        by what the host's program thread was in at each gap's middle (its
        innermost phase scope), longest first: ``[[name, seconds], ...]``."""
        merged = self._busy_intervals()
        gaps = collections.Counter()
        for (_, a), (b, _) in zip(merged, merged[1:]):
            where = None
            if self.main is not None:
                where = _innermost(self.index[self.main], 0.5 * (a + b))
            gaps[where or "outside every phase"] += (b - a) * 1e-6
        return [[name, s] for name, s in gaps.most_common(TOP)]

    def device_ops(self):
        """The device events that took most time, ``[[name, seconds], ...]``;
        a name is cut to ``NAME_CHARS`` (torch's template arguments)."""
        return [[name[:NAME_CHARS], us * 1e-6] for name, us in self.by_name.most_common(TOP)]
