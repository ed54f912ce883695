"""Named phases and host-clock spans of the port's programs (the phases are
the counterparts of epitpu's ``jax.named_scope`` annotations in
``epitpu.smc.filter`` and ``epitpu.mcmc.pmmh``), and the one recorder of
spans and counters.

``with scope(name[, id])`` marks a phase, and ``count(name, n)`` adds to a
counter.  Each is in one of three states:

* **off** (no recording open, no profiler running): ``scope`` returns the
  shared ``NULL_SCOPE`` after two flag checks, and ``count`` does nothing.
  An unentered ``record_function`` costs about 15 us of host time, so
  nothing is built when nothing reads it.
* **spans on** (inside ``with recording() as rec``): each scope is a span
  in memory, its start and end on ``time.perf_counter_ns()``, its parent
  the enclosing open span and, where given, one integer id (the MH row of
  ``pmmh_row``, the batch of ``abc_batch_launch``); counters add into one
  dict.  Nothing is written to disk, and no span or counter synchronizes
  the device, copies or launches.
* **profiler running**: as with spans on, and each scope is also a
  ``torch.profiler.record_function`` range (its twin), so that a trace
  gives each device kernel the phase that launched it
  (``insitu_profile_torch.py``).  Outside an open recording these spans
  and counters are kept until ``take_profiled()`` returns them.

A recording's ``anchor`` holds two ``(time.time_ns(), perf_counter_ns())``
pairs, taken when it starts and when it stops: with them a span's time is
Unix-epoch time, on which a ``torch.profiler`` Chrome trace's
``baseTimeNanoseconds + ts * 1000`` lies.  ``PHASES`` are epitpu's phase
names; ``SPANS`` the port's own, beside them; ``DIST_SPANS`` the sharded
runs' own (an unsharded run opens none); ``COUNTERS`` its counters.
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the phase names, innermost first (insitu_profile.py:46-59): a filter
# phase inside pf_scan, pf_scan inside pmmh_init or pmmh_scan
PHASES = (
    "pf_propagate",
    "pf_weight",
    "pf_resample",
    "pf_loglik",
    "pf_init",
    "path_sample",
    "mh_propose",
    "mh_accept",
    "adapt_welford",
    "pmmh_init",
    "pf_scan",
    "pmmh_scan",
)
# the port's spans that epitpu has no named scope for: one particle_mcmc_chains
# call, one MH row of its scan (id: the row); one abc_rejection call, the
# enqueue of one candidate batch (id: the batch), the accept mask's copy to
# the host, the copy of the accepted rows
SPANS = ("pmmh_call", "pmmh_row", "abc_call", "abc_batch_launch", "abc_mask_sync", "abc_fetch")
# one all-gather over a mesh group (epitpu_torch/dist/mesh.py:all_gather_cat),
# inside the phase that gathers
DIST_SPANS = ("dist_gather",)
# abc_rejection's candidate batches, and its blocking device-to-host copies;
# launches of the binomial observation kernel (epitpu_torch/ops/obs_cuda.py);
# all-gathers over a mesh group, and the bytes of their gathered outputs;
# launches of the likelihood-update kernel (epitpu_torch/ops/loglik_cuda.py)
# and of the resampling kernel (epitpu_torch/ops/resample_cuda.py); launches
# of the tau-leap kernel K4 (epitpu_torch/ops/tauleap_cuda.py), any family or
# generated functor, and the draw slots of their threads and those a reaction
# fills (tauleap_cuda.draw_slots)
COUNTERS = ("abc.batches", "abc.host_copies", "obs.weight_launches", "dist.gathers",
            "dist.gather_bytes", "pf.loglik_launches", "pf.resample_launches",
            "k4.launches", "k4.thread_slots", "k4.reaction_slots")

NULL_SCOPE = contextlib.nullcontext()
# brackets an anchor takes its pair from
ANCHOR_TRIES = 8


class Span(NamedTuple):
    """One closed span: ``parent`` is the index of the enclosing span in the
    same recording, or -1."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    id: Optional[int]


def _anchor():
    """A ``(time.time_ns(), perf_counter_ns())`` pair, the second the middle
    of two reads around the first: of ``ANCHOR_TRIES`` such brackets the
    narrowest, since a preemption inside one widens it by a time slice."""
    brackets = []
    for _ in range(ANCHOR_TRIES):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        brackets.append((p1 - p0, wall, (p0 + p1) // 2))
    _, wall, perf = min(brackets)
    return wall, perf


class Recording:
    """The spans and counters of one recording.  ``spans`` (a list of
    ``Span`` in the order they opened) and the second anchor pair exist
    once it has stopped; ``counters`` fill as it runs."""

    def __init__(self):
        self.anchor = [_anchor()]
        self.counters = {}
        self.spans = []
        # one flat list a field: appending an int or a str makes no object
        # for Python's collector to track
        self._names, self._starts, self._ends, self._parents, self._ids = [], [], [], [], []
        self._open = []

    def _begin(self, name, ident, start_ns):
        i = len(self._starts)
        self._names.append(name)
        self._parents.append(self._open[-1] if self._open else -1)
        self._ids.append(ident)
        self._ends.append(0)
        self._open.append(i)
        self._starts.append(start_ns)
        return i

    def _end(self, i):
        self._ends[i] = time.perf_counter_ns()
        self._open.pop()

    def _stop(self):
        """Closes the recording; a span still open ends now."""
        self.anchor.append(_anchor())
        stop = self.anchor[-1][1]
        self.spans = [Span(*row) for row in zip(self._names, self._starts,
                                                 (e or stop for e in self._ends),
                                                 self._parents, self._ids)]
        return self

    def to_json(self):
        """The recording as plain data (``spans.json`` of ``cli.run --profile``)."""
        return {"anchor": [list(a) for a in self.anchor],
                "counters": dict(self.counters),
                "fields": list(Span._fields),
                "spans": [list(s) for s in self.spans]}


# a span's twin: the ``user_annotation`` range ``torch.profiler.record_function``
# opens, entered and left through the autograd binding it wraps, without the
# operator dispatch around it
_twin_enter = torch._C._autograd._record_function_with_args_enter
_twin_exit = torch._C._autograd._record_function_with_args_exit


class _Span:
    __slots__ = ("_rec", "_name", "_id", "_i", "_twin")

    def __init__(self, rec, name, ident):
        self._rec, self._name, self._id = rec, name, ident

    def __enter__(self):
        # the span's clock is read just outside its twin's range, on the side
        # of each of the twin's reads with the least work between the two
        # (about 2 us; inside the range 5-15 us): a preemption between them
        # puts span and twin a time slice (about 4 ms) apart
        start = time.perf_counter_ns()
        self._twin = _twin_enter(self._name) if _autograd_profiler._is_profiler_enabled else None
        self._i = self._rec._begin(self._name, self._id, start)
        return self

    def __exit__(self, *exc):
        if self._twin is not None:
            _twin_exit(self._twin)
        self._rec._end(self._i)
        return False


# process-wide, as torch's profiler is: the scopes sit deep inside the filter
# and the samplers, which take no recorder argument
_recording: Optional[Recording] = None
_profiled: Optional[Recording] = None


def _under_profiler() -> Recording:
    global _profiled
    if _profiled is None:
        _profiled = Recording()
    return _profiled


def scope(name: str, id: Optional[int] = None):
    """A span of ``name`` (with ``id``) while a recording is open or a
    profiler runs, else ``NULL_SCOPE``."""
    rec = _recording
    if rec is None:
        if not _autograd_profiler._is_profiler_enabled:
            return NULL_SCOPE
        rec = _under_profiler()
    return _Span(rec, name, id)


def count(name: str, n: int = 1):
    """Adds ``n`` to counter ``name`` while a recording is open or a
    profiler runs."""
    rec = _recording
    if rec is None:
        if not _autograd_profiler._is_profiler_enabled:
            return
        rec = _under_profiler()
    rec.counters[name] = rec.counters.get(name, 0) + n


def spanned(name: str):
    """A decorator: each call of the function runs inside ``scope(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Records every span and counter until the block ends; yields the
    ``Recording``, complete once the block has ended."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
        rec._stop()


def take_profiled() -> Optional[Recording]:
    """The spans and counters recorded while a profiler ran outside any
    recording, since the last call (stopped now), or None."""
    global _profiled
    rec, _profiled = _profiled, None
    return None if rec is None else rec._stop()
