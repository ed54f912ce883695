"""PMMH traffic on a model whose rates K-group SIR's count does not
describe: ``drivers/pmmh.py``'s traffic, with K4's bound counted at the
configuration's ``k4.rate_ops`` (the operations of the model's rates a
lane-substep, as ``epitpu_torch.ops.rate_trace`` counts them: 8 for SEIR)
in place of ``roofline.rate_ops(groups)``, K-group SIR's.  The draws, the
bytes and the peaks are ``roofline.py``'s, as in every cell.

The cell's ``k4_idle_thread_pct`` reads the program's K4 draw-slot counters
over the traced window (``k4.thread_slots``, ``k4.reaction_slots``): a
program without them cannot run a cell of this driver, and says so before
any work.
"""
from __future__ import annotations

from .. import roofline
from . import pmmh

SLOT_COUNTERS = ("k4.thread_slots", "k4.reaction_slots")


def _require_slot_counters():
    from epitpu_torch import profiling

    missing = [c for c in SLOT_COUNTERS if c not in getattr(profiling, "COUNTERS", ())]
    if missing:
        raise SystemExit(f"[benchmark] this program counts no K4 draw slots "
                         f"(epitpu_torch.profiling has no {', '.join(missing)}); the cell's "
                         f"k4_idle_thread_pct reads them")


class Driver(pmmh.Driver):
    kind = "pmmh"

    def __init__(self, config, traffic, seed, device):
        _require_slot_counters()
        super().__init__(config, traffic, seed, device)

    def trace_facts(self, trace, rows):
        """``pmmh``'s, with K4's bound at the configuration's rate
        operations."""
        facts = super().trace_facts(trace, rows)
        t, k4 = self.traffic, self.config["k4"]
        lanes = t["chains"] * t["particles"]
        n_sub = self.config["sampler"]["steps_per_unit"]
        n_ops = (roofline.ops(lanes, n_sub, k4["reactions"], k4["groups"], t["k4_ops_per_draw"])
                 + lanes * n_sub * (k4["rate_ops"] - roofline.rate_ops(k4["groups"])))
        facts["k4_bound_s"] = facts["filter_steps"] * roofline.bound_s(
            n_ops, roofline.nbytes(lanes, t["chains"], k4["compartments"], k4["theta_dim"], 1))
        return facts
