"""The least time one NVIDIA H100 needs for the tau-leap step (K4), from the
shapes of the calls: operations and bytes, and the chip's peaks.

The count describes the work of the Euler-multinomial tau-leap step, not how
a kernel does it, so a later K4, or whatever replaces it, is held to the
same count.  Per lane and substep:

* the model's rates: ``2 K^2 + 5 K - 1`` operations for K-group SIR (K = 1:
  the population sum 2, ``beta s i / n`` 3, ``gamma i`` 1), as
  ``RateProgram.operations()`` counts them (epitpu_torch/ops/rate_trace.py
  at commit 0f2ab30), and ``2 R`` for the state update of R reactions;
* per reaction, one binomial draw: Philox (10 rounds of 2 high and 2 low
  multiplies, 4 xors, 2 key adds: 100), the firing probability 11, the
  regime logic 14, then the small regime's 14 plus 9 for each CDF term it
  evaluates, or the normal regime's 32 (Box-Muller 13, Cornish-Fisher and
  rounding 19).  These are chip_smoke.py:496-512's counts per source line of
  csrc/tauleap.cu at commit 0f2ab30; each +, -, *, /, comparison, select,
  min/max, shift, bit operation, int->float conversion and call of a math
  function is one.

How many draws take the small regime and how many CDF terms they need
depends on the states and rates, so one draw's mean cost at a cell's shapes
is a constant calibrated once by ``calibrate`` (the reference's count over
the cell's own states and thetas) and written in the cell's traffic file as
``k4_ops_per_draw``, with its source beside it.

Bytes: each input read once (the states and the theta rows) and each output
written once (the final states, or the state at every integer time).

The peaks: ``PEAK_OPS`` is an instruction-rate assumption, 132 SMs x 128
FP32 lanes x 1.98 GHz at one operation a lane a cycle (no fused
multiply-add: K4 is built with ``--fmad=false``); ``PEAK_BYTES`` is the
H100 SXM data sheet's HBM3 bandwidth.  Both assume the 700 W power limit.
"""
from __future__ import annotations

PEAK_OPS = 132 * 128 * 1.98e9  # 33.45 T op/s
PEAK_BYTES = 3.35e12
OPS_PHILOX, OPS_FIRE, OPS_BINOMIAL = 100, 11, 14
OPS_SMALL, OPS_TERM, OPS_NORMAL = 14, 9, 32


def rate_ops(groups: int) -> int:
    return 2 * groups * groups + 5 * groups - 1


def draw_ops(work) -> int:
    """Operations of the draws a reference run counted: ``work`` holds
    ``draws``, ``small`` (draws in the small regime) and ``terms`` (their
    CDF terms)."""
    return (work["draws"] * (OPS_PHILOX + OPS_FIRE + OPS_BINOMIAL)
            + work["small"] * OPS_SMALL + work["terms"] * OPS_TERM
            + (work["draws"] - work["small"]) * OPS_NORMAL)


def ops(lanes, substeps, reactions, groups, ops_per_draw) -> float:
    """Operations of one call of ``lanes`` lanes through ``substeps``
    substeps."""
    return lanes * substeps * (rate_ops(groups) + 2 * reactions + reactions * ops_per_draw)


def nbytes(lanes, theta_rows, compartments, theta_dim, states_out) -> int:
    """Bytes of one call that writes ``states_out`` states a lane."""
    return 4 * (lanes * compartments + theta_rows * theta_dim
                + lanes * compartments * states_out)


def bound_s(n_ops, n_bytes) -> float:
    """The least seconds: the larger of operations over the peak rate and
    bytes over the peak bandwidth."""
    return max(n_ops / PEAK_OPS, n_bytes / PEAK_BYTES)


def calibrate(model, x0, theta, n_units, n_sub, seed=0):
    """Mean operations of one draw over the reference's run of ``x0 [B, C]``
    at ``theta [B, d]`` through ``n_units`` units of ``n_sub`` substeps."""
    from .reference import tauleap

    work = {}
    tauleap.simulate(model, x0, theta, seed, 0, n_units, n_sub, False, work=work)
    return draw_ops(work) / work["draws"]
