"""Device microseconds launched inside the ``pf_scan`` scope (weighting,
log-likelihood, resampling, propagation and the scan's own) per filter
step."""

INSIDE = ("pf_scan", "pf_weight", "pf_loglik", "pf_resample", "pf_propagate",
          "pf_propagate_rng")


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f:
        return None
    us = sum(f["trace"].phase_us[p] for p in INSIDE)
    return us / f["filter_steps"] if us else None
