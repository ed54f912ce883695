"""Device microseconds launched inside the ``pf_resample`` scope per filter
step (steps that do not resample count too)."""


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f:
        return None
    us = f["trace"].phase_us["pf_resample"]
    return us / f["filter_steps"] if us else None
