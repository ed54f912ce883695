"""Device events launched inside the ``pf_weight`` scope (the observation
log-likelihood of every particle) per filter step."""


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f:
        return None
    n = f["trace"].phase_events["pf_weight"]
    return n / f["filter_steps"] if n else None
