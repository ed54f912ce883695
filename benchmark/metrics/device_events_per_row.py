"""Device events (kernels, memcpy, memset) of the traced window per PMMH
row of all chains, over every phase: what the host dispatches a row."""


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f or not f["trace"].events:
        return None
    return f["trace"].events / f["pmmh_rows"]
