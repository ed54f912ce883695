"""The smallest rank-normalized bulk ESS over the theta components, of the
window's rows only, over the window's seconds (``benchmark/ess.py``)."""


def read(f):
    if "ess_min" not in f:
        return None
    return f["ess_min"] / f["window_s"]
