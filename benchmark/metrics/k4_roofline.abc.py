"""K4's share of its roofline in the abc cell(s), in percent: the least time
the traced window's tau-leap work needs on the chip (``benchmark/roofline.py``,
from the calls' shapes) over the device time of K4's own kernels, found
by name (``trace.k4_kernels``), by the same rule in every cell."""


def read(f):
    if f.get("kind") != "abc" or "trace" not in f or not f.get("k4_device_s"):
        return None
    return 100.0 * f["k4_bound_s"] / f["k4_device_s"]
