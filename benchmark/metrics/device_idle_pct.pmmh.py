"""The share of the traced window in which no device event ran, in percent:
1 - (the union of the device events' intervals / the window's host-clock
length); the profiler's host overhead is in the window."""


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f or not f["busy_s"]:
        return None
    return 100.0 * (1.0 - f["busy_s"] / f["traced_window_s"])
