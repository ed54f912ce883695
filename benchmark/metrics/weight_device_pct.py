"""The ``pf_weight`` scope's share of the traced window's device time, in
percent."""


def read(f):
    if f.get("kind") != "pmmh" or "trace" not in f or not f["trace"].device_us:
        return None
    us = f["trace"].phase_us["pf_weight"]
    return 100.0 * us / f["trace"].device_us if us else None
