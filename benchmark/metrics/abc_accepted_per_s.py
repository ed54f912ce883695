"""Accepted samples returned by the window's ABC calls over the window's
seconds (host clock; every call ends when its accepted rows are on the
host)."""


def read(f):
    if f.get("kind") != "abc":
        return None
    return f["window_samples"] / f["window_s"]
