"""Chain-rows completed in the untraced window over the window's seconds,
every chain counted (host clock; the window ends at a synchronize after the
last whole segment).  While the device idles most of a row, this is the
host's dispatch rate, and it follows the host's CPU speed."""


def read(f):
    if "chain_rows" not in f:
        return None
    return f["chain_rows"] / f["window_s"]
