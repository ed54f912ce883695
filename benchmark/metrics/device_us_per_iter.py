"""Device microseconds per chain-row (one PMMH iteration of one chain):
the union of the device events' intervals in the traced window over the
chain-rows it completed, every chain counted.  What a row costs the card,
whatever the host's speed; idle gaps are not in it."""


def read(f):
    if f.get("kind") != "pmmh" or not f.get("busy_s") or not f.get("traced_chain_rows"):
        return None
    return 1e6 * f["busy_s"] / f["traced_chain_rows"]
