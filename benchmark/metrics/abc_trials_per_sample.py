"""Candidates simulated per accepted sample returned, over the traced
window's ABC calls (``ABCResult.trials``): the candidates that did not
become a returned sample are the loop's waste."""


def read(f):
    if f.get("kind") != "abc" or not f.get("traced_samples"):
        return None
    return f["traced_trials"] / f["traced_samples"]
