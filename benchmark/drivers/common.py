"""What every driver shares: the reference modules by name, the observed
data, the device's clock, and the log on standard error."""
from __future__ import annotations

import importlib
import sys

import torch

from .. import dataset


def reference_module(kind, name):
    """``benchmark/reference/<kind>_<name>.py``: a configuration names its
    model and observation, and the reference of each is a file of its own."""
    return importlib.import_module(f"benchmark.reference.{kind}_{name}")


def observations(config, model):
    return dataset.observations(config["data"], model)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def log(msg):
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def stream_seed(seed, *path):
    """A seed for the window's ``path``-th call, from the run's seed (a
    splitmix64 chain of the benchmark's own, so the calls do not depend on
    how the program derives its streams)."""
    from ..reference.philox import derive_seed

    return derive_seed(seed, 0xBE5C, *path) & 0x7FFFFFFFFFFFFFFF
