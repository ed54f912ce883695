"""Shared pieces of the benchmark's tests: each cell cut to a size the CPU
runs in seconds, through the program's CPU path."""
from __future__ import annotations

import pytest
import torch

TINY = {
    "sir_binomial.chains2048": {"chains": 8, "particles": 8, "warmup_rows": 20,
                                "segment_len": 4, "check_rows": 3, "trace_segments": 1},
    "sir_binomial.particles4096": {"chains": 2, "particles": 70, "warmup_rows": 20,
                                   "segment_len": 4, "check_rows": 2, "trace_segments": 1},
    "sir_abc.batch65536": {"batch_size": 256, "n_samples": 3, "warmup_calls": 1,
                           "trace_calls": 2, "check_calls": 1},
}
SEED = 2 ** 33 + 17  # past 32 signed bits, as the driver's seeds are


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tau-leap kernel has no CPU mode")
    return "cuda:0"
