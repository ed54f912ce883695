"""SIR compartment model (torch counterpart of ``epitpu.models.sir``).

  infect :  S -> I   at rate  beta * S * I / N
  recover:  I -> R   at rate  gamma * I

theta = [beta, gamma].
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .base import KernelSpec, make_model

S, I, R = 0, 1, 2


def _rates(x, theta):
    beta = theta[..., 0]
    gamma = theta[..., 1]
    n = torch.sum(x, dim=-1)
    a_infect = beta * x[..., S] * x[..., I] / n
    a_recover = gamma * x[..., I]
    return torch.stack([a_infect, a_recover], dim=-1)


def _init(generator, shape, n_population=4820, mu=20.0):
    """Initial cloud: I0 ~ Poisson(mu), S0 = N - I0, R0 = 0."""
    rate = torch.full(tuple(shape), float(mu), dtype=torch.float32,
                      device=generator.device)
    i0 = torch.poisson(rate, generator=generator)
    s0 = float(n_population) - i0
    return torch.stack([s0, i0, torch.zeros_like(i0)], dim=-1)


@lru_cache(maxsize=None)
def sir_model():
    return make_model(
        name="sir",
        compartments=("s", "i", "r"),
        stoich=np.array([[-1, 1, 0], [0, -1, 1]]),
        source=np.array([S, I]),
        rate_fn=_rates,
        theta_dim=2,
        theta_names=("beta", "gamma"),
        init_fn=_init,
        kernel=KernelSpec("sir"),
        terminal_compartments=(I,),
    )
