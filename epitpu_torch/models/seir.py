"""SEIR compartment model (torch counterpart of ``epitpu.models.seir``).

  expose  :  S -> E   at rate  beta * S * I / N
  progress:  E -> I   at rate  alpha * E
  recover :  I -> R   at rate  gamma * I

theta = [beta, alpha, gamma].
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .base import KernelSpec, make_model

S, E, I, R = 0, 1, 2, 3


def _rates(x, theta):
    beta = theta[..., 0]
    alpha = theta[..., 1]
    gamma = theta[..., 2]
    n = torch.sum(x, dim=-1)
    a_expose = beta * x[..., S] * x[..., I] / n
    a_progress = alpha * x[..., E]
    a_recover = gamma * x[..., I]
    return torch.stack([a_expose, a_progress, a_recover], dim=-1)


def _init(generator, shape, n_population=4820, mu=20.0):
    """Initial cloud: I0 ~ Poisson(mu), S0 = N - I0, E0 = R0 = 0."""
    rate = torch.full(tuple(shape), float(mu), dtype=torch.float32,
                      device=generator.device)
    i0 = torch.poisson(rate, generator=generator)
    s0 = float(n_population) - i0
    z = torch.zeros_like(i0)
    return torch.stack([s0, z, i0, z], dim=-1)


@lru_cache(maxsize=None)
def seir_model():
    return make_model(
        name="seir",
        compartments=("s", "e", "i", "r"),
        stoich=np.array([[-1, 1, 0, 0], [0, -1, 1, 0], [0, 0, -1, 1]]),
        source=np.array([S, E, I]),
        rate_fn=_rates,
        theta_dim=3,
        theta_names=("beta", "alpha", "gamma"),
        init_fn=_init,
        kernel=KernelSpec("seir"),
        terminal_compartments=(E, I),
    )
