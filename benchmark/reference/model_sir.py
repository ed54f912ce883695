"""SIR in plain torch: S -> I at beta S I / N, I -> R at gamma I
(theta = [beta, gamma]); the initial cloud I0 ~ Poisson(mu), S0 = N - I0,
R0 = 0.  As epitpu_torch/models/sir.py at commit 0f2ab30 states it."""
from __future__ import annotations

import torch

STOICH = ((-1, 1, 0), (0, -1, 1))
SOURCE = (0, 1)
COMPARTMENTS = 3


def rates(x, theta):
    n = torch.sum(x, dim=-1)
    a_infect = theta[..., 0] * x[..., 0] * x[..., 1] / n
    a_recover = theta[..., 1] * x[..., 1]
    return torch.stack([a_infect, a_recover], dim=-1)


def initial_cloud(generator, shape, n_population, mu):
    """``[*shape, 3]`` float32; draws one Poisson per entry of ``shape``."""
    rate = torch.full(tuple(shape), float(mu), dtype=torch.float32, device=generator.device)
    i0 = torch.poisson(rate, generator=generator)
    return torch.stack([float(n_population) - i0, i0, torch.zeros_like(i0)], dim=-1)


def ode_rhs(y, theta):
    """The mean-field ODE (epitpu_torch/ode/solve.py:sir_rhs), N summed left
    to right."""
    beta, gamma = theta[0], theta[1]
    n = y[0] + y[1] + y[2]
    s, i = y[0], y[1]
    return torch.stack([-beta * s * i / n, (beta * s / n - gamma) * i, gamma * i])
