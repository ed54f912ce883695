"""SEIR in plain torch: S -> E at beta S I / N, E -> I at alpha E, I -> R at
gamma I (theta = [beta, alpha, gamma]); the initial cloud I0 ~ Poisson(mu),
S0 = N - I0, E0 = R0 = 0.  As epitpu_torch/models/seir.py states it.

Against the reference repo (GeorgeEfstathiadis/Stochastic-Epidemic-Modelling):
its ODE is ``differential_seir`` (pmcmc.py:26) and its data
tests/test_particles_seir.py:17-40's, but the ODE is integrated by classic
RK4 in float32 (``benchmark/dataset.py``) where the reference calls scipy's
``odeint``; a particle moves by the tau-leap step
(``benchmark/reference/tauleap.py``, 20 substeps a unit) where the reference
runs the exact Gillespie SSA (gillespie_algo.py:78-146); and the sampler is
the port's production preset (pooled adaptive h = 0.6 from row 16,
resampling every 4th step) where tests/test_pmcmc_seir.py runs 3 chains x
100 particles at h = 4 with a covariance from an earlier run.  A particle's
weight is the reference's: the smallest log-pmf over the four compartments
(pmcmc.py:179, ``benchmark/reference/obs_binomial.py``)."""
from __future__ import annotations

import torch

STOICH = ((-1, 1, 0, 0), (0, -1, 1, 0), (0, 0, -1, 1))
SOURCE = (0, 1, 2)
COMPARTMENTS = 4


def rates(x, theta):
    n = torch.sum(x, dim=-1)
    a_expose = theta[..., 0] * x[..., 0] * x[..., 2] / n
    a_progress = theta[..., 1] * x[..., 1]
    a_recover = theta[..., 2] * x[..., 2]
    return torch.stack([a_expose, a_progress, a_recover], dim=-1)


def initial_cloud(generator, shape, n_population, mu):
    """``[*shape, 4]`` float32; draws one Poisson per entry of ``shape``."""
    rate = torch.full(tuple(shape), float(mu), dtype=torch.float32, device=generator.device)
    i0 = torch.poisson(rate, generator=generator)
    zero = torch.zeros_like(i0)
    return torch.stack([float(n_population) - i0, zero, i0, zero], dim=-1)


def ode_rhs(y, theta):
    """The mean-field ODE (epitpu_torch/ode/solve.py:seir_rhs), N summed left
    to right."""
    beta, alpha, gamma = theta[0], theta[1], theta[2]
    n = y[0] + y[1] + y[2] + y[3]
    s, e, i = y[0], y[1], y[2]
    return torch.stack([-beta * s * i / n, beta * s * i / n - alpha * e, alpha * e - gamma * i,
                        gamma * i])
