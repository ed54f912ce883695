"""The observed data of a configuration, made by the benchmark itself.

The recipe of bench_torch.py's ``dataset`` and of the runner's
``generate_dataset`` (epitpu_torch/cli/run.py:57-95 at commit 0f2ab30): the
mean-field ODE from ``y0`` at ``theta_true`` by classic RK4 in float32, 10
steps between the points of ``linspace(0, t_max, grid_points)``, each
integer day taking the last grid row whose ceiled time is that day
(reference pmcmc.py:66-73); then binomial thinning by
``numpy.random.default_rng(seed)`` (observation "binomial"), or the exact
states (observation "none", ABC).  The RK4 is a copy of
epitpu_torch/ode/solve.py at the same commit, in the same operation order.
"""
from __future__ import annotations

import numpy as np
import torch


def integrate(rhs, y0, theta, t_grid, substeps=10):
    y = torch.as_tensor(np.asarray(y0, dtype=np.float32))
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float32))
    t = torch.as_tensor(np.asarray(t_grid, dtype=np.float32))
    out = [y]
    for dt in t[1:] - t[:-1]:
        h = dt / substeps
        for _ in range(substeps):
            k1 = rhs(y, theta)
            k2 = rhs(y + 0.5 * h * k1, theta)
            k3 = rhs(y + 0.5 * h * k2, theta)
            k4 = rhs(y + h * k3, theta)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(y)
    return torch.stack(out).numpy()


def daily(t_grid, solution):
    t = np.ceil(np.asarray(t_grid)).astype(int)
    return np.stack([solution[np.nonzero(t == day)[0][-1]] for day in range(int(t[-1]) + 1)])


def observations(data: dict, model) -> np.ndarray:
    """``[T, C]`` float32 observations of a configuration's ``data`` block;
    ``model`` is its reference model module (``ode_rhs``)."""
    t = np.linspace(0, data["t_max"], data["grid_points"])
    latent = daily(t, integrate(model.ode_rhs, data["y0"], data["theta_true"], t))
    if data["observation"] == "binomial":
        rng = np.random.default_rng(data["seed"])
        latent = rng.binomial(np.round(latent).astype(int), data["obs_param"])
    elif data["observation"] != "none":
        raise ValueError(f"unknown observation {data['observation']!r}")
    return np.asarray(latent, dtype=np.float32)
