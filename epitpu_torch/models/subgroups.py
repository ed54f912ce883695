"""Multi-subgroup SIR with a K x K contact-rate matrix (torch counterpart
of ``epitpu.models.subgroups``).

State is ``[s_0, i_0, r_0, s_1, i_1, r_1, ...]`` (K groups x 3
compartments); theta is ``[K*K + 1]``: beta row-major, then gamma.
Reactions: infection into group g (slot g, ``s_g -> i_g``), then recovery
in group g (slot K + g, ``i_g -> r_g``).

The infection rate of group g is ``s_g * force_g / N_total``.  With
``reference_dynamics=True`` (the default) the force is
``sum_p beta[p, g] * i_p``, the transposed contact matrix of the reference's
SSA; ``False`` gives the textbook ``sum_j beta[g, j] * i_j`` (see
epitpu/models/subgroups.py:7-23 for why the two differ).  The force is an
explicit left-to-right sum over the groups, not a matrix product: the CUDA
kernel sums in the same order, and a float32 product on the card could run
in TF32.

``aggregated_obs=True`` (the reference's SIR_SUBGROUPS2) observes each
compartment summed over the groups.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .base import KernelSpec, _identity_observe, make_model


def _make_rates(k, transpose_beta):
    def beta(theta, row, col):
        return theta[..., row * k + col]

    def _rates(x, theta):
        s = [x[..., 3 * g] for g in range(k)]
        i = [x[..., 3 * g + 1] for g in range(k)]
        gamma = theta[..., k * k]
        n_total = torch.sum(x, dim=-1)
        infect = []
        for g in range(k):
            force = None
            for p in range(k):
                b = beta(theta, p, g) if transpose_beta else beta(theta, g, p)
                term = b * i[p]
                force = term if force is None else force + term
            infect.append(s[g] * force / n_total)
        recover = [gamma * i[g] for g in range(k)]
        return torch.stack(infect + recover, dim=-1)

    return _rates


def _make_init(k):
    def _init(generator, shape, n_population=None, mu=None):
        """Per group g: I ~ Poisson(mu[g]), S = n_population[g] - I, R = 0.
        ``n_population`` and ``mu`` are [K] (a scalar applies to every
        group)."""
        dev = generator.device
        mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
        pops = torch.as_tensor(n_population, dtype=torch.float32, device=dev)
        rate = mu.expand(*shape, k).contiguous()
        i0 = torch.poisson(rate, generator=generator)
        s0 = pops - i0
        x = torch.stack([s0, i0, torch.zeros_like(i0)], dim=-1)  # [*shape, K, 3]
        return x.reshape(*shape, 3 * k)

    return _init


def _aggregate_groups(k):
    def observe(x):
        return x.reshape(*x.shape[:-1], k, 3).sum(dim=-2)

    return observe


@lru_cache(maxsize=None)
def sir_subgroups_model(k=2, aggregated_obs=False, reference_dynamics=True):
    """K-group SIR.  ``aggregated_obs=True`` gives the reference's
    SIR_SUBGROUPS2 (observations summed over groups)."""
    comps = tuple(f"{c}_{g}" for g in range(k) for c in ("s", "i", "r"))
    stoich = np.zeros((2 * k, 3 * k), dtype=np.int32)
    source = np.zeros(2 * k, dtype=np.int32)
    for g in range(k):
        stoich[g, 3 * g + 0] = -1  # infection into group g: s_g -> i_g
        stoich[g, 3 * g + 1] = 1
        source[g] = 3 * g + 0
        stoich[k + g, 3 * g + 1] = -1  # recovery in group g: i_g -> r_g
        stoich[k + g, 3 * g + 2] = 1
        source[k + g] = 3 * g + 1
    theta_names = tuple(f"beta_{a}{b}" for a in range(k) for b in range(k)) + ("gamma",)
    return make_model(
        name="sir_subgroups2" if aggregated_obs else "sir_subgroups",
        compartments=comps,
        stoich=stoich,
        source=source,
        rate_fn=_make_rates(k, transpose_beta=reference_dynamics),
        theta_dim=k * k + 1,
        theta_names=theta_names,
        obs_dim=3 if aggregated_obs else 3 * k,
        observe_map=_aggregate_groups(k) if aggregated_obs else _identity_observe,
        init_fn=_make_init(k),
        kernel=KernelSpec("sir_subgroups", k, bool(reference_dynamics)),
        terminal_compartments=tuple(3 * g + 1 for g in range(k)),
    )
