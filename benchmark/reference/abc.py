"""ABC rejection batches recomputed in plain torch: the reference that judges
the program's ABC calls (reference abc_algo.py:17-109, distance :10-13).

Batch ``b`` of a call with seed ``s``: a ``torch.Generator`` seeded once per
call with ``derive_seed(s, 0)`` draws the batch's uniform-prior thetas and
then its Poisson initial states around ``observed[0]``; each candidate is
simulated over the observed days by the tau-leap reference on Philox key
``derive_seed(s, 1, b)``, call offset 0; it is accepted when
``(mean_t |I - I_obs| + mean_t |R - R_obs|) / 2 <= threshold``.  A call
takes batches until ``n_samples`` are accepted and keeps the first
``n_samples`` in batch order.
"""
from __future__ import annotations

import torch

from . import tauleap
from .philox import derive_seed


def distance(sim, observed):
    """sim ``[K, T, C]``, observed ``[T, C]`` -> ``[K]``; the means run over
    the time axis of ``[T, K]`` views, so they add in the program's order."""
    sim = sim.transpose(0, 1)
    d_i = torch.mean(torch.abs(sim[:, :, 1] - observed[:, None, 1]), dim=0)
    d_r = torch.mean(torch.abs(sim[:, :, 2] - observed[:, None, 2]), dim=0)
    return 0.5 * (d_i + d_r)


def replay_call(model, seed, observed, n_batches, batch_size, lo, hi, threshold,
                steps_per_unit, dtype=torch.float32):
    """Every candidate of the first ``n_batches`` batches of the call with
    ``seed``: (thetas [n, d], trajectories [n, T, C], accepted [n] bool), in
    candidate order.  The thetas are drawn in float32 whatever ``dtype``
    the simulation and the distance take."""
    device = observed.device
    observed = observed.to(torch.float32)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 0))
    t_max = observed.shape[0] - 1
    thetas, trajs, accepted = [], [], []
    for b in range(n_batches):
        theta = lo + (hi - lo) * torch.rand((batch_size, lo.shape[0]), generator=gen,
                                            device=device)
        x0 = torch.poisson(observed[0].expand(batch_size, observed.shape[1]).contiguous(),
                           generator=gen)
        sim = tauleap.simulate(model, x0, theta, derive_seed(seed, 1, b), 0, t_max,
                               steps_per_unit, False, dtype)
        accepted.append(distance(sim, observed.to(dtype)) <= threshold)
        thetas.append(theta)
        trajs.append(sim)
    return torch.cat(thetas), torch.cat(trajs), torch.cat(accepted)
