"""ABC rejection sampling, a whole candidate batch at a time (torch
counterpart of ``epitpu.abc.rejection``).

Each batch draws uniform-prior thetas and Poisson-jittered initial states
around ``observed[0]`` on the device, runs every candidate through the
tau-leap kernel in one ``simulate_lanes`` launch (daily states recorded
directly; a model whose reactions share a source takes the plain twin on
the card, ``tauleap_cuda.route``), and computes the distance on the
device.  The host loop:

  * syncs only the ``[K]`` accept mask per batch; trajectories and thetas
    stay on the device and are fetched only for accepted candidates;
  * enqueues the next batch before fetching the current batch's accepted
    rows, and launches nothing once the current batch completes the sample.

Spans (``epitpu_torch.profiling``): ``abc_call`` the whole call,
``abc_batch_launch`` the enqueue of each batch (its id the batch index),
``abc_mask_sync`` the accept mask's copy, ``abc_fetch`` the accepted rows'
indexing and copy; counters ``abc.batches`` and ``abc.host_copies`` (each
blocking device-to-host copy: the mask, the accepted thetas, the accepted
trajectories).

Randomness: a ``torch.Generator`` on the device seeded from
``derive_seed(seed, 0)`` for thetas and initial states, and for batch ``b``
the Philox seed ``derive_seed(seed, 1, b)`` for the simulation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import CompartmentModel
from ..ops.tauleap_cuda import route, simulate_lanes
from ..profiling import count, scope, spanned
from ..rng import derive_seed

# "auto" and "pallas" both name simulate_lanes: on CUDA the kernel, or the
# plain twin on the card for a model whose reactions share a source (the
# counterpart of the JAX package's "xla" scan, chosen by the model), and the
# twin on the CPU
BACKENDS = ("auto", "pallas")


def reference_sir_distance(sim_traj, observed):
    """(mean |I_sim - I_obs| + mean |R_sim - R_obs|) / 2 over time
    (reference abc_algo.py:10-13), batched over candidates: columns 1 and 2
    whatever the model.  sim_traj: [T, K, C]; observed: [T, C] -> [K]."""
    d_i = torch.mean(torch.abs(sim_traj[:, :, 1] - observed[:, None, 1]), dim=0)
    d_r = torch.mean(torch.abs(sim_traj[:, :, 2] - observed[:, None, 2]), dim=0)
    return 0.5 * (d_i + d_r)


@dataclasses.dataclass
class ABCResult:
    """posterior: dict name -> [n_samples] accepted draws; trajectories:
    [n_samples, T, C] accepted simulated trajectories; trials: candidate
    count; backend: the path that simulated, "cuda" (the kernel, on a
    hand-written or generated functor), "cuda-plain" (the plain twin on the
    card, the declared route of a model whose reactions share a source) or
    "cpu" (the twin)."""

    posterior: Dict[str, np.ndarray]
    trajectories: np.ndarray
    trials: int
    backend: str = "cpu"

    @property
    def acceptance_rate(self):
        return self.trajectories.shape[0] / max(self.trials, 1)


def _batch(model, gen, observed, batch_size, lo, hi, sim_seed, t_max,
           steps_per_unit, distance_fn):
    """One candidate batch: (thetas [K, d], sim [K, T, C], dist [K]), all
    on the device and not yet synced."""
    d = lo.shape[0]
    thetas = lo + (hi - lo) * torch.rand((batch_size, d), generator=gen,
                                          device=observed.device)
    rate = observed[0].expand(batch_size, observed.shape[1]).contiguous()
    x0 = torch.poisson(rate, generator=gen)
    sim = simulate_lanes(model, x0, thetas, sim_seed, 0, t_max, steps_per_unit)
    dist = distance_fn(sim.transpose(0, 1), observed)
    return thetas, sim, dist


@spanned("abc_call")
def abc_rejection(
    model: CompartmentModel,
    seed: int,
    observed_data,
    n_samples: int,
    threshold: float,
    priors: Dict[str, tuple],
    distance_fn: Callable = reference_sir_distance,
    batch_size: int = 512,
    steps_per_unit: int = 20,
    max_trials: int = 10_000_000,
    backend: str = "auto",
    device=None,
) -> ABCResult:
    """Accept candidates whose distance to ``observed_data`` ([T, C]) is at
    most ``threshold`` until ``n_samples`` are accepted or ``max_trials``
    candidates are spent.  ``priors`` maps parameter name -> (low, high) in
    the model's flat-theta order, e.g. ``{"beta": (0, 5), "gamma": (0, 5)}``.
    ``device`` defaults to that of ``observed_data`` when it is a tensor,
    else ``cuda``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r}: the port simulates with the per-lane kernel "
            f"on CUDA and its twin on the CPU, named by {BACKENDS}"
        )
    device = resolve_device(device, like=observed_data)
    observed = torch.as_tensor(observed_data, dtype=torch.float32, device=device)
    t_max = observed.shape[0] - 1
    names = list(priors.keys())
    lo = torch.tensor([priors[n][0] for n in names], dtype=torch.float32, device=device)
    hi = torch.tensor([priors[n][1] for n in names], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, 0))

    def launch(batch_index):
        with scope("abc_batch_launch", batch_index):
            count("abc.batches")
            return _batch(model, gen, observed, batch_size, lo, hi,
                          derive_seed(seed, 1, batch_index), t_max, steps_per_unit,
                          distance_fn)

    acc_thetas, acc_trajs = [], []
    trials = 0
    n_accepted = 0
    pending = launch(0)
    while n_accepted < n_samples and trials < max_trials:
        thetas_d, sim_d, dist_d = pending
        with scope("abc_mask_sync"):
            mask = (dist_d <= threshold).cpu().numpy()  # the only per-batch sync
        count("abc.host_copies")
        trials += batch_size
        n_found = int(mask.sum())
        if n_accepted + n_found < n_samples and trials < max_trials:
            # enqueued before this batch's rows are fetched
            pending = launch(trials // batch_size)
        if n_found:
            with scope("abc_fetch"):
                idx = torch.from_numpy(np.nonzero(mask)[0]).to(device)
                acc_thetas.append(thetas_d[idx].cpu().numpy())
                acc_trajs.append(sim_d[idx].cpu().numpy())
            count("abc.host_copies", 2)
            n_accepted += n_found

    if n_accepted == 0:
        raise RuntimeError(
            f"ABC accepted nothing in {trials} trials at threshold {threshold}"
        )
    thetas = np.concatenate(acc_thetas)[:n_samples]
    trajs = np.concatenate(acc_trajs)[:n_samples]
    posterior = {n: thetas[:, j] for j, n in enumerate(names)}
    backend = device.type
    if backend == "cuda" and route(model) == "plain":
        backend = "cuda-plain"
    return ABCResult(posterior=posterior, trajectories=trajs, trials=trials,
                     backend=backend)
