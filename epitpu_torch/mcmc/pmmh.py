"""Particle-marginal Metropolis-Hastings over a batch of chains (torch
counterpart of ``epitpu.mcmc.pmmh``).

Chains are the leading tensor dimension and iterations a Python loop; each
iteration runs one particle filter for all chains at once.  The semantics
are the JAX package's:

* a proposal with a negative component, or whose filter degenerates (-inf
  log-likelihood), is rejected;
* with an inferred reporting probability, the last theta component is
  clamped to [0, 1] for the filter and stored clamped;
* the MVN random-walk proposal densities cancel, so the log MH ratio is
  ``ll' - ll``;
* after ``adapt_start`` iterations the proposal covariance is the ddof=0
  Welford covariance plus 1e-4 I, optionally pooled over all chains;
* ``target_acceptance`` turns on Robbins-Monro scaling of the proposal.

Randomness is indexed by absolute chain row, as the JAX package's key
stream is: row ``i`` (row 0 is the init search) draws from three streams
seeded by ``derive_seed(seed, i, use)`` -- a ``torch.Generator`` on the
device for the proposal, the filter's initial cloud and resampling and the
MH uniform (use 0), a ``PhiloxStream`` for the tau-leap kernel (use 1), and
a second generator for the ancestral path (use 2).  So:

* ``n_iters`` names the total chain length and ``segment_len`` limits a
  call to that many rows; concatenated segments are bit-identical to one
  unsegmented run (``epitpu/mcmc/pmmh.py:319-330``);
* a theta-only run (``store_trajectories=False``) gives the theta chain of
  a storing run bit for bit, since the path draws from its own generator.

``log_every > 0`` prints a telemetry line on every row ``i`` with
``i % log_every == 0`` (rows 1.. of a run; the init row 0 prints nothing),
in ``epitpu.mcmc.pmmh._default_telemetry``'s two formats: one chain's
line, or a line aggregated over the chain batch.  Only those rows read the
chains back to the host, and telemetry draws no random numbers, so the
chains are the same with it on or off.

With a ``mesh`` (``epitpu_torch.dist``) ``n_chains`` and ``n_particles``
are global: this rank runs ``n_chains / C`` chains, each filter holds
``n_particles / P`` of a chain's particles.  Every draw is made for all
chains and sliced (proposals, the init search's candidates, the MH
uniforms; the filter's and the path's draws likewise), and pooling and the
pooled Robbins-Monro alpha run the unsharded sums on chains all-gathered
over the chain axis, so the gathered chains are the unsharded run's.
Telemetry gathers the batch and prints on the mesh's first rank.

Each phase runs in the ``epitpu_torch.profiling.scope`` of epitpu's named
scope: ``pmmh_init`` (the init search), ``pmmh_scan`` (the row loop) and,
inside it, ``mh_propose``, ``mh_accept``, ``adapt_welford``; ``path_sample``
around each filter's ancestral path.  Two spans of the port's own frame
them: ``pmmh_call`` a whole ``particle_mcmc_chains`` call, set-up and output
stacking included, and ``pmmh_row`` each row of the scan, its id the row.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import CompartmentModel
from ..profiling import scope, spanned
from ..rng import PhiloxStream, derive_seed
from ..smc.filter import particle_filter
from ..smc.paths import sample_path
from .adaptive import Welford


@dataclasses.dataclass
class PMMHState:
    """Sampler state after the row with index ``step`` (all ``[chains, ...]``).
    ``trajectory`` is ``[chains, T, C]``, or ``[chains, 0, 0]`` for a
    theta-only run."""

    theta: torch.Tensor
    log_likelihood: torch.Tensor
    trajectory: torch.Tensor
    welford: Welford
    acceptances: torch.Tensor
    step: torch.Tensor
    log_scale: torch.Tensor


@dataclasses.dataclass
class PMMHResult:
    """thetas ``[chains, rows, d]``; log_likelihoods ``[chains, rows]``;
    sampled_trajs ``[chains, rows, T, C]`` (``[chains, rows, 0, 0]`` for a
    theta-only run); acceptances ``[chains]``; final_state.  From
    ``particle_mcmc``, the same without the chains axis."""

    thetas: torch.Tensor
    log_likelihoods: torch.Tensor
    sampled_trajs: torch.Tensor
    acceptances: torch.Tensor
    final_state: PMMHState

    def acceptance_rate(self):
        return self.acceptances.float() / self.thetas.shape[-2]


def _split_theta(theta, infer_obs_param, fixed_obs_param):
    """theta ``[..., d]`` -> (model_theta, obs_param, stored_theta)."""
    if infer_obs_param:
        p = torch.clamp(theta[..., -1], 0.0, 1.0)
        stored = torch.cat([theta[..., :-1], p[..., None]], dim=-1)
        return theta[..., :-1], p, stored
    return theta, fixed_obs_param, theta


def default_telemetry(i, accepts, theta, log_z):
    """The reference's live progress line (pmcmc.py:320-321, 405-406) for
    row ``i`` from numpy arrays with a leading chains axis: iteration,
    acceptance ratio ``accepts.mean() / (i + 1)``, theta and log zeta-hat;
    for more than one chain the theta mean and sd over chains and the mean
    log zeta-hat."""
    ratio = float(np.mean(accepts)) / max(i + 1, 1)
    theta = np.atleast_2d(theta)
    if theta.shape[0] == 1:
        th = ", ".join(f"{v:.4g}" for v in theta[0].tolist())
        print(f"[pmmh] iter={i} acc_ratio={ratio:.3f} theta=[{th}] "
              f"log_zeta={float(np.ravel(log_z)[0]):.4f}", flush=True)
    else:
        mean = ", ".join(f"{v:.4g}" for v in theta.mean(axis=0).tolist())
        sd = ", ".join(f"{v:.3g}" for v in theta.std(axis=0).tolist())
        print(f"[pmmh] iter={i} chains={theta.shape[0]} acc_ratio={ratio:.3f} "
              f"theta_mean=[{mean}] theta_sd=[{sd}] "
              f"log_zeta_mean={float(np.mean(log_z)):.4f}", flush=True)


@spanned("pmmh_call")
def particle_mcmc_chains(
    model: CompartmentModel,
    obs_loglik,
    y,
    parameters,
    h,
    seed: int = 0,
    device=None,
    n_chains: int = 8,
    adaptive: bool = False,
    sigma=None,
    n_iters: int = 1000,
    obs_param=0.1,
    infer_obs_param: bool = False,
    n_particles: int = 1000,
    n_population=4820,
    mu=20.0,
    steps_per_unit: int = 20,
    resampling: str = "systematic",
    resample_threshold: float = 1.0,
    resample_every: int = 1,
    adapt_start: int = 1000,
    n_init_attempts: int = 16,
    sampler: str = "fast",
    init_state: Optional[PMMHState] = None,
    segment_len: Optional[int] = None,
    pooled_adaptation: bool = False,
    target_acceptance: Optional[float] = None,
    store_trajectories: bool = True,
    log_every: int = 0,
    telemetry_fn=None,
    mesh=None,
) -> PMMHResult:
    """Run ``n_chains`` PMMH chains on ``device`` (by default the device of
    ``y`` when it is a tensor, else ``cuda``).  ``n_iters`` is the total
    chain length.  A fresh call makes rows ``0..segment_len-1`` (all
    ``n_iters`` rows without ``segment_len``), row 0 from the vectorised
    init search (``n_chains x n_init_attempts`` candidates around
    ``parameters`` in one filter batch; the first valid one per chain
    wins).  A call with ``init_state`` (the ``final_state`` of a call with
    the same ``seed``) makes rows ``step+1..step+segment_len`` and needs
    ``segment_len``.  ``telemetry_fn(i, accepts, theta, log_z)`` (numpy
    arrays over chains) replaces ``default_telemetry`` on the
    ``log_every`` rows.  ``mesh`` shards the run (module docstring): the
    result and ``init_state`` hold this rank's chains, rows
    ``mesh.chain_index * n_chains / C`` on."""
    c_shards = 1 if mesh is None else mesh.n_chain_shards
    if init_state is not None:
        device = init_state.theta.device
        n_chains = init_state.theta.shape[0] * c_shards
        if segment_len is None:
            raise ValueError(
                "resumed calls (init_state given) must pass segment_len, "
                "the number of new rows to produce"
            )
        first_row = int(init_state.step.reshape(-1)[0]) + 1
    else:
        first_row = 0
    n_rows = n_iters - first_row if segment_len is None else int(segment_len)
    if n_rows < 1 or first_row + n_rows > n_iters:
        raise ValueError(
            f"rows {first_row}..{first_row + n_rows - 1} do not fit a chain of "
            f"n_iters={n_iters}"
        )
    device = resolve_device(device, like=y)
    if n_chains % c_shards:
        raise ValueError(f"n_chains={n_chains} not divisible by {c_shards} chain shards")
    n_local = n_chains // c_shards
    c0 = 0 if mesh is None else mesh.chain_index * n_local

    def mine(t):
        """This rank's chains of ``t``, drawn for all ``n_chains``."""
        return t if mesh is None else t[c0:c0 + n_local]

    def all_chains(t):
        return t if mesh is None else mesh.gather_chains(t, dim=0)

    if adaptive and init_state is None and adapt_start >= n_iters - 1:
        warnings.warn(
            f"adaptive=True but adapt_start={adapt_start} >= n_iters-1="
            f"{n_iters - 1}: the proposal covariance will never adapt",
            stacklevel=2,
        )
    gen = torch.Generator(device=device)
    path_gen = torch.Generator(device=device)

    def seed_row(row):
        """Reseed both generators for chain row ``row``; returns the row's
        Philox stream."""
        gen.manual_seed(derive_seed(seed, row, 0))
        path_gen.manual_seed(derive_seed(seed, row, 2))
        return PhiloxStream(derive_seed(seed, row, 1), device)

    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    parameters = torch.as_tensor(parameters, dtype=torch.float32, device=device)
    d = parameters.shape[0]
    sigma0 = (torch.eye(d, device=device) if sigma is None
              else torch.as_tensor(sigma, dtype=torch.float32, device=device))
    h = float(h)
    carried = resample_threshold < 1.0 or resample_every > 1

    def run_filter(model_theta, o_param, stream):
        res = particle_filter(
            model, obs_loglik, y, model_theta, o_param, stream, gen,
            n_particles=n_particles, n_population=n_population, mu=mu,
            steps_per_unit=steps_per_unit, resampling=resampling,
            sampler=sampler, resample_threshold=resample_threshold,
            resample_every=resample_every, record_history=store_trajectories, mesh=mesh,
        )
        if not store_trajectories:
            return res.log_likelihood, None
        with scope("path_sample"):
            traj = sample_path(path_gen, res.hidden, res.ancestry,
                               res.final_logw if carried else None, mesh)
        return res.log_likelihood, traj

    def propose(center, cov, log_s=None):
        z = mine(torch.randn((n_chains,) + tuple(center.shape[1:]), generator=gen,
                             device=device))
        chol = torch.linalg.cholesky_ex(h * cov).L  # no error check: no host sync
        if log_s is not None:
            chol = chol * torch.exp(0.5 * log_s)[..., None, None]
        # elementwise product-sum: no float32 matmul that could run in TF32
        return center + (chol * z[..., None, :]).sum(-1)

    if init_state is None:
        with scope("pmmh_init"):
            stream = seed_row(0)
            centers = parameters.expand(n_local, n_init_attempts, d)
            cand = propose(centers, sigma0)
            nonneg = (cand >= 0.0).all(-1)
            m_theta, o_param, stored = _split_theta(
                cand.reshape(-1, d), infer_obs_param, obs_param
            )
            ll_c, traj_c = run_filter(m_theta, o_param, stream)
            ll_c = ll_c.reshape(n_local, n_init_attempts)
            valid = nonneg & torch.isfinite(ll_c)
            first = torch.argmax(valid.to(torch.int32), dim=1)
            rows = torch.arange(n_local, device=device)
            any_valid = valid.any(1)
            theta = torch.where(
                any_valid[:, None],
                stored.reshape(n_local, n_init_attempts, d)[rows, first],
                torch.clamp(parameters, min=0.0).expand(n_local, d),
            )
            ll = torch.where(any_valid, ll_c[rows, first],
                             torch.tensor(-math.inf, device=device))
            traj = (None if traj_c is None
                    else traj_c.reshape(n_local, n_init_attempts, *traj_c.shape[1:])[rows, first])
        w = Welford.init(n_local, d, device).update(theta)
        accepts = torch.ones(n_local, dtype=torch.int32, device=device)
        step = 0
        log_s = torch.zeros(n_local, device=device)
        out_theta, out_ll, out_traj = [theta], [ll], [traj]
    else:
        theta = init_state.theta.to(torch.float32)
        ll = init_state.log_likelihood.to(torch.float32)
        traj = init_state.trajectory if store_trajectories else None
        if store_trajectories and traj.shape[-2] != y.shape[0]:
            raise ValueError("init_state has no [T, C] trajectory to continue a storing run")
        w = init_state.welford
        accepts = init_state.acceptances.to(torch.int32)
        step = first_row - 1
        log_s = init_state.log_scale.to(torch.float32)
        out_theta, out_ll, out_traj = [], [], []

    with scope("pmmh_scan"):
        for i in range(step + 1, first_row + n_rows):
            with scope("pmmh_row", i):
                stream = seed_row(i)
                cov = sigma0
                if adaptive and i > adapt_start:
                    w_eff = w.pooled(mesh) if pooled_adaptation else w
                    cov = w_eff.covariance(jitter=1e-4)
                with scope("mh_propose"):
                    theta_prop = propose(theta, cov.expand(n_local, d, d),
                                         log_s if target_acceptance is not None else None)
                nonneg = (theta_prop >= 0.0).all(-1)
                m_theta, o_param, stored = _split_theta(theta_prop, infer_obs_param, obs_param)
                ll_prop, traj_prop = run_filter(m_theta, o_param, stream)

                with scope("mh_accept"):
                    log_ratio = ll_prop - ll
                    log_u = mine(torch.log(torch.rand(n_chains, generator=gen, device=device)))
                    ok = nonneg & torch.isfinite(ll_prop)
                    accept = ok & (log_u < log_ratio)
                    theta = torch.where(accept[:, None], stored, theta)
                    ll = torch.where(accept, ll_prop, ll)
                    if traj is not None:
                        traj = torch.where(accept[:, None, None], traj_prop, traj)
                if target_acceptance is not None:
                    alpha = torch.where(
                        ok, torch.exp(torch.clamp(log_ratio, max=0.0)), torch.zeros_like(ll)
                    )
                    if pooled_adaptation:
                        alpha = all_chains(alpha).mean().expand(n_local)
                    log_s = log_s + i ** -0.66 * (alpha - target_acceptance)
                with scope("adapt_welford"):
                    w = w.update(theta)
                accepts = accepts + accept.to(torch.int32)
                step = i
                if log_every and i % log_every == 0:
                    batch = [all_chains(t).cpu().numpy() for t in (accepts, theta, ll)]
                    if mesh is None or mesh.is_primary:
                        (telemetry_fn or default_telemetry)(i, *batch)
                out_theta.append(theta)
                out_ll.append(ll)
                out_traj.append(traj)

    thetas = torch.stack(out_theta, dim=1)
    if store_trajectories:
        trajs = torch.stack(out_traj, dim=1)
        traj_f = traj
    else:
        trajs = torch.zeros(n_local, thetas.shape[1], 0, 0, device=device)
        traj_f = torch.zeros(n_local, 0, 0, device=device)
    final_state = PMMHState(
        theta=theta,
        log_likelihood=ll,
        trajectory=traj_f,
        welford=w,
        acceptances=accepts,
        step=torch.full((n_local,), step, dtype=torch.int32, device=device),
        log_scale=log_s,
    )
    return PMMHResult(
        thetas=thetas,
        log_likelihoods=torch.stack(out_ll, dim=1),
        sampled_trajs=trajs,
        acceptances=accepts,
        final_state=final_state,
    )


def _map_state(state: PMMHState, fn) -> PMMHState:
    w = state.welford
    return PMMHState(theta=fn(state.theta), log_likelihood=fn(state.log_likelihood),
                     trajectory=fn(state.trajectory),
                     welford=Welford(fn(w.count), fn(w.mean), fn(w.m2)),
                     acceptances=fn(state.acceptances), step=fn(state.step),
                     log_scale=fn(state.log_scale))


def particle_mcmc(
    model: CompartmentModel,
    obs_loglik,
    seed: int,
    y,
    parameters,
    h,
    adaptive: bool = False,
    sigma=None,
    n_iters: int = 1000,
    obs_param=0.1,
    infer_obs_param: bool = False,
    n_particles: int = 1000,
    n_population=4820,
    mu=20.0,
    steps_per_unit: int = 20,
    resampling: str = "systematic",
    resample_threshold: float = 1.0,
    resample_every: int = 1,
    adapt_start: int = 1000,
    n_init_attempts: int = 16,
    sampler: str = "fast",
    init_state: Optional[PMMHState] = None,
    segment_len: Optional[int] = None,
    log_every: int = 0,
    telemetry_fn=None,
    pooled_adaptation: bool = False,
    target_acceptance: Optional[float] = None,
    store_trajectories: bool = True,
    device=None,
) -> PMMHResult:
    """One PMMH chain (``epitpu/mcmc/pmmh.py:278``), with ``seed`` in place
    of epitpu's ``key``: chain 0 of ``particle_mcmc_chains`` run with one
    chain and the same arguments, returned without the chains axis (thetas
    ``[rows, d]``, log_likelihoods ``[rows]``, sampled_trajs ``[rows, T,
    C]``; ``final_state``, and an ``init_state`` to continue, hold one
    chain).  epitpu's ``pool_axes`` and ``filter_axis_name`` name JAX vmap
    and mesh axes; here chains are batched by ``particle_mcmc_chains`` and
    sharded by ``epitpu_torch.dist``."""
    if pooled_adaptation:
        raise ValueError(
            "pooled_adaptation is only meaningful for chain-batched runs: use "
            "particle_mcmc_chains(..., pooled_adaptation=True)"
        )
    if init_state is not None:
        init_state = _map_state(init_state, lambda t: t[None])
    res = particle_mcmc_chains(
        model, obs_loglik, y, parameters, h, seed=seed, device=device, n_chains=1,
        adaptive=adaptive, sigma=sigma, n_iters=n_iters, obs_param=obs_param,
        infer_obs_param=infer_obs_param, n_particles=n_particles, n_population=n_population,
        mu=mu, steps_per_unit=steps_per_unit, resampling=resampling,
        resample_threshold=resample_threshold, resample_every=resample_every,
        adapt_start=adapt_start, n_init_attempts=n_init_attempts, sampler=sampler,
        init_state=init_state, segment_len=segment_len,
        target_acceptance=target_acceptance, store_trajectories=store_trajectories,
        log_every=log_every, telemetry_fn=telemetry_fn,
    )
    return PMMHResult(thetas=res.thetas[0], log_likelihoods=res.log_likelihoods[0],
                      sampled_trajs=res.sampled_trajs[0], acceptances=res.acceptances[0],
                      final_state=_map_state(res.final_state, lambda t: t[0]))


# epitpu's jax.jit wrapper (epitpu/mcmc/pmmh.py:614); torch runs eagerly
particle_mcmc_jit = particle_mcmc
