"""Bootstrap particle filter over a batch of chains (torch counterpart of
``epitpu.smc.filter``).

The cloud is ``[chains, N, C]``; time is a Python loop.  Reference timing:
at step p (1..T-1) the weights compare ``Y[p-1]`` with the states from step
p-1, so ``Y[T-1]`` never enters the likelihood, and
``logZ += logsumexp(logw) - log N`` (in the weight-carrying form,
``logZ += logsumexp(lw + logw)`` with normalized carried ``lw``).

Propagation is ``epitpu_torch.sim.tauleap.advance``: on the card one launch
of the tau-leap kernel per filter step for all chains and particles.  The
binomial weighting is one launch of its kernel a step on the card
(``epitpu_torch.observe.make_binomial_obs``), and so is the likelihood
update (``epitpu_torch.ops.loglik_cuda.loglik_update``: the log-sum-exp, the
increment of logZ and the normalized carry, in a fixed order of summation
that depends on N alone), and so is a resampling step of the systematic kind
(``epitpu_torch.ops.resample_cuda.systematic_step``: the ancestors, the
cloud's gather and the carried weights' reset, its sums also in an order
fixed by N; the uniforms stay a ``torch.rand`` of the filter's generator);
the other kinds of resampling are plain torch.  Each phase runs in
the ``epitpu_torch.profiling.scope`` of epitpu's named scope (``pf_init``,
``pf_scan`` and, inside it, ``pf_weight``, ``pf_loglik``, ``pf_resample``,
``pf_propagate``).

With a ``mesh`` (``epitpu_torch.dist.make_mesh``) the run is the unsharded
run, split: this rank holds its chains' share of each chain's particles.
Every random draw is made at the unsharded shape and sliced (the initial
cloud, the resampling uniforms); the log-weights are all-gathered over the
particle axis, so log-sum-exp, ESS and the ancestors come from the
unsharded code on ``[chains, N]``, in global particle ids; resampling
gathers the cloud; and the tau-leap kernel's lane map gives each lane the
Philox counter of the same particle unsharded.  On the card the rounding
of a torch reduction or cumulative sum along a row follows the number of
rows (PyTorch splits a row over more blocks when there are fewer rows), so a
chain shard runs its ESS and the plain kinds of resampling at the unsharded
row count, its rows at their global place among every chain's rows; the
likelihood update's and the systematic step's rows depend on nothing but
their own values and N, so they run on the shard's rows alone.  So the
gathered result equals the unsharded run's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models.base import CompartmentModel
from ..ops.loglik_cuda import loglik_update
from ..ops.resample_cuda import systematic_step
from ..profiling import scope
from ..sim.samplers import PHILOX_SAMPLERS
from ..sim.tauleap import advance
from .resample import resample_particles


def at_global_rows(fn, t, c0, n_rows):
    """``fn`` of a chain shard's rows ``t [chains, N]``, run on ``[n_rows,
    N]`` with them at their global rows ``c0..`` (module docstring): its
    random draws are made for every chain and sliced.  So every chain shard
    does the unsharded run's row work on a tensor of every chain's rows:
    this work does not shrink as chain shards are added
    (``tests/shard_padding_probe.py`` times it)."""
    chains = t.shape[0]
    if n_rows == chains:
        return fn(t)
    every = t.new_zeros((n_rows,) + t.shape[1:])
    every[c0:c0 + chains] = t
    return fn(every)[c0:c0 + chains]


@dataclasses.dataclass
class FilterResult:
    """log_likelihood ``[chains]`` (-inf where a step degenerated);
    log_zetas ``[chains, T]``; hidden ``[chains, T, N, C]`` and ancestry
    ``[chains, T, N]`` (``T`` collapses to 1 with ``record_history=False``);
    degenerate ``[chains]``; final_logw ``[chains, N]`` normalized terminal
    log-weights.  From a sharded run: this rank's chains; hidden and
    ancestry hold its particles (ancestors in global ids), final_logw every
    particle of its chains."""

    log_likelihood: torch.Tensor
    log_zetas: torch.Tensor
    hidden: torch.Tensor
    ancestry: torch.Tensor
    degenerate: torch.Tensor
    final_logw: torch.Tensor


def particle_filter(
    model: CompartmentModel,
    obs_loglik,
    y,
    theta,
    obs_param,
    stream,
    generator,
    n_particles: int = 1000,
    n_population=4820,
    mu=20.0,
    steps_per_unit: int = 20,
    resampling: str = "systematic",
    x0: Optional[torch.Tensor] = None,
    sampler: str = "fast",
    resample_threshold: float = 1.0,
    resample_every: int = 1,
    record_history: bool = True,
    mesh=None,
) -> FilterResult:
    """Filter ``y: [T, obs_dim]`` for every chain of ``theta: [chains, d]``.

    ``obs_param`` is a float or a ``[chains]`` tensor.  ``stream`` (a
    ``PhiloxStream``) feeds propagation; ``generator`` (a ``torch.Generator``
    on the same device) the initial cloud and the resampling uniforms.
    ``resample_threshold < 1`` resamples only when the ESS falls below that
    fraction of N; ``resample_every = k`` resamples only on every k-th step,
    carrying weights between.  ``n_population`` and ``mu`` go to the
    model's initial cloud: scalars, or ``[K]`` vectors for a K-group model.
    ``x0`` may override that cloud (``[chains, N, C]``).

    ``mesh`` shards the run (module docstring): ``theta`` and ``obs_param``
    hold this rank's chains, ``n_particles`` is each chain's global count,
    of which the rank holds ``n_particles / P`` (an ``x0`` is that local
    cloud).  Every rank of the mesh must make the same calls.  The exact
    sampler draws per call, not per lane, and runs unsharded only.
    """
    device = generator.device
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)
    chains = theta.shape[0]
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    t_len = y.shape[0]
    obs_param = torch.as_tensor(obs_param, dtype=torch.float32, device=device)
    if obs_param.dim() == 1:
        obs_param = obs_param[:, None, None]  # per chain, broadcast over [N, obs]
    log_n = math.log(n_particles)

    c_shards, p_shards = (1, 1) if mesh is None else (mesh.n_chain_shards,
                                                       mesh.n_particle_shards)
    if n_particles % p_shards:
        raise ValueError(f"n_particles={n_particles} not divisible by {p_shards} particle shards")
    if c_shards * p_shards > 1 and sampler not in PHILOX_SAMPLERS:
        raise ValueError(f"sampler={sampler!r} draws per call, not per lane: a sharded "
                         "filter needs a Philox sampler")
    n_local = n_particles // p_shards
    c0 = 0 if mesh is None else mesh.chain_index * chains
    p0 = 0 if mesh is None else mesh.particle_index * n_local
    n_rows = chains * c_shards
    # one shard's lanes are the unsharded launch's: no map
    lane_map = None if c_shards * p_shards == 1 else (c0, n_local, n_particles, p0)

    def across(t):
        """``t [chains, n_local, ...]`` with every shard's particles."""
        return t if mesh is None else mesh.gather_particles(t, dim=1)

    def mine(t):
        """This shard's particles of ``t [chains, N, ...]``."""
        return t if mesh is None else t[:, p0:p0 + n_local]

    def unsharded_rows(fn, t):
        return at_global_rows(fn, t, c0, n_rows)

    def resample(t, x, skip=None):
        """(this shard's ancestors, their states, the carried log-weights
        after: ``-log N`` but where ``skip``, None without it) of a
        resampling step on the log-weights ``t [chains, N]``."""
        if resampling == "systematic":
            u = torch.rand((n_rows, 1), generator=generator, device=device, dtype=t.dtype)
            return systematic_step(t, u[c0:c0 + chains], across(x), skip, p0, n_local)
        anc = unsharded_rows(lambda t: resample_particles(resampling, t, generator)[0], t)
        if skip is not None:
            anc = torch.where(skip[:, None], iota, anc)
        anc = mine(anc)
        lw_next = None if skip is None else torch.where(
            skip[:, None], t, torch.full_like(t, -log_n))
        return anc, gather(across(x), anc), lw_next

    with scope("pf_init"):
        if x0 is None:
            x0 = model.init_fn(generator, (chains * c_shards, n_particles), n_population, mu)
            if mesh is not None:
                x0 = x0[c0:c0 + chains, p0:p0 + n_local]
        x = x0.to(torch.float32).contiguous()

    conditional = resample_threshold < 1.0
    scheduled_mode = resample_every > 1
    carry_weights = conditional or scheduled_mode
    iota = torch.arange(n_particles, device=device).expand(chains, n_particles)

    lw = torch.full((chains, n_particles), -log_n, device=device)
    log_z = torch.zeros(chains, device=device)
    degen = torch.zeros(chains, dtype=torch.bool, device=device)
    xs, ancs, log_zs = [x], [torch.zeros_like(mine(iota))], [log_z]

    def gather(x, anc):
        return torch.gather(x, 1, anc[..., None].expand(*anc.shape, x.shape[-1]))

    with scope("pf_scan"):
        for p in range(t_len - 1):
            with scope("pf_weight"):
                logw = across(obs_loglik(y[p], model.observe_map(x), obs_param))  # [chains, N]
            if not carry_weights:
                with scope("pf_loglik"):
                    log_z, _, step_degen = loglik_update(logw, log_z, log_n)
                with scope("pf_resample"):
                    anc, x_res, _ = resample(logw, x)
                lw_next = lw
            else:
                with scope("pf_loglik"):
                    log_z, lw_new, step_degen = loglik_update(logw, log_z, log_n, lw)
                with scope("pf_resample"):
                    if (p + 1) % resample_every == 0:
                        skip = step_degen
                        if conditional:
                            ess = 1.0 / unsharded_rows(
                                lambda t: torch.sum(torch.exp(2.0 * t), dim=-1), lw_new)
                            skip = skip | ~(ess < resample_threshold * n_particles)
                        anc, x_res, lw_next = resample(lw_new, x, skip)
                    else:
                        anc, x_res, lw_next = mine(iota), x, lw_new
            with scope("pf_propagate"):
                x = advance(model, x_res, theta[:, None, :], stream, steps_per_unit,
                            sampler, generator, lane_map)
            lw = lw_next
            degen = degen | step_degen
            log_zs.append(log_z)
            if record_history:
                xs.append(x)
                ancs.append(anc)

    return FilterResult(
        log_likelihood=log_z,
        log_zetas=torch.stack(log_zs, dim=1),
        hidden=torch.stack(xs, dim=1),
        ancestry=torch.stack(ancs, dim=1),
        degenerate=degen,
        final_logw=lw,
    )


# epitpu's jax.jit wrapper of the same function (epitpu/smc/filter.py:288);
# torch runs eagerly, so the name is the function itself
particle_filter_jit = particle_filter
