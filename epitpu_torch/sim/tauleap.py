"""Euler-multinomial tau-leaping (torch counterpart of ``epitpu.sim.tauleap``).

Over a substep of length dt, reaction r with per-capita hazard mu_r fires
``Binomial(x[source_r], 1 - exp(-mu_r * dt))`` times; reactions that share a
source compartment draw the total exits first and split them by
conditional binomials.  States are float32 holding integer counts.

``advance`` and ``simulate`` run every lane through
``epitpu_torch.ops.tauleap_cuda.simulate_lanes``: on a CUDA tensor the
kernel on the model's hand-written or generated functor, or for a model
whose reactions share a source (competing hazards, below) the plain twin on
the card, chosen by the model's structure (``tauleap_cuda.route``) as
epitpu runs such a model through its XLA scan and not its Pallas kernel; on
a CPU tensor the plain twin, which is built from ``substep``.
``sampler="exact"`` is plain torch on the tensor's device (``torch.binomial``
with the caller's generator), as epitpu's exact sampler is plain XLA.
"""
from __future__ import annotations

import math

import torch

from ..models.base import CompartmentModel
from .samplers import PHILOX_SAMPLERS, SAMPLERS, exact_binomial


def _per_capita(model, x, rates):
    """mu[r] = a_r / x[source[r]], zero where the source is empty.  Rates
    are clipped at 0 so a negative proposal theta cannot produce NaN."""
    src_x = x[..., model.source.tolist()]
    return torch.where(
        src_x > 0, torch.clamp(rates, min=0.0) / torch.clamp(src_x, min=1.0),
        torch.zeros_like(src_x),
    )


def _exit_counts(model: CompartmentModel, x, mu, dt, binomial):
    """Per-reaction event counts ``[B, R]`` of one substep.  ``binomial(n,
    p, slot)`` draws ``n, p: [B, K]`` on draw slots ``slot .. slot+K-1``."""
    src = model.source.tolist()
    if model.sources_unique:
        p_fire = torch.clamp(-torch.expm1(-mu * dt), 0.0, 1.0)
        return binomial(x[..., src], p_fire, 0)
    # competing hazards: total exits per compartment, then split among the
    # compartment's reactions in order
    c_dim = model.num_compartments
    lam = torch.zeros_like(x).index_add_(
        1, torch.as_tensor(src, device=x.device), mu
    )
    p_exit = torch.clamp(-torch.expm1(-lam * dt), 0.0, 1.0)
    remaining = binomial(x, p_exit, 0)
    rem_rate = lam
    counts = []
    for r, c in enumerate(src):
        rem_c = remaining[:, c]
        if src[r + 1:].count(c) == 0:
            n_r = rem_c
        else:
            frac = torch.clamp(
                mu[:, r] / torch.clamp(rem_rate[:, c], min=1e-30), 0.0, 1.0
            )
            n_r = binomial(rem_c[:, None], frac[:, None], c_dim + r)[:, 0]
        counts.append(n_r)
        remaining = remaining.clone()
        remaining[:, c] -= n_r
        rem_rate = rem_rate.clone()
        rem_rate[:, c] -= mu[:, r]
    return torch.stack(counts, dim=-1)


def n_draw_slots(model: CompartmentModel) -> int:
    """Draw slots one substep of ``model`` uses per lane."""
    if model.sources_unique:
        return model.num_reactions
    return model.num_compartments + model.num_reactions


def substep(model: CompartmentModel, x, theta, dt, binomial):
    """One tau-leap substep of ``x: [B, C]`` with per-lane ``theta: [B, d]``.
    The stoichiometry is applied as per-reaction adds, not as a matrix
    product: a float32 product on the card may run in TF32 and round counts
    above 2,048."""
    rates = model.rate_fn(x, theta)
    mu = _per_capita(model, x, rates)
    n_events = _exit_counts(model, x, mu, dt, binomial)
    cols = list(x.unbind(-1))
    for r, row in enumerate(model.stoich.tolist()):
        for c, s in enumerate(row):
            if s:
                cols[c] = cols[c] + s * n_events[:, r]
    return torch.stack(cols, dim=-1)


def _lanes(x, theta):
    """Flatten ``x: [..., C]`` to lanes and ``theta: [..., d]`` (broadcasting
    against x's leading dims) to rows of consecutive lanes:
    ``(xb [B, C], th [B / lanes_per_theta, d], lanes_per_theta, lead)``.
    A theta that varies over leading dims only, and is broadcast over the
    trailing ones (one row per chain of ``[chains, N, C]`` particles), is
    read as it is; any other broadcast is expanded to one row per lane."""
    c_dim = x.shape[-1]
    lead = tuple(x.shape[:-1])
    xb = x.reshape(-1, c_dim).contiguous()
    th = torch.as_tensor(theta, dtype=torch.float32, device=x.device)
    d = th.shape[-1]
    shape = (1,) * (len(lead) + 1 - th.dim()) + tuple(th.shape[:-1])
    split = len(lead)
    while split > 0 and shape[split - 1] == 1:
        split -= 1
    if len(shape) == len(lead) and shape[:split] == lead[:split]:
        return xb, th.reshape(-1, d).contiguous(), math.prod(lead[split:]), lead
    return xb, th.expand(*lead, d).reshape(-1, d).contiguous(), 1, lead


def _exact_run(model, x, theta, t_max, n_sub, generator, dt):
    """The validation sampler on ``x``'s device: ``generator`` (a
    ``torch.Generator`` on that device, or None for torch's default) feeds
    ``torch.binomial``."""
    draw = lambda n, p, slot: exact_binomial(generator, n, p)
    out = [x]
    for _ in range(t_max):
        for _ in range(n_sub):
            x = substep(model, x, theta, dt, draw)
        out.append(x)
    return torch.stack(out, dim=1)


def _run_lanes(model, stream, x0, theta, t_max, n_sub, sampler,
               generator, final_only=False, lane_map=None, dt=None):
    """``t_max`` units of ``n_sub`` substeps of length ``dt`` (default
    ``1 / n_sub``)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown binomial sampler {sampler!r}; options {SAMPLERS}")
    dt = 1.0 / n_sub if dt is None else dt
    xb, th, lpt, lead = _lanes(x0.to(torch.float32), theta)
    if sampler in PHILOX_SAMPLERS:
        from ..ops.tauleap_cuda import simulate_lanes

        out = simulate_lanes(model, xb, th, stream.seed, stream.next_offset(),
                             t_max, n_sub, final_only, lpt, lane_map, dt)
    else:
        if lane_map is not None:
            raise ValueError("sampler='exact' draws from a generator, not per lane: "
                             "it takes no lane map")
        out = _exact_run(model, xb, th.repeat_interleave(lpt, dim=0), t_max,
                         n_sub, generator, dt)
        out = out[:, -1] if final_only else out
    return out, lead


def advance(model: CompartmentModel, x, theta, stream, steps_per_unit=20,
            sampler="fast", generator=None, lane_map=None, t_span=1.0):
    """Advance ``x: [..., C]`` by ``t_span`` time units in
    ``round(t_span * steps_per_unit)`` substeps of ``t_span / n_steps``
    (epitpu/sim/tauleap.py:139-165); ``theta`` broadcasts against x's
    leading dims (one row per chain serves every particle of the chain,
    without a copy).  One Philox call offset of ``stream`` per call;
    ``generator`` serves sampler="exact"; ``lane_map`` places a shard's lanes
    in the unsharded launch (``epitpu_torch.ops.tauleap_cuda.simulate_lanes``).
    On the card this is one kernel launch writing only the new state."""
    n_steps = int(round(t_span * steps_per_unit))
    if n_steps < 1:
        raise ValueError(f"t_span={t_span} x steps_per_unit={steps_per_unit} rounds to no "
                         "substep")
    out, lead = _run_lanes(model, stream, x, theta, 1, n_steps, sampler, generator,
                           final_only=True, lane_map=lane_map, dt=t_span / n_steps)
    return out.reshape(*lead, x.shape[-1])


def simulate(model: CompartmentModel, x0, theta, stream, t_max,
             steps_per_unit=20, sampler="fast", generator=None):
    """Record the state at integer times 0..t_max: ``[t_max + 1, ..., C]``
    (time-major, as epitpu.sim.simulate)."""
    out, lead = _run_lanes(model, stream, x0, theta, int(t_max),
                           steps_per_unit, sampler, generator)
    out = out.reshape(*lead, int(t_max) + 1, x0.shape[-1])
    return out.movedim(-2, 0)
