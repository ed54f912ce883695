"""One PMMH row of every chain, recomputed in plain torch from the row
before it: the reference that judges the program's PMMH rows.

A row ``i`` of the sampler (the semantics of epitpu's pmmh, reference
pmcmc.py:123-233) is:

* the proposal ``theta' = theta_{i-1} + chol(h cov) z``, ``cov`` the identity
  (or ``sigma``) until row ``adapt_start``, after it the ddof=0 covariance of
  the rows 0..i-1 (pooled over all chains when ``pooled``) plus 1e-4 I;
* a bootstrap particle filter at ``theta'``: ``N`` particles from the initial
  cloud, at step p (0..T-2) the weights of ``y[p]`` against the cloud, the
  log-likelihood increment, systematic resampling of the carried weights on
  every ``resample_every``-th step, then the tau-leap propagation of one time
  unit (``benchmark/reference/tauleap.py``);
* ``theta_i = theta'`` when no component is negative, the filter did not
  degenerate and ``log u < ll' - ll_{i-1}``; else the row before is kept;
* with paths stored, one ancestral trajectory drawn from the filter's history
  (the terminal particle by its carried weight).

Randomness is the program's: row ``i`` seeds a ``torch.Generator`` with
``derive_seed(seed, i, 0)`` (proposal normals, initial cloud, resampling
uniforms, MH uniform, in that order), the Philox key ``derive_seed(seed, i,
1)`` (propagation; call offset = filter step), and a second generator with
``derive_seed(seed, i, 2)`` (the path's terminal draw).  The generators are
torch's own, so the same seeds on the same device give the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import tauleap
from .philox import derive_seed


@dataclasses.dataclass
class PMMHSpec:
    model: object  # a module with STOICH, SOURCE, rates, initial_cloud
    obs: object  # a module with log_weight(y, x, p)
    chains: int
    particles: int
    parameters: tuple
    h: float
    adaptive: bool
    adapt_start: int
    pooled: bool
    resample_every: int
    steps_per_unit: int
    obs_param: float
    n_population: float
    mu: float
    store_trajectories: bool
    sigma: Optional[tuple] = None


def _welford(thetas):
    """(count, mean, m2) per chain of the rows ``thetas [chains, rows, d]``,
    added one row at a time in float32."""
    chains, rows, d = thetas.shape
    count = torch.zeros(chains, device=thetas.device)
    mean = torch.zeros(chains, d, device=thetas.device)
    m2 = torch.zeros(chains, d, d, device=thetas.device)
    for r in range(rows):
        x = thetas[:, r]
        count = count + 1.0
        delta = x - mean
        mean = mean + delta / count[:, None]
        m2 = m2 + delta[:, :, None] * (x - mean)[:, None, :]
    return count, mean, m2


def _covariance(count, mean, m2, pooled):
    chains, d = mean.shape
    if pooled:
        total = count.sum()
        mean_w = (count[:, None] * mean).sum(0) / torch.clamp(total, min=1.0)
        delta = mean - mean_w
        m2 = (m2 + count[:, None, None] * delta[:, :, None] * delta[:, None, :]).sum(0)
        count, m2 = total.expand(chains), m2.expand(chains, -1, -1)
    cov = m2 / torch.clamp(count, min=1.0)[:, None, None]
    return cov + 1e-4 * torch.eye(d, dtype=cov.dtype, device=cov.device)


def _systematic(u, logw):
    """Ancestors ``#{k : cdf_k < (j + u) total / N}`` of each row of ``logw``
    (identity where no weight is finite)."""
    n = logw.shape[-1]
    m = torch.amax(logw, dim=-1, keepdim=True)
    degenerate = ~torch.isfinite(m[..., 0])
    w = torch.exp(logw - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    w = torch.where(degenerate[..., None], torch.ones_like(w), w)
    cdf = torch.cumsum(w, dim=-1)
    points = (torch.arange(n, dtype=logw.dtype, device=logw.device) + u) * (cdf[..., -1:] / n)
    anc = torch.clamp(torch.searchsorted(cdf.contiguous(), points.contiguous(), side="left"),
                      max=n - 1)
    iota = torch.arange(n, device=logw.device).expand_as(anc)
    return torch.where(degenerate[..., None], iota, anc)


def particle_filter(spec, y, theta, gen, philox_seed, dtype):
    """(log-likelihood [chains], history [chains, T, N, C] or None, ancestry
    [chains, T, N] or None, final carried log-weights [chains, N])."""
    chains, n = theta.shape[0], spec.particles
    device = theta.device
    log_n = math.log(n)
    x = spec.model.initial_cloud(gen, (chains, n), spec.n_population, spec.mu).to(dtype)
    y = y.to(dtype)
    theta_lanes = theta.to(dtype).repeat_interleave(n, dim=0)
    lw = torch.full((chains, n), -log_n, dtype=dtype, device=device)
    log_z = torch.zeros(chains, dtype=dtype, device=device)
    iota = torch.arange(n, device=device).expand(chains, n)
    xs, ancs = [x], [torch.zeros_like(iota)]
    carry = spec.resample_every > 1
    for p in range(y.shape[0] - 1):
        logw = spec.obs.log_weight(y[p], x, spec.obs_param)
        s = lw + logw if carry else logw
        lse = torch.logsumexp(s, dim=-1)
        degen = ~torch.isfinite(lse)
        log_z = torch.where(degen, torch.full_like(log_z, -math.inf),
                            log_z + lse - (0.0 if carry else log_n))
        if carry:
            lw_new = torch.where(degen[:, None], torch.full_like(s, -log_n),
                                 s - torch.where(degen, torch.zeros_like(lse), lse)[:, None])
        else:
            lw_new = s
        if not carry or (p + 1) % spec.resample_every == 0:
            u = torch.rand((chains, 1), generator=gen, device=device).to(dtype)
            anc = _systematic(u, lw_new)
            if carry:
                anc = torch.where(~degen[:, None], anc, iota)
                lw = torch.where(~degen[:, None], torch.full_like(lw_new, -log_n), lw_new)
            x_res = torch.gather(x, 1, anc[..., None].expand(chains, n, x.shape[-1]))
        else:
            anc, x_res, lw = iota, x, lw_new
        flat = tauleap.simulate(spec.model, x_res.reshape(chains * n, -1), theta_lanes,
                                philox_seed, p, 1, spec.steps_per_unit, True, dtype)
        x = flat.reshape(chains, n, -1)
        xs.append(x)
        ancs.append(anc)
    if not spec.store_trajectories:
        return log_z, None, None, lw
    return log_z, torch.stack(xs, dim=1), torch.stack(ancs, dim=1), lw


def sample_path(gen, hidden, ancestry, terminal_logw):
    """The ancestral trajectory ``[chains, T, C]``: the terminal slot drawn
    by its carried weight (``terminal_logw``) or uniformly (None), then
    ``j_p = ancestry[p + 1, j_{p+1}]`` back to the start."""
    chains, t_len, n, _ = hidden.shape
    if terminal_logw is None:
        j = torch.randint(0, n, (chains,), generator=gen, device=gen.device)
    else:
        w = torch.exp(terminal_logw - torch.amax(terminal_logw, dim=-1, keepdim=True))
        j = torch.multinomial(w.float(), 1, generator=gen)[:, 0]
    rows = torch.arange(chains, device=hidden.device)
    out = [hidden[rows, t_len - 1, j]]
    for p in range(t_len - 1, 0, -1):
        j = ancestry[rows, p, j]
        out.append(hidden[rows, p - 1, j])
    return torch.stack(out[::-1], dim=1)


def replay_rows(spec: PMMHSpec, y, seed, rows, thetas, lls, trajs=None,
                dtype=torch.float32):
    """Each row ``i`` of ``rows`` (all >= 1) recomputed from the program's
    row ``i - 1``: ``{i: (theta_i [chains, d], ll_i [chains], traj_i [chains,
    T, C] or None)}``.  ``thetas [chains, >= max(rows), d]``, ``lls`` and
    ``trajs`` are the program's rows from row 0, on the device to compute
    on; the covariance of row ``i`` is worked out again from thetas 0..i-1."""
    device = thetas.device
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    d = thetas.shape[-1]
    sigma0 = (torch.eye(d, device=device) if spec.sigma is None
              else torch.as_tensor(spec.sigma, dtype=torch.float32, device=device))
    gen = torch.Generator(device=device)
    path_gen = torch.Generator(device=device)
    out = {}
    for i in sorted(rows):
        theta_prev, ll_prev = thetas[:, i - 1].float(), lls[:, i - 1].float()
        cov = sigma0.expand(spec.chains, d, d)
        if spec.adaptive and i > spec.adapt_start:
            cov = _covariance(*_welford(thetas[:, :i].float()), spec.pooled)
        gen.manual_seed(derive_seed(seed, i, 0))
        path_gen.manual_seed(derive_seed(seed, i, 2))
        z = torch.randn((spec.chains, d), generator=gen, device=device)
        chol = torch.linalg.cholesky_ex(spec.h * cov).L
        prop = (theta_prev + (chol * z[..., None, :]).sum(-1)).to(dtype)
        ll_prop, hidden, ancestry, lw = particle_filter(
            spec, y, prop, gen, derive_seed(seed, i, 1), dtype)
        log_u = torch.log(torch.rand(spec.chains, generator=gen, device=device))
        ok = (prop >= 0).all(-1) & torch.isfinite(ll_prop)
        accept = ok & (log_u.to(dtype) < ll_prop - ll_prev.to(dtype))
        theta_i = torch.where(accept[:, None], prop.float(), theta_prev)
        ll_i = torch.where(accept, ll_prop.float(), ll_prev)
        traj_i = None
        if spec.store_trajectories:
            traj_prop = sample_path(path_gen, hidden, ancestry,
                                    lw if spec.resample_every > 1 else None)
            traj_i = torch.where(accept[:, None, None], traj_prop.float(),
                                 trajs[:, i - 1].float())
        out[i] = (theta_i, ll_i, traj_i)
    return out
