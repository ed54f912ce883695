"""Euler-multinomial tau-leaping in plain torch: the reference of the
tau-leap kernel (K4) for a model whose reactions have unique sources.

Over a substep of length dt, reaction r with per-capita hazard mu_r fires
``Binomial(x[source_r], 1 - exp(-mu_r dt))`` times; the binomial is drawn
from one Philox uniform and one normal per (lane, substep, reaction) by the
two-regime law of epitpu_torch/sim/samplers.py at commit 0f2ab30 (exact
inverse CDF below mean 8, truncated at 20 terms; a Cornish-Fisher corrected
normal above; p > 1/2 flipped).  The substep follows
epitpu_torch/sim/tauleap.py at the same commit.  ``dtype`` is the float
precision of every state, rate and probability: float32 as configured, a
lower one for the control.
"""
from __future__ import annotations

import torch

from .philox import lane_draws

SMALL_MEAN_MAX = 8.0
SMALL_K = 20


def _binomial_small_exact(u, n, p):
    p = torch.clamp(p, 0.0, 1.0 - 1e-7)
    q = 1.0 - p
    ratio = p / q
    pmf = torch.exp(n * torch.log1p(-p))
    cdf = pmf
    x = torch.zeros_like(u)
    for k in range(SMALL_K - 1):
        x = x + (u >= cdf).to(u.dtype)
        pmf = torch.clamp(pmf * (n - k) / (k + 1.0) * ratio, min=0.0)
        cdf = cdf + pmf
    terms = x
    return torch.minimum(x + (u >= cdf).to(u.dtype), n), terms


def _binomial_normal_cf(z, n, p):
    lam = n * p
    var = lam * (1.0 - p)
    sig = torch.sqrt(torch.clamp(var, min=1e-12))
    gamma = (1.0 - 2.0 * p) / sig
    zc = z + gamma * (z * z - 1.0) / 6.0
    x = torch.floor(lam + sig * zc + 0.5)
    return torch.minimum(torch.clamp(x, min=0.0), n)


def binomial(u, z, n, p, work=None):
    """Binomial(n, p) counts from one uniform and one normal per entry.  A
    ``work`` dict, if given, accumulates the draws, those of the small
    regime and the CDF terms a loop stopping at the first ``u < cdf``
    evaluates (``benchmark/roofline.py`` calibrates its constants on them)."""
    p = torch.clamp(p, 0.0, 1.0)
    flip = p > 0.5
    p_eff = torch.where(flip, 1.0 - p, p)
    is_small = n * p_eff < SMALL_MEAN_MAX
    small, terms = _binomial_small_exact(u, n, p_eff)
    large = _binomial_normal_cf(z, n, p_eff)
    x = torch.where(is_small, small, large)
    if work is not None:
        work["draws"] = work.get("draws", 0) + is_small.numel()
        work["small"] = work.get("small", 0) + int(is_small.sum())
        work["terms"] = work.get("terms", 0) + int(terms[is_small].sum())
    x = torch.where(flip, n - x, x)
    x = torch.where(p == 0.0, torch.zeros_like(x), x)
    return torch.where(p == 1.0, n, x)


def substep(model, x, theta, dt, u, z, work=None):
    """One substep of lanes ``x [B, C]`` with per-lane ``theta [B, d]`` on
    draws ``u, z [B, R]``."""
    rates = model.rates(x, theta)
    src_x = x[:, list(model.SOURCE)]
    mu = torch.where(src_x > 0, torch.clamp(rates, min=0.0) / torch.clamp(src_x, min=1.0),
                     torch.zeros_like(src_x))
    p_fire = torch.clamp(-torch.expm1(-mu * dt), 0.0, 1.0)
    n_events = binomial(u, z, src_x, p_fire, work)
    cols = list(x.unbind(-1))
    for r, row in enumerate(model.STOICH):
        for c, s in enumerate(row):
            if s:
                cols[c] = cols[c] + s * n_events[:, r]
    return torch.stack(cols, dim=-1)


def simulate(model, x0, theta, seed, offset, t_max, n_sub, final_only, dtype=torch.float32,
             work=None):
    """Lanes ``x0 [B, C]`` with one theta row per lane ``theta [B, d]``
    through ``t_max`` units of ``n_sub`` substeps of length ``1 / n_sub`` on
    Philox counter (lane, ``offset``, substep, reaction): the state at every
    integer time ``[B, t_max + 1, C]``, or at ``t_max`` only, ``[B, C]``."""
    b = x0.shape[0]
    r = len(model.SOURCE)
    dt = 1.0 / n_sub
    x, theta = x0.to(dtype), theta.to(dtype)
    out = [x]
    for unit in range(t_max):
        u, z = lane_draws(seed, offset, range(unit * n_sub, (unit + 1) * n_sub), b, r,
                          x0.device)
        u, z = u.to(dtype), z.to(dtype)
        for s in range(n_sub):
            x = substep(model, x, theta, dt, u[s], z[s], work)
        out.append(x)
    return x if final_only else torch.stack(out, dim=1)
