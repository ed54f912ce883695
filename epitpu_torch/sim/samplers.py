"""Batched binomial sampling for the tau-leap hot loop (torch counterpart of
``epitpu.sim.samplers``).

The two-regime law: mean < SMALL_MEAN_MAX draws by exact inverse-CDF
inversion truncated at SMALL_K terms; above it a Cornish-Fisher corrected
normal, rounded and clamped; p > 1/2 is flipped to 1 - p first.  Given the
uniform ``u`` and the normal ``z`` the law is deterministic
(``binomial_from_draws``), so the CUDA kernel and this plain version agree
draw for draw on the same Philox words.

Samplers "fast" and "fast_rbg" both name the Philox sampler (the TPU's
hardware-RNG variant has no counterpart here); "exact" is ``torch.binomial``.
"""
from __future__ import annotations

import torch

from ..rng import lane_draws

SMALL_MEAN_MAX = 8.0
SMALL_K = 20


def _binomial_small_exact(u, n, p, count_terms=False):
    """Exact inverse-CDF for Binomial(n, p) truncated at SMALL_K terms.
    With ``count_terms``, also the CDF terms a loop that stops at the first
    ``u < cdf`` evaluates (the CUDA kernel's): the k with ``u >= cdf_k``, a
    prefix of the loop since cdf never decreases."""
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
    x = torch.minimum(x + (u >= cdf).to(u.dtype), n)
    return (x, terms) if count_terms else x


def _binomial_normal_cf(z, n, p):
    """Cornish-Fisher corrected normal approximation, rounded and clamped."""
    lam = n * p
    var = lam * (1.0 - p)
    sig = torch.sqrt(torch.clamp(var, min=1e-12))
    gamma = (1.0 - 2.0 * p) / sig
    zc = z + gamma * (z * z - 1.0) / 6.0
    x = torch.floor(lam + sig * zc + 0.5)
    return torch.minimum(torch.clamp(x, min=0.0), n)


def binomial_from_draws(u, z, n, p, work=None):
    """Binomial(n, p) counts from one uniform ``u`` and one normal ``z`` per
    entry (all float32, broadcast to one shape).  A ``work`` dict, if given,
    accumulates the draws, those of the small regime and their CDF terms
    (``_binomial_small_exact``'s ``count_terms``): what a kernel launch
    computes, for its bound."""
    u, z, n, p = torch.broadcast_tensors(u, z, n, p)
    p = torch.clamp(p, 0.0, 1.0)
    flip = p > 0.5
    p_eff = torch.where(flip, 1.0 - p, p)
    is_small = n * p_eff < SMALL_MEAN_MAX
    small, terms = _binomial_small_exact(u, n, p_eff, count_terms=True)
    large = _binomial_normal_cf(z, n, p_eff)
    x = torch.where(is_small, small, large)
    if work is not None:
        work["draws"] = work.get("draws", 0) + is_small.numel()
        work["small"] = work.get("small", 0) + int(is_small.sum())
        work["terms"] = work.get("terms", 0) + int(terms[is_small].sum())
    x = torch.where(flip, n - x, x)
    x = torch.where(p == 0.0, torch.zeros_like(x), x)
    return torch.where(p == 1.0, n, x)


def fast_binomial(seed, offset, step, n, p):
    """Binomial(n, p) for ``n, p: [B, K]`` on the Philox words of counter
    (lane b, ``offset``, ``step``, slot k)."""
    b, k = n.shape
    u, z = lane_draws(seed, offset, [step], b, k, device=n.device)
    return binomial_from_draws(u[0], z[0], n, p)


def exact_binomial(generator, n, p):
    """``torch.binomial`` with p clamped to [0, 1], for validation runs."""
    return torch.binomial(n, torch.clamp(p, 0.0, 1.0), generator=generator)


PHILOX_SAMPLERS = ("fast", "fast_rbg")
SAMPLERS = PHILOX_SAMPLERS + ("exact",)
_SAMPLERS = {"fast": fast_binomial, "fast_rbg": fast_binomial, "exact": exact_binomial}


def get_binomial_sampler(name):
    """The sampler function ``name`` selects: ``fast_binomial(seed, offset,
    step, n, p)`` for the Philox samplers, ``exact_binomial(generator, n,
    p)`` for "exact"."""
    try:
        return _SAMPLERS[name]
    except KeyError:
        raise ValueError(f"unknown binomial sampler {name!r}; options {SAMPLERS}") from None
