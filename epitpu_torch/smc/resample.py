"""Particle resampling: log-weights and uniforms in, ancestor indices out
(torch counterpart of ``epitpu.smc.resample``).

The uniforms are arguments, so the same uniforms give the same ancestors as
the JAX package.  Ancestor j is ``#{k : cdf_k < point_j}``: a broadcast
compare-reduce at small N, ``torch.searchsorted`` (left side, the same
count) above ``COMPARE_REDUCE_MAX_N``, where the ``[..., N, N]`` compare
would grow quadratically in memory.  A degenerate weight vector (no finite
entry) gives identity ancestry and a flag.
"""
from __future__ import annotations

import torch

COMPARE_REDUCE_MAX_N = 64


def normalized_weights(logw):
    """(weights [..., N], log_sum [...], degenerate [...]); degenerate
    weights fall back to uniform."""
    lse = torch.logsumexp(logw, dim=-1)
    degenerate = ~torch.isfinite(lse)
    w = torch.exp(logw - torch.where(degenerate, torch.zeros_like(lse), lse)[..., None])
    n = logw.shape[-1]
    w = torch.where(degenerate[..., None], torch.full_like(w, 1.0 / n), w)
    return w, lse, degenerate


def _safe_cdf(logw):
    """Unnormalized max-shifted linear CDF and the degenerate flag."""
    m = torch.amax(logw, dim=-1, keepdim=True)
    degenerate = ~torch.isfinite(m[..., 0])
    w = torch.exp(logw - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    w = torch.where(degenerate[..., None], torch.ones_like(w), w)
    return torch.cumsum(w, dim=-1), degenerate


def _ancestors(cdf, points):
    n = cdf.shape[-1]
    if n <= COMPARE_REDUCE_MAX_N:
        anc = (cdf[..., None, :] < points[..., :, None]).sum(-1)
    else:
        anc = torch.searchsorted(cdf.contiguous(), points.contiguous(), side="left")
    return torch.clamp(anc, max=n - 1)


def _finish(idx, degenerate):
    n = idx.shape[-1]
    iota = torch.arange(n, device=idx.device).expand_as(idx)
    return torch.where(degenerate[..., None], iota, idx), degenerate


def systematic_resample(u, logw):
    """Systematic resampling: points (i + u) / N through the CDF, one
    ``u: [..., 1]`` per weight vector."""
    n = logw.shape[-1]
    cdf, degenerate = _safe_cdf(logw)
    total = cdf[..., -1:]
    points = (torch.arange(n, dtype=logw.dtype, device=logw.device) + u) * (total / n)
    return _finish(_ancestors(cdf, points), degenerate)


def multinomial_resample(u, logw):
    """N iid categorical draws from ``u: [..., N]`` iid uniforms."""
    cdf, degenerate = _safe_cdf(logw)
    return _finish(_ancestors(cdf, u * cdf[..., -1:]), degenerate)


def systematic_resample_scatter(u, logw):
    """Systematic resampling in O(N), as
    ``epitpu.smc.resample.systematic_resample_scatter``: the points
    ``(j + u) * total / N`` are sorted, so the count of points below each
    CDF value, ``clip(ceil(cdf * N / total - u), 0, N)``, fixes every
    ancestor; a 1 scattered at each ancestor's first slot and a cumulative
    sum invert the counts.  The same ancestors as ``systematic_resample``
    for the same ``u: [..., 1]``, except at boundary ties of the two
    roundings."""
    n = logw.shape[-1]
    cdf, degenerate = _safe_cdf(logw)
    total = cdf[..., -1:]
    q = torch.clamp(torch.ceil(cdf * (n / total) - u), 0.0, float(n)).to(torch.int64)
    offsets = torch.cat([torch.zeros_like(q[..., :1]), q[..., :-1]], dim=-1)
    # offsets of n (the trailing zero-count ancestors) land in a spare slot
    d = torch.zeros(offsets.shape[:-1] + (n + 1,), dtype=torch.int64, device=logw.device)
    d.scatter_add_(-1, offsets, torch.ones_like(offsets))
    return _finish(torch.cumsum(d[..., :n], dim=-1) - 1, degenerate)


# kind -> (resampler, draws one uniform per particle)
_RESAMPLERS = {"systematic": (systematic_resample, False),
               "systematic_scatter": (systematic_resample_scatter, False),
               "multinomial": (multinomial_resample, True)}


def get_resampler(kind):
    """The resampler ``(u, logw) -> (ancestors, degenerate)`` named ``kind``."""
    return _resampler(kind)[0]


def _resampler(kind):
    try:
        return _RESAMPLERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown resampling kind {kind!r}; options: {sorted(_RESAMPLERS)}"
        ) from None


def resample_particles(kind, logw, generator, rows=None):
    """Draw the uniforms ``kind`` needs from ``generator`` and resample.
    ``rows = (offset, total)`` says that ``logw [chains, N]`` holds rows
    ``offset..offset+chains-1`` of ``total``: the uniforms are drawn for all
    ``total`` rows and sliced, as a sharded run must (``smc.filter``)."""
    fn, per_particle = _resampler(kind)
    k = logw.shape[-1] if per_particle else 1
    lead = logw.shape[:-1] if rows is None else (rows[1],) + logw.shape[1:-1]
    u = torch.rand(lead + (k,), generator=generator, device=logw.device, dtype=logw.dtype)
    if rows is not None:
        u = u[rows[0]:rows[0] + logw.shape[0]]
    return fn(u, logw)
