"""Observation models as log-likelihood functions (torch counterpart of
``epitpu.observe.models``).

``log_weight(y, x_obs, param) -> logw`` with ``y: [obs_dim]``,
``x_obs: [..., obs_dim]`` and ``param`` a scalar or a tensor that
broadcasts against ``x_obs`` (one reporting probability per chain).
``combine="min"`` is the reference's min-over-compartments weight;
``"sum"`` the product of likelihoods.

The binomial weight runs by the device of ``x_obs``: on the card one launch
of the hand-written kernel ``epitpu_torch/csrc/obs_binomial.cu``
(``epitpu_torch.ops.obs_cuda``; ``x_obs`` ``[chains, N, obs_dim]``,
``param`` a 0-d or ``[chains, 1, 1]`` tensor, as the filter passes them), on
the CPU its plain twin, ``binomial_log_weight_reference`` (``binom_logpmf``
and the combine), which the kernel equals bit for bit on the card.
"""
from __future__ import annotations

import math

import torch

from ..ops.obs_cuda import binomial_log_weight


def _stirling_delta(x):
    """lgamma(x) - (x-1/2) ln x + x - ln sqrt(2 pi), three Stirling terms."""
    inv = 1.0 / x
    inv2 = inv * inv
    return inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 / 1260.0))


def _bd0(x, m):
    """Loader's binomial deviance ``x log(x/m) + m - x``, by its series in
    ``v = (x-m)/(x+m)`` where x is near m (see epitpu.observe.models._bd0)."""
    v = (x - m) / (x + m)
    v2 = v * v
    acc = (x - m) * v
    ej = 2.0 * x * v
    for j in range(1, 8):
        ej = ej * v2
        acc = acc + ej / (2 * j + 1)
    direct = x * torch.log(x / m) + m - x
    return torch.where(torch.abs(x - m) <= 0.1 * (x + m), acc, direct)


def binom_logpmf(k, n, p):
    """log Binomial(k | n, p), -inf outside 0 <= k <= n (Loader's
    saddle-point form, as epitpu.observe.models.binom_logpmf)."""
    k, n, p = (torch.as_tensor(a, dtype=torch.float32) for a in (k, n, p))
    p = torch.clamp(p, 0.0, 1.0)
    ps = torch.clamp(p, 1e-10, 1.0 - 1e-7)
    kk = torch.clamp(k, min=1.0)
    nk = torch.clamp(n - k, min=1.0)
    interior = (
        _stirling_delta(n) - _stirling_delta(kk) - _stirling_delta(nk)
        + 0.5 * torch.log(n / (2.0 * math.pi * kk * nk))
        - _bd0(kk, n * ps)
        - _bd0(nk, n * (1.0 - ps))
    )
    neg_inf = torch.tensor(-math.inf, dtype=torch.float32, device=interior.device)
    zero = torch.tensor(0.0, dtype=torch.float32, device=interior.device)
    raw = torch.where(k == 0, n * torch.log1p(-ps), interior)
    raw = torch.where(k == n, n * torch.log(ps), raw)
    raw = torch.where(n == 0, torch.where(k == 0, zero, neg_inf), raw)
    raw = torch.where(p == 0.0, torch.where(k == 0, zero, neg_inf), raw)
    raw = torch.where(p == 1.0, torch.where(k == n, zero, neg_inf), raw)
    support = (k >= 0) & (k <= n)
    return torch.where(support, raw, neg_inf)


def normal_logpdf(y, loc, scale):
    z = (y - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)


def _combine(logs, mode):
    if mode == "min":
        return torch.amin(logs, dim=-1)
    if mode == "sum":
        return torch.sum(logs, dim=-1)
    raise ValueError(f"unknown combine mode {mode!r}")


def binomial_log_weight_reference(y, x_obs, p, combine="min"):
    """The plain twin of the binomial weighting kernel
    (``epitpu_torch.ops.obs_cuda.binomial_log_weight``), on any device."""
    return _combine(binom_logpmf(y, x_obs, p), combine)


def make_binomial_obs(combine="min"):
    """Under-reported counts: Y[c] ~ Binomial(X[c], p).  A CUDA ``x_obs``
    launches the kernel, a CPU one runs the twin; any other input raises."""

    def log_weight(y, x_obs, p):
        device = x_obs.device.type if isinstance(x_obs, torch.Tensor) else None
        if device == "cuda":
            return binomial_log_weight(y, x_obs, p, combine)
        if device == "cpu":
            return binomial_log_weight_reference(y, x_obs, p, combine)
        raise ValueError(f"no binomial observation weight for x_obs on {device or type(x_obs)}")

    return log_weight


def make_gaussian_obs(combine="min", eps=1e-4):
    """Noisy counts: Y[c] ~ Normal(X[c], noise * X[c] + eps)."""

    def log_weight(y, x_obs, noise):
        return _combine(normal_logpdf(y, x_obs, noise * x_obs + eps), combine)

    return log_weight


def get_observation_model(kind, combine="min"):
    """kind: "binomial" or "gaussian"."""
    if kind == "binomial":
        return make_binomial_obs(combine)
    if kind == "gaussian":
        return make_gaussian_obs(combine)
    raise ValueError(f"unknown observation model {kind!r}")
