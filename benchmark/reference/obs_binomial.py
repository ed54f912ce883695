"""Binomial under-reporting in plain torch: Y[c] ~ Binomial(X[c], p), the
weight of a particle the smallest log-pmf over its compartments (the
reference's min combine, pmcmc.py:179).  The log-pmf is Loader's saddle
point form, as epitpu_torch/observe/models.py at commit 0f2ab30 computes it
in float32 (lgamma differences of counts near 4,800 lose two digits there)."""
from __future__ import annotations

import math

import torch


def _stirling_delta(x):
    inv = 1.0 / x
    inv2 = inv * inv
    return inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 / 1260.0))


def _bd0(x, m):
    v = (x - m) / (x + m)
    v2 = v * v
    acc = (x - m) * v
    ej = 2.0 * x * v
    for j in range(1, 8):
        ej = ej * v2
        acc = acc + ej / (2 * j + 1)
    direct = x * torch.log(x / m) + m - x
    return torch.where(torch.abs(x - m) <= 0.1 * (x + m), acc, direct)


def logpmf(k, n, p):
    dtype = n.dtype
    k, p = k.to(dtype), torch.as_tensor(p, dtype=dtype, device=n.device)
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
    neg_inf = torch.tensor(-math.inf, dtype=dtype, device=n.device)
    zero = torch.tensor(0.0, dtype=dtype, device=n.device)
    raw = torch.where(k == 0, n * torch.log1p(-ps), interior)
    raw = torch.where(k == n, n * torch.log(ps), raw)
    raw = torch.where(n == 0, torch.where(k == 0, zero, neg_inf), raw)
    raw = torch.where(p == 0.0, torch.where(k == 0, zero, neg_inf), raw)
    raw = torch.where(p == 1.0, torch.where(k == n, zero, neg_inf), raw)
    return torch.where((k >= 0) & (k <= n), raw, neg_inf)


def log_weight(y, x, p):
    """``y [obs]`` against states ``x [..., obs]`` -> ``[...]``."""
    return torch.amin(logpmf(y, x, p), dim=-1)
