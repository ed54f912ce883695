"""Rank-normalized bulk effective sample size (Vehtari et al. 2021).

Frozen copy of epitpu_torch/diag/stats.py at commit 0f2ab30 (``_autocov``,
``ess``, ``_split_chains``, ``_avg_ranks``, ``_rank_normalize``,
``ess_rank``), in numpy, with ``torch.special.ndtri`` as the inverse normal
CDF.  The benchmark keeps its own copy so that a change to the program's
``diag`` does not change what ``ess_per_s`` reads."""
from __future__ import annotations

import numpy as np
import torch


def _autocov(x):
    n = len(x)
    xc = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft)
    return np.fft.irfft(f * np.conj(f), nfft)[:n].real / n


def ess(a):
    """Multi-chain ESS of ``[M, N]`` by Geyer's initial positive sequence."""
    m, n = a.shape
    acovs = np.stack([_autocov(a[i]) for i in range(m)])
    if acovs[:, 0].mean() == 0:
        return float(m * n)
    mean_acov = acovs.mean(axis=0)
    w = mean_acov[0]
    var_plus = w * (n - 1) / n + a.mean(axis=1).var(ddof=1 if m > 1 else 0)
    rho = 1.0 - (w - mean_acov) / var_plus
    tau = 1.0
    prev_pair = np.inf
    for t in range(1, n - 2, 2):
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        tau += 2.0 * pair
        prev_pair = pair
    return float(m * n / tau)


def _split_chains(a):
    half = a.shape[1] // 2
    return np.concatenate([a[:, :half], a[:, a.shape[1] - half:]], axis=0)


def _avg_ranks(flat):
    order = np.argsort(flat, kind="stable")
    ordinal = np.empty(flat.size, dtype=float)
    ordinal[order] = np.arange(1, flat.size + 1)
    _, inverse, counts = np.unique(flat, return_inverse=True, return_counts=True)
    sums = np.zeros(counts.size)
    np.add.at(sums, inverse, ordinal)
    return sums[inverse] / counts[inverse]


def _rank_normalize(a):
    flat = np.asarray(a, dtype=float).reshape(-1)
    r = _avg_ranks(flat)
    z = torch.special.ndtri(torch.from_numpy((r - 0.375) / (flat.size + 0.25)))
    return z.numpy().reshape(np.shape(a))


def ess_rank(a):
    """Rank-normalized bulk ESS of one component's draws ``[M, N]``."""
    a = np.asarray(a, dtype=float)
    s = _split_chains(a)
    if np.all(s == s.reshape(-1)[0]):
        return float(a.size)
    return float(ess(_rank_normalize(s)))


def min_ess_rank(thetas):
    """The smallest rank ESS over the components of ``[M, N, d]``."""
    return min(ess_rank(thetas[:, :, j]) for j in range(thetas.shape[2]))
