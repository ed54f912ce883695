"""The particle filter's likelihood update on the card: ``csrc/pf_loglik.cu``.

``loglik_update(logw, log_z, log_n, lw=None)`` is phase ``pf_loglik`` of
``epitpu_torch.smc.filter``: from a step's log-weights ``logw [rows, N]``
(one row a chain), the running log-likelihood ``log_z [rows]`` and, in the
weight-carrying form, the carried normalized log-weights ``lw [rows, N]``, it
returns ``(log_z', lw', degen)``::

    s = lw + logw (carry form) or logw; lse = log-sum-exp of each row of s
    degen = ~isfinite(lse)
    log_z' = -inf where degen, else log_z + lse (carry form) or
             (log_z + lse) - log_n
    lw' = -log_n where degen, else s - lse (carry form; None otherwise)

A CUDA ``logw`` launches the kernel once (``loglik_update_cuda``), a CPU one
runs the plain twin ``loglik_update_reference``, which the kernel equals bit
for bit on the card.  The log-sum-exp is not ``torch.logsumexp``: its sum
runs in the kernel's fixed order (``row_sum``), which depends on ``N`` alone,
so a row's result does not depend on the number of rows or its place among
them.

Nothing here reads a device value on the host, so a launch never
synchronizes.  The kernel takes float32 tensors on one card, contiguous,
``logw`` and ``lw`` ``[rows, N]`` with ``1 <= N <= MAX_PARTICLES`` and
``log_z`` ``[rows]``; anything else raises.  Its outputs are new tensors
each call (``log_zs`` keeps every step's ``log_z``).  ``_build.launch``
counts the launches in ``_build.LAUNCHES["pf_loglik"]`` and the
``pf.loglik_launches`` counter of ``epitpu_torch.profiling``.
"""
from __future__ import annotations

import math

import torch

from . import _build

TILE = 8192  # csrc/pf_loglik.cu:kTile
MAX_PARTICLES = 1 << 30  # csrc/pf_loglik.cu:epi_pf_loglik's bound on n


def row_sum(e):
    """The sum of each row of ``e [rows, N]`` in the kernel's order: zeros
    to ``P``, the next power of two >= N; past ``TILE``, the tiles of
    ``TILE`` elements added elementwise, tile 0 first; then element
    ``i + H/2`` added into element ``i`` of the ``H`` left, until one is
    left."""
    rows, n = e.shape
    p = 1 << (n - 1).bit_length()
    tile = min(p, TILE)
    e = torch.nn.functional.pad(e, (0, p - n)).reshape(rows, p // tile, tile)
    acc = e[:, 0]
    for q in range(1, p // tile):
        acc = acc + e[:, q]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


def logsumexp_rows(s):
    """``torch.logsumexp(s, -1)``'s formula, its sum in ``row_sum``'s order."""
    m = torch.amax(s, dim=-1)
    m0 = torch.where(m.abs() == math.inf, torch.zeros_like(m), m)
    return torch.log(row_sum(torch.exp(s - m0[:, None]))) + m0


def loglik_update_reference(logw, log_z, log_n, lw=None):
    """The plain twin of the kernel (module docstring)."""
    neg_inf = torch.tensor(-math.inf, device=logw.device)
    if lw is None:
        step_lse = logsumexp_rows(logw)
        step_degen = ~torch.isfinite(step_lse)
        return torch.where(step_degen, neg_inf, log_z + step_lse - log_n), None, step_degen
    s = lw + logw
    step_lse = logsumexp_rows(s)
    step_degen = ~torch.isfinite(step_lse)
    log_z = torch.where(step_degen, neg_inf, log_z + step_lse)
    safe_lse = torch.where(step_degen, torch.zeros_like(step_lse), step_lse)
    lw_new = torch.where(step_degen[:, None], torch.full_like(s, -log_n), s - safe_lse[:, None])
    return log_z, lw_new, step_degen


def _check(logw, log_z, lw):
    """Raises on anything the kernel does not take as it is."""
    named = (("logw", logw), ("log_z", log_z)) + (() if lw is None else (("lw", lw),))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor on the card, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != logw.device:
            raise ValueError(f"{name} on {t.device} but logw on {logw.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if logw.dim() != 2 or not 1 <= logw.shape[1] <= MAX_PARTICLES:
        raise ValueError(f"logw must be [rows, N] with 1 <= N <= {MAX_PARTICLES}, "
                         f"got {tuple(logw.shape)}")
    if log_z.shape != logw.shape[:1]:
        raise ValueError(f"log_z must be [{logw.shape[0]}], got {tuple(log_z.shape)}")
    if lw is not None and lw.shape != logw.shape:
        raise ValueError(f"lw must be {tuple(logw.shape)}, got {tuple(lw.shape)}")


def loglik_update_cuda(logw, log_z, log_n, lw=None):
    """The update (module docstring) in one launch of the kernel."""
    if logw.device.type != "cuda":
        raise ValueError(f"no likelihood-update kernel for device {logw.device}")
    _check(logw, log_z, lw)
    rows = logw.shape[0]
    log_z_out = torch.empty_like(log_z)
    degen = torch.empty(rows, dtype=torch.bool, device=logw.device)
    lw_out = None if lw is None else torch.empty_like(logw)
    if rows == 0:
        return log_z_out, lw_out, degen
    _build.launch(_build.load_library().epi_pf_loglik, "pf_loglik", logw.device,
                  logw.data_ptr(), None if lw is None else lw.data_ptr(), log_z.data_ptr(),
                  log_z_out.data_ptr(), None if lw_out is None else lw_out.data_ptr(),
                  degen.data_ptr(), rows, logw.shape[1], float(log_n))
    return log_z_out, lw_out, degen


def loglik_update(logw, log_z, log_n, lw=None):
    """Phase ``pf_loglik`` (module docstring): the kernel on a CUDA
    ``logw`` (made contiguous, a no-op on the filter's), the twin on a CPU
    one; any other device raises."""
    device = logw.device.type
    if device == "cuda":
        return loglik_update_cuda(logw.contiguous(), log_z, log_n, lw)
    if device == "cpu":
        return loglik_update_reference(logw, log_z, log_n, lw)
    raise ValueError(f"no likelihood update for logw on {logw.device}")
