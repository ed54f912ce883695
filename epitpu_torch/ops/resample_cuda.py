"""The particle filter's systematic resampling step on the card:
``csrc/pf_resample.cu``.

``systematic_step(lw, u, x, skip=None, p0=0, n_local=None)`` is phase
``pf_resample`` of ``epitpu_torch.smc.filter`` for ``resampling="systematic"``:
from the log-weights ``lw [rows, N]`` (one row a chain), the row's uniform
``u [rows, 1]`` and the cloud ``x [rows, N, C]`` it returns, for the particles
``p0 .. p0 + n_local - 1`` (every particle by default; a particle shard's slice
of the all-gathered cloud on a mesh), ``(anc, x_res, lw_next)``::

    m = max(lw) (NaN propagates); degenerate = ~isfinite(m)
    cdf = the running maximum of the running sums of exp(lw - m),
          summed in the kernel's fixed order (``cdf_reference``)
    point_j = (j + u) * (cdf[N - 1] / N)
    anc_j = min(#{k : cdf_k < point_j}, N - 1), or j where degenerate or skip
    x_res = x[anc]                                   [rows, n_local, C]
    lw_next = skip ? lw : -log N                     (None without ``skip``)

``skip [rows]`` (bool) marks the rows that keep their particles and carried
weights this step: the weight-carrying form passes the step's degenerate
flags, or those of rows whose ESS stayed high.  Where the running sums are
exact (dyadic weights) these are ``smc.resample.systematic_resample``'s
ancestors from the same uniforms; elsewhere they may differ where a point
lies within rounding of the CDF, as any two orders of summation do.

A CUDA ``lw`` launches the kernel once (``systematic_step_cuda``), a CPU one
runs the plain twin ``systematic_step_reference``, which the kernel equals bit
for bit on the card.  A row's result depends on nothing but the row.  Nothing
here reads a device value on the host, so a launch never synchronizes.  The
kernel takes float32 ``lw``, ``u`` and ``x``, a bool ``skip``, all contiguous
on one card, ``1 <= N <= MAX_PARTICLES``; anything else raises.  Its outputs
are new tensors each call; past ``TILE`` particles it also allocates a
``[rows, N]`` scratch for the CDF.  ``_build.launch`` counts the launches in
``_build.LAUNCHES["pf_resample"]`` and the ``pf.resample_launches`` counter
of ``epitpu_torch.profiling``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

WARP = 32  # csrc/pf_resample.cu:kWarp
ROW_THREADS = 512  # csrc/pf_resample.cu:kRowThreads
TILE = 8192  # csrc/pf_resample.cu:kTile
MAX_PARTICLES = 1 << 24  # csrc/pf_resample.cu:kMaxN


def _kogge_stone(v, op):
    """The inclusive scan by ``op`` along the last axis of ``v`` in
    Kogge-Stone's order: element ``i`` becomes ``op(v[i - d], v[i])`` for
    ``d = 1, 2, 4, ...`` while ``i >= d``."""
    n, d = v.shape[-1], 1
    while d < n:
        v = torch.cat([v[..., :d], op(v[..., :-d], v[..., d:])], dim=-1)
        d *= 2
    return v


def cdf_reference(w):
    """The kernel's CDF of each row of ``w [rows, N]`` (float32, >= 0): its
    running sums, then their running maximum.  The sums follow the kernel's
    threads: at ``P <= 32`` (``P`` the next power of two >= N) Kogge-Stone
    over the row; past that, tiles of ``min(P, TILE)`` elements in order,
    zeros past N, each cut into ``T = min(P, ROW_THREADS)`` runs of ``K``
    consecutive elements summed in order; the runs' totals scanned by
    Kogge-Stone within each warp of 32 and the warps' totals likewise, and
    element ``j`` of run ``t`` is ``(carry + (warps before + lanes before))
    + run sum to j``, ``carry`` the previous tile's last sum."""
    rows, n = w.shape
    p = 1 << (n - 1).bit_length()
    if p <= WARP:
        return torch.cummax(_kogge_stone(w, torch.add), dim=-1).values
    threads, tile = min(p, ROW_THREADS), min(p, TILE)
    e = F.pad(w, (0, p - n)).reshape(rows, p // tile, threads, tile // threads)
    own = [e[..., 0]]
    for j in range(1, e.shape[-1]):
        own.append(own[-1] + e[..., j])
    own = torch.stack(own, dim=-1)  # [rows, tiles, T, K]
    lanes = _kogge_stone(own[..., -1].reshape(rows, p // tile, threads // WARP, WARP), torch.add)
    warps = _kogge_stone(lanes[..., -1], torch.add)  # [rows, tiles, T / 32]
    before = (F.pad(warps[..., :-1], (1, 0))[..., None]
              + F.pad(lanes[..., :-1], (1, 0))).reshape(rows, p // tile, threads)
    carry, sums = torch.zeros_like(w[:, 0]), []
    for q in range(p // tile):
        s = (carry[:, None] + before[:, q])[..., None] + own[:, q]
        sums.append(s.reshape(rows, tile))
        carry = s[:, -1, -1]
    return torch.cummax(torch.cat(sums, dim=-1)[:, :n], dim=-1).values


def systematic_step_reference(lw, u, x, skip=None, p0=0, n_local=None):
    """The plain twin of the kernel (module docstring)."""
    rows, n = lw.shape
    n_local = n - p0 if n_local is None else n_local
    m = torch.amax(lw, dim=-1)
    keep = ~torch.isfinite(m)
    if skip is not None:
        keep = keep | skip
    w = torch.exp(lw - torch.where(keep, torch.zeros_like(m), m)[:, None])
    cdf = cdf_reference(torch.where(keep[:, None], torch.zeros_like(w), w))
    total = cdf[:, -1:]
    ids = torch.arange(p0, p0 + n_local, device=lw.device)
    points = (ids.to(torch.float32) + u) * (total / torch.full_like(total, n))
    anc = torch.clamp(torch.searchsorted(cdf, points.contiguous(), side="left"), max=n - 1)
    anc = torch.where(keep[:, None], ids.expand(rows, n_local), anc)
    x_res = torch.gather(x, 1, anc[..., None].expand(rows, n_local, x.shape[-1]))
    lw_next = None if skip is None else torch.where(
        skip[:, None], lw, torch.full_like(lw, -math.log(n)))
    return anc, x_res, lw_next


def _check(lw, u, x, skip, p0, n_local):
    """Raises on anything the kernel does not take as it is."""
    named = (("lw", lw, torch.float32), ("u", u, torch.float32), ("x", x, torch.float32))
    named += () if skip is None else (("skip", skip, torch.bool),)
    for name, t, dtype in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor on the card, got {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != lw.device:
            raise ValueError(f"{name} on {t.device} but lw on {lw.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lw.dim() != 2 or not 1 <= lw.shape[1] <= MAX_PARTICLES:
        raise ValueError(f"lw must be [rows, N] with 1 <= N <= {MAX_PARTICLES}, "
                         f"got {tuple(lw.shape)}")
    rows, n = lw.shape
    if u.shape != (rows, 1):
        raise ValueError(f"u must be [{rows}, 1], got {tuple(u.shape)}")
    if x.dim() != 3 or x.shape[:2] != lw.shape or x.shape[2] < 1:
        raise ValueError(f"x must be [{rows}, {n}, C] with C >= 1, got {tuple(x.shape)}")
    if skip is not None and skip.shape != (rows,):
        raise ValueError(f"skip must be [{rows}], got {tuple(skip.shape)}")
    if not 0 <= p0 <= p0 + n_local <= n:
        raise ValueError(f"particles {p0} .. {p0 + n_local - 1} are not within 0 .. {n - 1}")


def systematic_step_cuda(lw, u, x, skip=None, p0=0, n_local=None):
    """The step (module docstring) in one launch of the kernel."""
    if lw.device.type != "cuda":
        raise ValueError(f"no resampling kernel for device {lw.device}")
    n_local = lw.shape[-1] - p0 if n_local is None else n_local
    _check(lw, u, x, skip, p0, n_local)
    (rows, n), c = lw.shape, x.shape[2]
    anc = torch.empty((rows, n_local), dtype=torch.int64, device=lw.device)
    x_res = torch.empty((rows, n_local, c), dtype=torch.float32, device=lw.device)
    lw_next = None if skip is None else torch.empty_like(lw)
    if rows == 0:
        return anc, x_res, lw_next
    scratch = torch.empty_like(lw) if n > TILE else None
    _build.launch(_build.load_library().epi_pf_resample, "pf_resample", lw.device,
                  lw.data_ptr(), u.data_ptr(), None if skip is None else skip.data_ptr(),
                  x.data_ptr(), anc.data_ptr(), x_res.data_ptr(),
                  None if lw_next is None else lw_next.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), rows, n, c, p0, n_local,
                  math.log(n))
    return anc, x_res, lw_next


def systematic_step(lw, u, x, skip=None, p0=0, n_local=None):
    """Phase ``pf_resample`` (module docstring): the kernel on a CUDA ``lw``
    (``lw`` and ``x`` made contiguous, a no-op on the filter's), the twin on
    a CPU one; any other device raises."""
    device = lw.device.type
    if device == "cuda":
        return systematic_step_cuda(lw.contiguous(), u, x.contiguous(), skip, p0, n_local)
    if device == "cpu":
        return systematic_step_reference(lw, u, x, skip, p0, n_local)
    raise ValueError(f"no resampling step for lw on {lw.device}")
