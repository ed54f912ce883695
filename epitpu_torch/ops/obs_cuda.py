"""The binomial observation weight on the card: ``csrc/obs_binomial.cu``.

``binomial_log_weight(y, x_obs, p, combine)`` writes ``logw [chains, N]``,
the ``combine`` ("min" or "sum") over the compartments of
``binom_logpmf(y, x_obs, p)``, in one kernel launch on PyTorch's current
stream.  Its plain twin is ``epitpu_torch.observe.models.binom_logpmf``
followed by ``torch.amin`` / ``torch.sum`` over the last axis, which the
kernel equals bit for bit on the card (the source says how);
``make_binomial_obs`` runs the twin on a CPU tensor and this function on a
CUDA tensor.

Nothing here reads a device value on the host, so a launch never
synchronizes.  The inputs: ``x_obs`` a float32 ``[chains, N, C]`` CUDA
tensor, ``y`` a float32 ``[C]`` on the same device (the filter passes a row
of its observations), ``p`` a float32 tensor there, 0-d or one value a
chain (``[chains, 1, 1]``, as the filter passes it, read at its stride);
anything else raises.  ``x_obs`` and ``y`` are made contiguous, a no-op on
the kernel routes' filter states; the final-state slice of the plain route
and of the exact sampler is a strided view, and is copied.
``_build.launch`` counts the launches in ``_build.LAUNCHES["obs_weight"]``
and the ``obs.weight_launches`` counter of ``epitpu_torch.profiling``.
"""
from __future__ import annotations

import torch

from . import _build

MAX_COMPARTMENTS = 127  # csrc/obs_binomial.cu:kMaxC
COMBINES = ("min", "sum")  # csrc/obs_binomial.cu:epi_obs_binomial's combine_mode


def _check(y, x_obs, p, combine):
    """``p``'s stride between chains; raises on anything the kernel does
    not take as it is."""
    if combine not in COMBINES:
        raise ValueError(f"unknown combine mode {combine!r}")
    for name, t in (("y", y), ("x_obs", x_obs), ("p", p)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor on the card, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x_obs.device:
            raise ValueError(f"{name} on {t.device} but x_obs on {x_obs.device}")
    if x_obs.dim() != 3 or not 1 <= x_obs.shape[2] <= MAX_COMPARTMENTS:
        raise ValueError(f"x_obs must be [chains, N, C] with 1 <= C <= {MAX_COMPARTMENTS}, "
                         f"got {tuple(x_obs.shape)}")
    chains, c = x_obs.shape[0], x_obs.shape[2]
    if y.shape != (c,):
        raise ValueError(f"y must be [{c}] for x_obs {tuple(x_obs.shape)}, got {tuple(y.shape)}")
    if p.dim() == 0:
        return 0
    if p.shape == (chains, 1, 1):
        return p.stride(0)
    # a [chains] p would broadcast against the compartments in the twin
    raise ValueError(f"p must be 0-d or [{chains}, 1, 1], got {tuple(p.shape)}")


def binomial_log_weight(y, x_obs, p, combine="min"):
    """``logw [chains, N]`` of ``x_obs [chains, N, C]`` against ``y [C]``
    with reporting probability ``p`` (module docstring), one launch."""
    if x_obs.device.type != "cuda":
        raise ValueError(f"no observation kernel for device {x_obs.device}")
    p_stride = _check(y, x_obs, p, combine)
    x_obs, y = x_obs.contiguous(), y.contiguous()
    chains, n, c = x_obs.shape
    out = torch.empty((chains, n), dtype=torch.float32, device=x_obs.device)
    if out.numel() == 0:
        return out
    _build.launch(_build.load_library().epi_obs_binomial, "obs_weight", x_obs.device,
                  y.data_ptr(), x_obs.data_ptr(), p.data_ptr(), p_stride, out.data_ptr(),
                  out.numel(), n, c, COMBINES.index(combine))
    return out
