"""Declarative compartment-model specification (torch counterpart of
``epitpu.models.base``).

A model is data: a stoichiometry matrix, a source-compartment vector and a
batched rate function ``(x[..., C], theta[..., d]) -> a[..., R]``.  The
simulator, filter and PMMH are generic over any ``CompartmentModel``.  On
the card each model takes one path of the tau-leap kernel
(``epitpu_torch.ops.tauleap_cuda.route``): a model that carries a
``KernelSpec`` (the built-in families) its hand-written functor, any other
model whose reactions have unique sources a functor generated from its own
``rate_fn``, and a model whose reactions share a source (competing
hazards) the plain torch twin on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """What the CUDA tau-leap kernel compiles in for a built-in model:
    ``family`` (one of ``epitpu_torch.ops.tauleap_cuda.FAMILIES``), the
    group count ``k`` and, for subgroups, ``transpose`` (force
    ``sum_p beta[p, g] i_p``, the reference SSA's dynamics)."""

    family: str
    k: int = 1
    transpose: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class CompartmentModel:
    """A continuous-time Markov jump process on integer compartment counts.

    stoich: ``[R, C]`` int array, row r the state change of reaction r.
    source: ``[R]`` int array, the compartment whose count gates reaction r.
    rate_fn: ``(x[..., C], theta[..., d]) -> a[..., R]`` propensities.
    init_fn: ``(generator, shape, n_population, mu) -> x0[*shape, C]``.
    kernel: the hand-written CUDA functor's descriptor; None for a
      user-defined model.
    terminal_compartments: indices whose total hitting zero makes the chain
      absorbing (I for SIR; E and I for SEIR).  Informational, as in epitpu:
      with zero rates the simulator freezes by itself.
    """

    name: str
    compartments: Tuple[str, ...]
    stoich: np.ndarray
    source: np.ndarray
    rate_fn: Callable
    theta_dim: int
    obs_dim: int
    observe_map: Callable
    theta_names: Tuple[str, ...]
    init_fn: Callable = None
    kernel: Optional[KernelSpec] = None
    terminal_compartments: Tuple[int, ...] = ()

    @property
    def num_compartments(self) -> int:
        return len(self.compartments)

    @property
    def num_reactions(self) -> int:
        return int(self.stoich.shape[0])

    @property
    def sources_unique(self) -> bool:
        """True when no two reactions share a source compartment."""
        return len(set(self.source.tolist())) == len(self.source)


def _identity_observe(x):
    return x


def make_model(name, compartments, stoich, source, rate_fn, theta_dim,
               theta_names, obs_dim=None, observe_map=_identity_observe,
               init_fn=None, kernel=None, terminal_compartments=()) -> CompartmentModel:
    stoich = np.asarray(stoich, dtype=np.int32)
    source = np.asarray(source, dtype=np.int32)
    if stoich.ndim != 2 or stoich.shape[1] != len(compartments):
        raise ValueError(f"stoich must be [R, {len(compartments)}], got {stoich.shape}")
    if source.shape != (stoich.shape[0],):
        raise ValueError("source must have one entry per reaction")
    for r in range(stoich.shape[0]):
        if stoich[r, source[r]] != -1:
            raise ValueError(f"reaction {r} must decrement its source compartment by 1")
    return CompartmentModel(
        name=name,
        compartments=tuple(compartments),
        stoich=stoich,
        source=source,
        rate_fn=rate_fn,
        theta_dim=theta_dim,
        obs_dim=len(compartments) if obs_dim is None else obs_dim,
        observe_map=observe_map,
        theta_names=tuple(theta_names),
        init_fn=init_fn,
        kernel=kernel,
        terminal_compartments=tuple(int(c) for c in terminal_compartments),
    )
