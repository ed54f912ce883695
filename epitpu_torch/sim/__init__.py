from .exact import (default_max_events, exact_advance, exact_simulate_grid, grid_from_events,
                    simulate_exact_np)
from .samplers import binomial_from_draws, exact_binomial, fast_binomial, get_binomial_sampler
from .tauleap import advance, simulate, substep

__all__ = [
    "advance",
    "binomial_from_draws",
    "default_max_events",
    "exact_advance",
    "exact_binomial",
    "exact_simulate_grid",
    "fast_binomial",
    "get_binomial_sampler",
    "grid_from_events",
    "simulate",
    "simulate_exact_np",
    "substep",
]
