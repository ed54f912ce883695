from .filter import FilterResult, particle_filter, particle_filter_jit
from .paths import sample_path, terminal_index, walk_path
from .resample import (
    get_resampler,
    multinomial_resample,
    normalized_weights,
    resample_particles,
    systematic_resample,
    systematic_resample_scatter,
)
from .tune import tune_particles

__all__ = [
    "FilterResult",
    "get_resampler",
    "multinomial_resample",
    "normalized_weights",
    "particle_filter",
    "particle_filter_jit",
    "resample_particles",
    "sample_path",
    "systematic_resample",
    "systematic_resample_scatter",
    "terminal_index",
    "tune_particles",
    "walk_path",
]
