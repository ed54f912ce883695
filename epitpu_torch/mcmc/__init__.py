from .adaptive import Welford
from .forecast import forecast_from_result, posterior_forecast
from .pmmh import (PMMHResult, PMMHState, default_telemetry, particle_mcmc,
                   particle_mcmc_chains, particle_mcmc_jit)

__all__ = [
    "PMMHResult",
    "PMMHState",
    "Welford",
    "default_telemetry",
    "forecast_from_result",
    "particle_mcmc",
    "particle_mcmc_chains",
    "particle_mcmc_jit",
    "posterior_forecast",
]
