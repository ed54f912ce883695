"""epitpu_torch — the PyTorch and CUDA port of epitpu.

SIR, SEIR and K-group SIR models, tau-leap simulation, the bootstrap
particle filter, PMMH with pooled adaptive proposals, bit-identical
segments and live telemetry, posterior forecasting, ABC rejection, the ODE
ground truth, diagnostics and likelihood surfaces, run artifacts and
resumable checkpoints, the plot suite, the trajectory-overlay app, and the
experiment runner ``python -m epitpu_torch.cli.run`` over them.  Every
entry point runs on the card unless the caller asks for the CPU (by
``device="cpu"`` or CPU tensors; ``epitpu_torch.device``).  On a CUDA
device the tau-leap propagation, the binomial observation weight and the
filter's likelihood update run in hand-written kernels
(``epitpu_torch/csrc/tauleap.cu``, ``obs_binomial.cu`` and ``pf_loglik.cu``,
built by nvcc at first use; their wrappers ``ops/tauleap_cuda.py``,
``ops/obs_cuda.py`` and ``ops/loglik_cuda.py`` launch them through
``ops/_build.launch``); on the CPU every function runs its plain torch
version.
The JAX package ``epitpu`` stays the reference this package is tested
against; nothing here imports it or JAX, and matplotlib only inside the
plotting functions.
"""
from .models import CompartmentModel, seir_model, sir_model, sir_subgroups_model
from .rng import PhiloxStream

__version__ = "0.1.0"

__all__ = ["CompartmentModel", "PhiloxStream", "seir_model", "sir_model",
           "sir_subgroups_model"]
