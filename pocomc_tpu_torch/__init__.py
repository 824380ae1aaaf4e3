"""pocomc_tpu_torch: Preconditioned Monte Carlo in PyTorch, with CUDA kernels
for NVIDIA Hopper.

The PyTorch port of ``pocomc_tpu`` (which stays the reference it is tested
against). Modules mirror the JAX package's paths. The port imports torch,
numpy and scipy, never JAX.

Precision: flow and likelihood compute run in full fp32. Importing this
package sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: reduced matmul precision NaNs
spline training and adds noise to the logZ ladder (the JAX package's
hardest-won rule). The two hand-written kernels (``ops/flow_kernels.py``)
use fp32 FMA only.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ._version import version, __version__  # noqa: E402
from .prior import (Prior, Normal, Uniform, LogUniform, TruncatedNormal,  # noqa: E402
                    LogNormal, Beta, Gamma, Exponential, HalfNormal, Cauchy,
                    StudentT, Laplace)
from .scaler import Reparameterize  # noqa: E402
from .particles import Particles  # noqa: E402
from .models.flow import Flow  # noqa: E402
from .models.geometry import Geometry  # noqa: E402
from .models.student import fit_mvstud  # noqa: E402
from .sampler import Sampler  # noqa: E402
from .parallel import MPIPool, ParticleMesh, initialize_distributed  # noqa: E402
from .ops.weights import (effective_sample_size, unique_sample_size,  # noqa: E402
                          compute_ess, increment_logz, trim_weights)
from .ops.resampling import systematic_resample, multinomial_resample  # noqa: E402

# the JAX package's public names
__all__ = [
    "Sampler", "Prior", "Flow", "Reparameterize", "Particles", "Geometry",
    "MPIPool", "ParticleMesh", "initialize_distributed", "fit_mvstud",
    "Normal", "Uniform", "LogUniform", "TruncatedNormal", "LogNormal",
    "Beta", "Gamma", "Exponential", "HalfNormal", "Cauchy", "StudentT",
    "Laplace",
    "effective_sample_size", "unique_sample_size", "compute_ess",
    "increment_logz", "trim_weights", "systematic_resample",
    "multinomial_resample",
    "version", "__version__",
]
