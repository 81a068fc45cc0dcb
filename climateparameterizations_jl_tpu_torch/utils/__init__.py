"""Utilities: prediction helper, basis decomposition, timing and profiling.

The port's twins of the JAX package's ``utils/``:

- :mod:`predict`    -> ``src/predict.jl:12-34``
- :mod:`polynomial` -> ``src/polynomial_decomposition.jl:6-65``
- :mod:`profiling`  -> the reference's ad-hoc BenchmarkTools scripts
  (``wind_mixing/Benchmarking.jl``), as timing, roofline and
  ``torch.profiler`` trace helpers.
"""

from climateparameterizations_jl_tpu_torch.utils.polynomial import (
    basis_functions,
    polynomial_decomposition,
    reconstruct,
)
from climateparameterizations_jl_tpu_torch.utils.predict import predict
from climateparameterizations_jl_tpu_torch.utils.profiling import Timer, time_fn, trace

__all__ = [
    "predict",
    "basis_functions",
    "polynomial_decomposition",
    "reconstruct",
    "Timer",
    "time_fn",
    "trace",
]
