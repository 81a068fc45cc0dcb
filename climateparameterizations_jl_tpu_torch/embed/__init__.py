"""Host-model embedding: trained closures run inside dimensional simulations.

Port of ``climateparameterizations_jl_tpu/embed``:

- :mod:`column_model`: the reference's Oceananigans column embeddings
  (``free_convection/src/oceananigans_nn.jl:42-211``,
  ``wind_mixing/src/NDE_oceananigans.jl:331-475``): a dimensional 1x1xNz
  host column with the NN closure as a per-step forcing and implicit
  physics diffusion, run as paired baseline / baseline+NN simulations.
- :mod:`double_gyre`: the 3-D 96x96x32 wind-driven double gyre with the
  learned column closure at every (i, j) column
  (``free_convection/double_gyre.jl``, ``double_gyre_nn.jl``).
"""

from climateparameterizations_jl_tpu_torch.embed.column_model import (
    HostColumnModel,
    HostColumnState,
    run_embedded_column,
    run_paired_columns,
)
from climateparameterizations_jl_tpu_torch.embed.double_gyre import (
    DoubleGyreModel,
    DoubleGyreState,
    barotropic_streamfunction,
    double_gyre_step,
    run_double_gyre,
)

__all__ = [
    "HostColumnModel",
    "HostColumnState",
    "run_embedded_column",
    "run_paired_columns",
    "DoubleGyreModel",
    "DoubleGyreState",
    "barotropic_streamfunction",
    "double_gyre_step",
    "run_double_gyre",
]
