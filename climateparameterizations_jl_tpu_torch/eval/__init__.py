"""Evaluation harness: NDE-profile comparisons, loss matrices, figures and the training report.

Port of the JAX package's ``eval/`` (see the module docstrings):

- :mod:`profile`     -> ``wind_mixing/src/training_postprocessing.jl:250-632``
- :mod:`loss_matrix` -> ``free_convection/src/testing.jl:186-231``
- :mod:`animations`  -> ``free_convection/src/animations.jl``, ``wind_mixing/src/animation.jl``
  (matplotlib; GIF via pillow, mp4 via OpenCV)
- :mod:`report`      -> ``wind_mixing/src/animation.jl:832-962`` (``animate_training_results``)
"""

from climateparameterizations_jl_tpu_torch.eval.ensemble_uq import fc_ensemble_uq, nde_ensemble_uq
from climateparameterizations_jl_tpu_torch.eval.loss_matrix import loss_matrix, solution_history
from climateparameterizations_jl_tpu_torch.eval.profile import (
    ProfileEvaluation,
    free_convection_profile,
    nde_profile,
    nde_profile_from_saved,
)


def __getattr__(name):
    # Lazy, as in the JAX package: the report is a file-writing orchestrator, off the solvers' import path.
    if name == "training_report":
        from climateparameterizations_jl_tpu_torch.eval.report import training_report

        return training_report
    raise AttributeError(name)


__all__ = [
    "ProfileEvaluation",
    "nde_profile",
    "nde_profile_from_saved",
    "free_convection_profile",
    "nde_ensemble_uq",
    "fc_ensemble_uq",
    "loss_matrix",
    "solution_history",
    "training_report",
]
