"""The repo's studies on the port: the scripts that produce its scientific results.

- :mod:`flagship_training` -> ``studies/flagship_training.py`` (the flagship NDE run,
  its ensembles, the held-out evaluation against mPP and KPP, the a-posteriori and
  embedded ablations, the step benchmark)
- :mod:`adjoint_parity`    -> ``studies/adjoint_parity.py`` (fixed-step discrete
  gradients against the fine-step limit, in f32 or f64, on any tridiagonal backend)

Run them as modules, e.g. ``python -m climateparameterizations_jl_tpu_torch.studies.flagship_training --help``.
"""
