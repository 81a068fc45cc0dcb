"""The repo's studies on the port: the scripts that produce its scientific results.

- :mod:`flagship_training`     -> ``studies/flagship_training.py`` (the flagship NDE run,
  its ensembles, the held-out evaluation against mPP and KPP, the a-posteriori and
  embedded ablations, the step benchmark)
- :mod:`adjoint_parity`        -> ``studies/adjoint_parity.py`` (fixed-step discrete
  gradients against the fine-step limit, in f32 or f64, on any tridiagonal backend)
- :mod:`forward_scaling`       -> ``studies/forward_scaling.py`` (forward throughput across
  column batches on the fused RK4 kernel, or an eager loop over the matmul-assembly twin)
- :mod:`fused_kernel_sweep`    -> ``studies/fused_kernel_sweep.py`` (plain RK4 loops against
  the fused RK4 kernels and their launch shapes)
- :mod:`fc_fair_substep_check` -> ``studies/fc_fair_substep_check.py`` (the free-convection
  KPP / TKE baselines at fair substepping, every step on the Thomas kernel on the card)
- :mod:`gp_at_scale`           -> ``studies/gp_at_scale.py`` (the exact GPs at the flagship
  suite's full n: selection, build ladders, f32 against f64, the Gram kernel A/B, bands, GP-DE)

Run them as modules, e.g. ``python -m climateparameterizations_jl_tpu_torch.studies.flagship_training --help``.
"""
