"""NDE-profile evaluation helpers.

Partial port of ``climateparameterizations_jl_tpu/eval/profile.py``: the
four helpers that ``eval/ensemble_uq.py`` uses (per-timestep loss
channels, the uniform-grid guard, the scaled solve and the column grid).
The harnesses ``nde_profile`` and ``free_convection_profile`` compare
against the KPP and TKE baselines, which are not ported yet
(``ROADMAP.md``, queue 1, items 5 and 10).
"""

from __future__ import annotations

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    solve_wind_mixing_nde,
    solve_wind_mixing_split,
    split_uvT,
)


def _per_timestep_channels(pred, target, Nz: int, dz_hat: float) -> dict:
    """Per-timestep (u, v, T, du/dz, dv/dz, dT/dz) MSE channels.

    ``pred``/``target``: scaled states ``(Nt, 3 Nz)`` (time-major). Returns
    six ``(Nt,)`` tensors (``training_postprocessing.jl:390-470``).
    """
    pu, pv, pT = split_uvT(pred, Nz)
    tu, tv, tT = split_uvT(target, Nz)
    mse = lambda a, b: torch.mean((a - b) ** 2, dim=-1)  # noqa: E731
    dz = lambda a: d_center_to_face(a, dz_hat)  # noqa: E731
    return {"u": mse(pu, tu), "v": mse(pv, tv), "T": mse(pT, tT),
            "du": mse(dz(pu), dz(tu)), "dv": mse(dz(pv), dz(tv)), "dT": mse(dz(pT), dz(tT))}


def _require_uniform(t, where: str):
    """Fixed-step solvers integrate on a uniform save grid: reject a non-uniform tstep selection."""
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    dt = np.diff(np.asarray(t, np.float64))
    if dt.size and not np.allclose(dt, dt[0], rtol=1e-4, atol=0.0):
        raise ValueError(f"{where}: tsteps must be uniformly spaced (got save intervals {dt[:4]}...)")


def _solve_scaled(model, nns, bcs, x0, t, solver: str, n_substeps: int):
    """The scaled trajectory ``(Nt, ..., 3 Nz)`` on the save grid ``t``.

    ``split`` runs its implicit solves on the Thomas kernel for card tensors
    and on the plain scan on the CPU (``resolve_tridiag_backend("auto")``;
    the JAX function uses its scan, which the kernel matches bit for bit).
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    t0, dt_save, n_save = float(t[0]), float(t[1] - t[0]), t.shape[0] - 1
    if solver == "split":
        backend = resolve_tridiag_backend("auto", n_save * n_substeps, x0.device)
        return solve_wind_mixing_split(model, nns, bcs, x0, t0, dt_save, n_save, n_substeps=n_substeps,
                                       tridiag_backend=backend)
    if solver not in ("rk4", "euler", "heun"):
        raise ValueError(f"unknown solver {solver!r} (expected split/rk4/euler/heun)")
    return solve_wind_mixing_nde(model, nns, bcs, x0, t0, dt_save, n_save, n_substeps=n_substeps, method=solver)


def _grid(model):
    """``(zc, zf)`` cell-center and face depths of the model's column (numpy)."""
    Nz, H = model.Nz, float(model.H)
    zc = (np.arange(Nz) + 0.5) / Nz * H - H
    zf = np.arange(Nz + 1) / Nz * H - H
    return zc, zf
