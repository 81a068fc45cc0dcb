"""Predictive uncertainty of a deep-ensemble NDE closure on a held-out simulation.

Port of ``climateparameterizations_jl_tpu/eval/ensemble_uq.py``: the K
members' trajectories, their predictive mean and std bands (dimensional)
and per-timestep losses in scaled space. The scalings are affine and the MSE
convex, so the ensemble-MEAN prediction's loss is at most the member-mean
loss (Jensen).

The JAX package vmaps the solve over the members. Here the wind-mixing
members ride the solve's batch axis through one block-diagonal chain
(:func:`~..models.wind_mixing.pack_member_flux_nns`), so every implicit
solve is one Thomas launch for all members; the free-convection members run
one solve each (their closure may be a ``ConvMLP``, which has no
block-diagonal form; K is 4 in the flagship ensembles).
"""

from __future__ import annotations

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries, training_tensors
from climateparameterizations_jl_tpu_torch.eval.profile import (
    _grid,
    _per_timestep_channels,
    _require_uniform,
    _single_sim,
    _solve_scaled,
)
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    WindMixingModel,
    pack_member_flux_nns,
    split_uvT,
)
from climateparameterizations_jl_tpu_torch.train.deep_ensemble import ensemble_size, unstack_members


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def fc_ensemble_uq(model, stacked_nn, ds_test: ColumnTimeSeries, tsteps, *, solver: str = "split",
                   n_substeps: int = 2) -> dict:
    """Free-convection deep-ensemble bands on one held-out simulation.

    :func:`nde_ensemble_uq`'s output restricted to the T channel. One solve
    per member; ``split`` runs its implicit solves on the Thomas kernel for
    card tensors and on the plain scan on the CPU.
    """
    from climateparameterizations_jl_tpu_torch.models.free_convection import solve_free_convection_nde
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    ds_test = _single_sim(ds_test, "T", "fc_ensemble_uq")
    tsteps = np.asarray(tsteps)
    idx = torch.as_tensor(tsteps, dtype=torch.long, device=ds_test.T.device)
    T_truth = ds_test.T.index_select(-2, idx)
    t_row = ds_test.t[0] if ds_test.t.dim() > 1 else ds_test.t
    t_dim = t_row.index_select(0, idx)
    _require_uniform(t_dim, "fc_ensemble_uq")
    t_hat = t_dim / model.tau
    dt_save, n_save = t_hat[1] - t_hat[0], t_hat.shape[0] - 1
    T0 = model.T_scaling.scale(T_truth[..., 0, :])
    truth_scaled = model.T_scaling.scale(T_truth)
    backend = resolve_tridiag_backend("auto", n_save * n_substeps, T0.device)
    with torch.no_grad():
        trajs = torch.stack([
            solve_free_convection_nde(model, nn, T0, t_hat[0], dt_save, n_save, n_substeps, solver,
                                      tridiag_backend=backend)
            for nn in unstack_members(stacked_nn)])  # (K, Nt, Nz)
        mse_t = lambda a: torch.mean((a - truth_scaled) ** 2, dim=-1)  # noqa: E731
        member_T, mean_T = mse_t(trajs), mse_t(torch.mean(trajs, dim=0))
        dim = _to_numpy(model.T_scaling.unscale(trajs))
    zc, zf = _grid(model)
    return {
        "t": _to_numpy(t_dim),
        "zc": zc,
        "zf": zf,
        "n_members": np.asarray(ensemble_size(stacked_nn)),
        "losses_member_T": _to_numpy(member_T),
        "losses_ensemble_mean_T": _to_numpy(mean_T),
        "ensemble_T_mean": dim.mean(axis=0),
        "ensemble_T_std": dim.std(axis=0),
    }


def nde_ensemble_uq(model: WindMixingModel, stacked_nns, ds_test: ColumnTimeSeries, tsteps, *,
                    solver: str = "split", n_substeps: int = 4) -> dict:
    """Member trajectories and predictive mean/std for one held-out simulation.

    Returns a flat dict of numpy arrays:

    - ``t`` (s), ``zc``, ``zf``: coordinates;
    - ``ensemble_{u,v,T}_mean`` / ``_std``: dimensional ``(Nt, Nz)`` bands
      across members;
    - ``losses_member_T``: scaled per-timestep T loss per member ``(K, Nt)``;
    - ``losses_ensemble_mean_T``: per-timestep T loss of the MEAN prediction;
    - ``n_members``.

    All members go through one member-folded solve (module docstring).
    """
    ds_test = _single_sim(ds_test, "u", "nde_ensemble_uq")
    s = model.scalings
    batch = training_tensors(ds_test, s, tsteps, tau=model.tau, diurnal=model.diurnal)
    t = batch.t
    _require_uniform(t, "nde_ensemble_uq")
    Nz = model.Nz
    folded = pack_member_flux_nns(stacked_nns)
    if folded is None:
        raise ValueError("nde_ensemble_uq needs packable (same-depth, same-activation) MLP members")
    M = folded.n_members
    x0 = batch.x0[..., None, :].expand(*batch.x0.shape[:-1], M, batch.x0.shape[-1])
    with torch.no_grad():
        traj = _solve_scaled(model, folded, batch.bcs, x0, t, solver, n_substeps)
        trajs = torch.movedim(traj, -2, 0)  # (Nt, M, 3 Nz) -> (M, Nt, 3 Nz)
        member_T = torch.stack([_per_timestep_channels(tr, batch.targets, Nz, model.dz_hat)["T"] for tr in trajs])
        mean_T = _per_timestep_channels(torch.mean(trajs, dim=0), batch.targets, Nz, model.dz_hat)["T"]
        u, v, T = split_uvT(trajs, Nz)
        dims = {name: _to_numpy(scale.unscale(arr)) for name, scale, arr in (("u", s.u, u), ("v", s.v, v),
                                                                              ("T", s.T, T))}
    zc, zf = _grid(model)
    out = {
        "t": _to_numpy(t) * float(model.tau),
        "zc": zc,
        "zf": zf,
        "n_members": np.asarray(M),
        "losses_member_T": _to_numpy(member_T),
        "losses_ensemble_mean_T": _to_numpy(mean_T),
    }
    for name, dim in dims.items():  # affine: unscale commutes with the member mean
        out[f"ensemble_{name}_mean"] = dim.mean(axis=0)
        out[f"ensemble_{name}_std"] = dim.std(axis=0)
    return out
