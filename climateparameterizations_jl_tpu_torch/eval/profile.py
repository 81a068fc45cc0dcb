"""Profile evaluation: a trained closure against the physics baselines and the LES truth.

Port of ``climateparameterizations_jl_tpu/eval/profile.py`` (reference
``NDE_profile``, ``wind_mixing/src/training_postprocessing.jl:250-632``). For
one held-out simulation :func:`nde_profile` gives the NDE solution (trained
NNs over the base closure), the mPP-only solution, the KPP baseline,
per-timestep six-channel losses of each against the truth, the total and
NN-only flux decompositions along each trajectory and the local Richardson
number, as one flat dict of numpy arrays with the JAX dict's keys, shapes
and axis order. :func:`free_convection_profile` is the free-convection
harness (``free_convection/test_free_convection_nde.jl:110-165``: truth,
NDE, conv-adj or the bare "base", KPP and TKE).

Every solve runs its implicit steps through ``resolve_tridiag_backend("auto")``:
the Thomas kernel for card tensors, the plain scan on the CPU. The JAX
package vmaps the flux diagnostics over the saved frames; here the
``(Nt, 3 Nz)`` trajectory goes through one batched call with a ``(Nt,)``
time vector (``_effective_bcs`` gives each frame its own diurnal flux).
``include_embedded`` adds the host-column comparison (``embed/column_model.py``):
the closure inside the dimensional host column, baseline and +NN, one
Thomas launch per host step on the card; its flux diagnostics also go
through one call over the saved frames, with the frames' times broadcast
over the time axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries, TrainingBatch, training_tensors
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    BoundaryConditions,
    FluxNNs,
    WindMixingModel,
    _nn_fluxes,
    join_uvT,
    predict_flux,
    solve_wind_mixing_nde,
    solve_wind_mixing_split,
    split_uvT,
)
from climateparameterizations_jl_tpu_torch.physics.kpp import (
    KPPForcing,
    KPPParameters,
    KPPState,
    kpp_diagnostic_fluxes,
    solve_kpp,
)
from climateparameterizations_jl_tpu_torch.physics.richardson import richardson_profile
from climateparameterizations_jl_tpu_torch.physics.tke import (
    TKEParameters,
    TKEState,
    solve_tke,
    tke_diagnostic_heat_flux,
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


@dataclasses.dataclass
class ProfileEvaluation:
    """Flat bag of evaluation arrays (numpy); see :func:`nde_profile`."""

    data: dict

    def __getitem__(self, key):
        return self.data[key]

    def keys(self):
        return self.data.keys()

    def to_dict(self) -> dict:
        return dict(self.data)


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


def _single_sim(ds: ColumnTimeSeries, field: str, where: str) -> ColumnTimeSeries:
    """``ds`` with a leading suite axis of one dropped; a larger suite raises.

    The solvers return time-leading trajectories and the truth is
    batch-leading, so a stacked suite would broadcast the per-timestep
    channels into a cross-time matrix.
    """
    if getattr(ds, field).dim() <= 2:
        return ds
    if getattr(ds, field).shape[0] != 1:
        raise ValueError(f"{where} evaluates ONE held-out simulation; got a stacked suite of "
                         f"{getattr(ds, field).shape[0]} (run each simulation through its own profile)")
    return dataclasses.replace(ds, **{f.name: getattr(ds, f.name)[0] for f in dataclasses.fields(ds)
                                      if getattr(ds, f.name) is not None and getattr(ds, f.name).dim() > 0})


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _ri(model: WindMixingModel, u, v, T):
    """Ri channel of a SCALED (u, v, T) trajectory; ``eps`` matches ``_face_nu``'s 1e-7."""
    s = model.scalings
    return richardson_profile(u, v, T, model.H, model.g, model.alpha, s.u.sigma, s.v.sigma, s.T.sigma, eps=1e-7)


def _trajectory_diagnostics(model: WindMixingModel, nns, bcs: BoundaryConditions, traj, t) -> dict:
    """Fluxes (total and NN-only, dimensional) and Ri along a scaled trajectory ``(Nt, 3 Nz)``, times ``t (Nt,)``."""
    s = model.scalings
    uw, vw, wT = predict_flux(model, nns, bcs, traj, t)
    nn_uw, nn_vw, nn_wT = _nn_fluxes(model, nns, bcs, traj)
    u, v, T = split_uvT(traj, model.Nz)
    # Zero-weights faces are in the linear F/sigma convention (BC face =
    # bc - scale(0) = F_bc / sigma); the others are affine-scaled.
    if model.zero_weights:
        dim = lambda sc, y: sc.sigma * y  # noqa: E731
    else:
        dim = lambda sc, y: sc.unscale(y)  # noqa: E731
    return {
        "uw": dim(s.uw, uw), "vw": dim(s.vw, vw), "wT": dim(s.wT, wT),
        # The NN contribution in dimensional units (training_postprocessing.jl:474-496).
        "nn_uw": s.uw.sigma * nn_uw, "nn_vw": s.vw.sigma * nn_vw, "nn_wT": s.wT.sigma * nn_wT,
        "Ri": _ri(model, u, v, T),
    }


def _add_scalar_aggregates(out: dict) -> None:
    """Scalar ``loss_{m}`` / ``loss_{m}_gradient`` per compared member (``training_postprocessing.jl:534-631``)."""
    members = sorted({k[len("losses_"): -2] for k in out if k.startswith("losses_") and k.endswith("_u")})
    for m in members:
        out[f"loss_{m}"] = float(np.mean([out[f"losses_{m}_{c}"] for c in ("u", "v", "T")]))
        out[f"loss_{m}_gradient"] = float(np.mean([out[f"losses_{m}_{c}"] for c in ("du", "dv", "dT")]))


def nde_profile(model: WindMixingModel, nns, ds_test: ColumnTimeSeries, tsteps, *, solver: str = "split",
                n_substeps: int = 4, kpp_params: KPPParameters | None = None, include_kpp: bool = True,
                include_embedded: bool = False, embedded_substeps: int = 10,
                kpp_n_substeps: int = 1) -> ProfileEvaluation:
    """Full comparison for one held-out wind-mixing simulation.

    ``model.scalings`` must be the TRAINING scalings (the reference's
    ``override_scalings``); ``tsteps`` selects the evaluation window.
    ``kpp_n_substeps`` KPP steps per save interval: 1 steps KPP at the save
    spacing, as the reference's harness does
    (``wind_mixing/src/k_profile_parameterization.jl:51``); the eval stride
    gives KPP its native 600 s step. Diurnal models run KPP with the daily
    cycle and diagnose its fluxes under the flux of each saved frame.
    ``include_embedded`` adds the paired host-column runs (``embedded_baseline``
    and ``embedded``, ``embedded_substeps`` host steps per save interval)
    with their losses, flux and Ri channels.
    Parity: ``NDE_profile`` (``training_postprocessing.jl:250-632``).
    """
    ds_test = _single_sim(ds_test, "u", "nde_profile")
    s = model.scalings
    batch: TrainingBatch = training_tensors(ds_test, s, tsteps, tau=model.tau, diurnal=model.diurnal)
    t = batch.t
    _require_uniform(t, "nde_profile")
    t_dim = _np(t) * float(model.tau)
    Nz = model.Nz
    zero_nns = FluxNNs(uw=None, vw=None, wT=None)
    zc, zf = _grid(model)
    out: dict = {"t": t_dim, "zc": zc, "zf": zf}

    def unpack(name, traj):
        u, v, T = split_uvT(traj, Nz)
        out[f"{name}_u"], out[f"{name}_v"], out[f"{name}_T"] = _np(s.u.unscale(u)), _np(s.v.unscale(v)), _np(
            s.T.unscale(T))

    with torch.no_grad():
        traj_nde = _solve_scaled(model, nns, batch.bcs, batch.x0, t, solver, n_substeps)
        traj_mpp = _solve_scaled(model, zero_nns, batch.bcs, batch.x0, t, solver, n_substeps)
        truth = batch.targets
        unpack("truth", truth)
        unpack("nde", traj_nde)
        unpack("mpp", traj_mpp)
        idx = torch.as_tensor(np.asarray(tsteps), dtype=torch.long, device=ds_test.T.device)
        for name in ("uw", "vw", "wT"):
            out[f"truth_{name}"] = _np(getattr(ds_test, name).index_select(-2, idx))

        for name, traj, dnns in (("nde", traj_nde, nns), ("mpp", traj_mpp, zero_nns)):
            for k, v in _trajectory_diagnostics(model, dnns, batch.bcs, traj, t).items():
                out[f"{name}_{k}"] = _np(v)
        out["truth_Ri"] = _np(_ri(model, *split_uvT(truth, Nz)))

        for name, traj in (("nde", traj_nde), ("mpp", traj_mpp)):
            for k, v in _per_timestep_channels(traj, truth, Nz, model.dz_hat).items():
                out[f"losses_{name}_{k}"] = _np(v)

        if include_kpp:
            _kpp_baseline(out, model, ds_test, tsteps, truth, kpp_params, kpp_n_substeps)
        if include_embedded:
            _embedded_wind_mixing(out, model, nns, ds_test, tsteps, truth, embedded_substeps)
    _add_scalar_aggregates(out)
    return ProfileEvaluation(out)


def _embedded_wind_mixing(out: dict, model: WindMixingModel, nns, ds_test: ColumnTimeSeries, tsteps, truth,
                          embedded_substeps: int) -> None:
    """:func:`nde_profile`'s embedded channels, written into ``out``.

    Parity: ``solve_oceananigans_modified_pacanowski_philander_nn`` and
    ``NDE_profile_oceananigans`` (``training_postprocessing.jl:634-1156``):
    the same NNs inside the host column, baseline and +NN, over the host
    the a-posteriori trainer uses (``host_for_wind_mixing``).
    """
    from climateparameterizations_jl_tpu_torch.embed.column_model import (
        HostColumnState,
        diagnose_host_fluxes,
        host_for_wind_mixing,
        run_paired_columns,
    )
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    s, Nz = model.scalings, model.Nz
    host = host_for_wind_mixing(model, ds_test.u_top, ds_test.theta_top, ds_test.theta_bottom,
                                diurnal_amplitude=ds_test.diurnal_amplitude)
    i0 = int(np.asarray(tsteps)[0])
    state0 = HostColumnState(u=ds_test.u[..., i0, :], v=ds_test.v[..., i0, :], T=ds_test.T[..., i0, :])
    t_dim = out["t"]
    n_frames = len(t_dim) - 1
    dtype, dev = state0.T.dtype, state0.T.device
    dt_emb = torch.as_tensor((t_dim[-1] - t_dim[0]) / (n_frames * embedded_substeps), dtype=dtype, device=dev)
    backend = resolve_tridiag_backend("auto", n_frames * embedded_substeps, dev)
    baseline, with_nn = run_paired_columns(host, nns, state0, dt_emb, n_frames, embedded_substeps, backend,
                                           t0=float(t_dim[0]))
    # Each frame's own time, broadcast over the time axis of the trajectory (Nt, ..., Nz).
    t_frames = torch.as_tensor(t_dim, dtype=dtype, device=dev).reshape((-1,) + (1,) * (state0.T.dim() - 1))
    for name, sol, run_nns in (("embedded_baseline", baseline, None), ("embedded", with_nn, nns)):
        u, v, T = (torch.movedim(a, 0, -2) for a in (sol.u, sol.v, sol.T))
        out[f"{name}_u"], out[f"{name}_v"], out[f"{name}_T"] = _np(u), _np(v), _np(T)
        scaled = join_uvT(s.u.scale(u), s.v.scale(v), s.T.scale(T))
        for k, val in _per_timestep_channels(scaled, truth, Nz, model.dz_hat).items():
            out[f"losses_{name}_{k}"] = _np(val)
        # Embedded flux and Ri diagnostics (NDE_oceananigans.jl:157-286), every frame in one call.
        fluxes = diagnose_host_fluxes(host, run_nns, sol, t_frames)
        for flux, val in zip(("uw", "vw", "wT"), fluxes):
            out[f"{name}_{flux}"] = _np(torch.movedim(val, 0, -2))
        out[f"{name}_Ri"] = _np(_ri(model, *split_uvT(scaled, Nz)))


def _kpp_baseline(out: dict, model: WindMixingModel, ds_test: ColumnTimeSeries, tsteps, truth, kpp_params,
                  kpp_n_substeps: int) -> None:
    """:func:`nde_profile`'s KPP channels (``training_postprocessing.jl:368-388``), written into ``out``."""
    from climateparameterizations_jl_tpu_torch.core.constants import diurnal_cycle

    s, Nz = model.scalings, model.Nz
    dev = ds_test.T.device
    kpp_params = kpp_params if kpp_params is not None else KPPParameters.default(device=dev)
    i0 = int(np.asarray(tsteps)[0])
    state0 = KPPState(U=ds_test.u[..., i0, :], V=ds_test.v[..., i0, :], T=ds_test.T[..., i0, :])
    forcing = KPPForcing(Fu=ds_test.u_top, Fb=ds_test.theta_top * ds_test.g * ds_test.alpha,
                         dTdz_bottom=ds_test.theta_bottom)
    kpp = solve_kpp(state0, out["t"], kpp_params, forcing, model.H, Nz, ds_test.f, ds_test.g, ds_test.alpha,
                    n_substeps=kpp_n_substeps, diurnal=model.diurnal)  # diurnal: Fb is the cycle's amplitude
    out["kpp_u"], out["kpp_v"], out["kpp_T"] = _np(kpp.U), _np(kpp.V), _np(kpp.T)
    kpp_scaled = join_uvT(s.u.scale(kpp.U), s.v.scale(kpp.V), s.T.scale(kpp.T))
    for k, v in _per_timestep_channels(kpp_scaled, truth, Nz, model.dz_hat).items():
        out[f"losses_kpp_{k}"] = _np(v)
    # The flux diagnostics of a diurnal run use the flux of each saved frame, not the amplitude.
    forcing_diag = forcing
    if model.diurnal:
        cyc = diurnal_cycle(torch.as_tensor(out["t"], dtype=kpp.T.dtype, device=dev))
        cyc = cyc.reshape(cyc.shape + (1,) * (kpp.T.dim() - 2))  # left-aligned against (Nt, ..., Nz)
        forcing_diag = KPPForcing(Fu=forcing.Fu, Fb=forcing.Fb * cyc, dTdz_bottom=forcing.dTdz_bottom)
    as_t = lambda a: torch.as_tensor(a, dtype=kpp.T.dtype, device=dev)  # noqa: E731
    kpp_uw, kpp_vw, kpp_wT = kpp_diagnostic_fluxes(kpp.U, kpp.V, kpp.T, as_t(out["zf"]), as_t(out["zc"]), kpp_params,
                                                   forcing_diag, ds_test.g, ds_test.alpha, model.H, Nz)
    out["kpp_uw"], out["kpp_vw"], out["kpp_wT"] = _np(kpp_uw), _np(kpp_vw), _np(kpp_wT)
    out["kpp_Ri"] = _np(_ri(model, *split_uvT(kpp_scaled, Nz)))


def nde_profile_from_saved(sim_dir: str, model: WindMixingModel, ds_truth: ColumnTimeSeries,
                           tsteps) -> ProfileEvaluation:
    """The embedded comparison assembled from SAVED ``baseline.jld2`` / ``neural_network.jld2`` files.

    Parity: ``NDE_profile_oceananigans`` (``training_postprocessing.jl:808-1156``):
    the saved profiles are matched to the truth by TIME (any save interval)
    and give the ``embedded_*`` / ``embedded_baseline_*`` channels with
    their per-timestep losses. The files are read by ``data/lesbrary.py`` (the port's own HDF5 reader).
    """
    import os

    from climateparameterizations_jl_tpu_torch.data.lesbrary import read_les_profiles

    s, Nz = model.scalings, model.Nz
    batch: TrainingBatch = training_tensors(ds_truth, s, tsteps, tau=model.tau)
    truth = batch.targets
    if truth.dim() == 3 and truth.shape[0] == 1:
        truth = truth[0]
    if truth.dim() != 2:
        raise ValueError(f"nde_profile_from_saved compares one saved run against ONE truth simulation; got a "
                         f"stacked suite of {truth.shape[0]} (pass a single-sim ds_truth)")
    t_truth = _np(batch.t).astype(np.float64) * float(model.tau)
    zc, zf = _grid(model)
    out: dict = {"t": t_truth, "zc": zc, "zf": zf}
    with torch.no_grad():
        tu, tv, tT = split_uvT(truth, Nz)
        out["truth_u"], out["truth_v"], out["truth_T"] = _np(s.u.unscale(tu)), _np(s.v.unscale(tv)), _np(
            s.T.unscale(tT))
        for tag, name in (("baseline", "embedded_baseline"), ("neural_network", "embedded")):
            saved = read_les_profiles(os.path.join(sim_dir, f"{tag}.jld2"))
            t_saved = saved.t.numpy().astype(np.float64).reshape(-1)
            tol = 1e-3 * max(float(np.max(t_truth) - np.min(t_truth)), 1.0) / max(len(t_truth) - 1, 1)
            idx = np.abs(t_saved[None, :] - t_truth[:, None]).argmin(axis=1)
            err = np.abs(t_saved[idx] - t_truth)
            if np.any(err > tol):
                raise ValueError(f"{tag}.jld2 save times do not cover the requested evaluation times (worst "
                                 f"mismatch {err.max():.3g} s); saved t in [{t_saved.min():.3g}, {t_saved.max():.3g}]")
            u, v, T = (getattr(saved, k).numpy().reshape(-1, Nz)[idx] for k in ("u", "v", "T"))
            out[f"{name}_u"], out[f"{name}_v"], out[f"{name}_T"] = u, v, T
            for flux in ("uw", "vw", "wT"):
                arr = getattr(saved, flux).numpy()
                out[f"{name}_{flux}"] = arr.reshape(-1, arr.shape[-1])[idx]
            # The saved f32 profiles scale in the truth's precision, as JAX promotes them to the scalings' dtype.
            as_t = lambda a: torch.as_tensor(a, device=truth.device, dtype=truth.dtype)  # noqa: E731
            scaled = join_uvT(s.u.scale(as_t(u)), s.v.scale(as_t(v)), s.T.scale(as_t(T)))
            for k, val in _per_timestep_channels(scaled, truth, Nz, model.dz_hat).items():
                out[f"losses_{name}_{k}"] = _np(val)
            out[f"{name}_Ri"] = _np(_ri(model, *split_uvT(scaled, Nz)))
    _add_scalar_aggregates(out)
    return ProfileEvaluation(out)


def free_convection_profile(model, nn, ds_test: ColumnTimeSeries, tsteps, *, n_substeps: int = 2,
                            solver: str = "split", kpp_params: KPPParameters | None = None,
                            tke_params: TKEParameters | None = None, include_kpp: bool = True,
                            include_tke: bool = True, include_embedded: bool = False, embedded_substeps: int = 10,
                            kpp_n_substeps: int = 1, tke_n_substeps: int | None = None) -> ProfileEvaluation:
    """Free-convection comparison: truth, NDE, conv-adj only (or "base"), KPP and TKE.

    ``kpp_n_substeps`` as in :func:`nde_profile`; ``tke_n_substeps``
    defaults to it, so one knob gives both baselines their native step. The
    NN-free member is ``conv_adj`` when the model's base closure is
    convective adjustment, else ``base`` (surface fluxes only).
    ``include_embedded`` adds the conv-adj host column, baseline and +NN
    (``embedded_substeps`` host steps per save interval), and the NN heat
    flux along the +NN run. Parity:
    ``free_convection/test_free_convection_nde.jl:110-165``.
    """
    from climateparameterizations_jl_tpu_torch.models.free_convection import diagnose_wT, solve_free_convection_nde
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    ds_test = _single_sim(ds_test, "T", "free_convection_profile")
    dev = ds_test.T.device
    tsteps = np.asarray(tsteps)
    idx = torch.as_tensor(tsteps, dtype=torch.long, device=dev)
    T_truth = ds_test.T.index_select(-2, idx)
    t_row = ds_test.t[0] if ds_test.t.dim() > 1 else ds_test.t
    t_dim = _np(t_row.index_select(0, idx))
    _require_uniform(t_dim, "free_convection_profile")
    t_hat = torch.as_tensor(t_dim, device=dev) / model.tau
    dt_save, n_save = t_hat[1] - t_hat[0], t_hat.shape[0] - 1
    Nz = model.Nz
    T0_scaled = model.T_scaling.scale(T_truth[..., 0, :])
    zc, zf = _grid(model)
    out: dict = {"t": t_dim, "zc": zc, "zf": zf, "truth_T": _np(T_truth),
                 "truth_wT": _np(ds_test.wT.index_select(-2, idx))}

    base_label = "conv_adj" if model.base_closure == "convective_adjustment" else "base"
    backend = resolve_tridiag_backend("auto", n_save * n_substeps, dev)
    with torch.no_grad():
        T_truth_scaled = model.T_scaling.scale(T_truth)
        mse_t = lambda a, b: _np(torch.mean((a - b) ** 2, dim=-1))  # noqa: E731
        for name, run_nn in (("nde", nn), (base_label, None)):
            traj = solve_free_convection_nde(model, run_nn, T0_scaled, t_hat[0], dt_save, n_save, n_substeps,
                                             method=solver, tridiag_backend=backend)
            out[f"{name}_T"] = _np(model.T_scaling.unscale(traj))
            out[f"{name}_wT"] = _np(model.wT_scaling.unscale(diagnose_wT(model, run_nn, traj)))
            out[f"losses_{name}_T"] = mse_t(traj, T_truth_scaled)

        zeros = torch.zeros_like(T_truth[..., 0, :])
        Fb = ds_test.theta_top * ds_test.g * ds_test.alpha
        if include_kpp:
            kpp_params = kpp_params if kpp_params is not None else KPPParameters.default(device=dev)
            forcing = KPPForcing(Fu=torch.zeros_like(ds_test.u_top), Fb=Fb, dTdz_bottom=ds_test.theta_bottom)
            kpp = solve_kpp(KPPState(U=zeros, V=zeros, T=T_truth[..., 0, :]), t_dim, kpp_params, forcing, model.H,
                            Nz, ds_test.f, ds_test.g, ds_test.alpha, n_substeps=kpp_n_substeps)
            out["kpp_T"] = _np(kpp.T)
            out["losses_kpp_T"] = mse_t(model.T_scaling.scale(kpp.T), T_truth_scaled)
            # The heat-flux diagnostic with the nonlocal term (k_profile_parameterization.jl:3-47).
            as_t = lambda a: torch.as_tensor(a, dtype=kpp.T.dtype, device=dev)  # noqa: E731
            _, _, kpp_wT = kpp_diagnostic_fluxes(kpp.U, kpp.V, kpp.T, as_t(zf), as_t(zc), kpp_params, forcing,
                                                 ds_test.g, ds_test.alpha, model.H, Nz)
            out["kpp_wT"] = _np(kpp_wT)
        if include_tke:
            tke_params = tke_params if tke_params is not None else TKEParameters.default(device=dev)
            tke = solve_tke(TKEState(U=zeros, V=zeros, T=T_truth[..., 0, :], e=torch.full_like(zeros, 1e-6)), t_dim,
                            tke_params, torch.zeros_like(ds_test.u_top), Fb, model.H, Nz, ds_test.f, ds_test.g,
                            ds_test.alpha, n_substeps=tke_n_substeps if tke_n_substeps is not None else kpp_n_substeps,
                            dTdz_bottom=ds_test.theta_bottom)  # the KPP baseline's bottom BC
            out["tke_T"] = _np(tke.T)
            out["losses_tke_T"] = mse_t(model.T_scaling.scale(tke.T), T_truth_scaled)
            out["tke_wT"] = _np(tke_diagnostic_heat_flux(tke, model.H / Nz, tke_params, Fb, ds_test.g,
                                                         ds_test.alpha))
        if include_embedded:
            _embedded_free_convection(out, model, nn, ds_test, T_truth, T_truth_scaled, t_dim, n_save,
                                      embedded_substeps, mse_t)
    return ProfileEvaluation(out)


def _embedded_free_convection(out: dict, model, nn, ds_test: ColumnTimeSeries, T_truth, T_truth_scaled, t_dim,
                              n_save: int, embedded_substeps: int, mse_t) -> None:
    """:func:`free_convection_profile`'s embedded channels, written into ``out``.

    Parity: ``oceananigans_convective_adjustment_nn``
    (``free_convection/src/oceananigans_nn.jl:42-211``): the trained NN as
    a forcing in a dimensional column with implicit convective adjustment,
    over the host the FC a-posteriori trainer uses; then the NN heat flux
    along the +NN run (``diagnose_wT_NN``, ``oceananigans_nn.jl:184-192``).
    """
    from climateparameterizations_jl_tpu_torch.embed.column_model import (
        HostColumnState,
        diagnose_nn_heat_flux,
        host_for_free_convection,
        run_paired_columns,
    )
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    dtype, dev = T_truth.dtype, T_truth.device
    host = host_for_free_convection(model, ds_test.f, ds_test.g, ds_test.alpha, Ftheta=ds_test.theta_top,
                                    dTdz_bottom=ds_test.theta_bottom)
    zeros = torch.zeros_like(T_truth[..., 0, :])
    state0 = HostColumnState(u=zeros, v=zeros, T=T_truth[..., 0, :])
    dt_emb = torch.as_tensor((t_dim[-1] - t_dim[0]) / (n_save * embedded_substeps), dtype=dtype, device=dev)
    backend = resolve_tridiag_backend("auto", n_save * embedded_substeps, dev)
    nns = FluxNNs(uw=None, vw=None, wT=nn)
    baseline, with_nn = run_paired_columns(host, nns, state0, dt_emb, n_save, embedded_substeps, backend)
    for name, sol in (("embedded_baseline", baseline), ("embedded", with_nn)):
        T_emb = torch.movedim(sol.T, 0, -2)
        out[f"{name}_T"] = _np(T_emb)
        out[f"losses_{name}_T"] = mse_t(model.T_scaling.scale(T_emb), T_truth_scaled)
    out["embedded_wT"] = _np(diagnose_nn_heat_flux(host, nns, torch.movedim(with_nn.T, 0, -2)))
