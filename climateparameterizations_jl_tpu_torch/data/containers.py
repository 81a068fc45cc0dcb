"""Column time-series containers and training-tensor assembly.

Port of ``climateparameterizations_jl_tpu/data/containers.py`` (reference
``wind_mixing/src/data_containers.jl:219-427``). Arrays are time-major
``(Nt, Nz)``, and simulations stack on a leading ``(S, ...)`` axis so one
training step covers the whole suite. Coarse-graining is one matmul per
field at full fp32 (``core/coarse_grain.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.core.coarse_grain import (
    coarse_grain_center,
    coarse_grain_linear_interpolation,
)
from climateparameterizations_jl_tpu_torch.core.scalings import MinMaxScaling, ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.models.wind_mixing import BoundaryConditions, WindMixingScalings


@dataclasses.dataclass(frozen=True)
class ColumnTimeSeries:
    """One (or a stacked batch of) horizontally averaged column simulation(s).

    Profiles are unscaled and time-major: ``u, v, T`` are ``(..., Nt, Nz)``,
    fluxes ``uw, vw, wT`` are ``(..., Nt, Nz + 1)``, ``t`` is ``(..., Nt)``.
    Constants are 0-d (or ``(...,)`` when stacked). ``theta_top`` is the
    kinematic surface heat flux, ``u_top`` the kinematic momentum flux,
    ``theta_bottom`` the bottom temperature gradient. ``diurnal_amplitude``
    is the diurnal surface-flux amplitude (0 for constant-flux sims, ``None``
    when unknown).
    """

    u: torch.Tensor
    v: torch.Tensor
    T: torch.Tensor
    uw: torch.Tensor
    vw: torch.Tensor
    wT: torch.Tensor
    t: torch.Tensor
    H: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    u_top: torch.Tensor
    theta_top: torch.Tensor
    theta_bottom: torch.Tensor
    diurnal_amplitude: torch.Tensor | None = None

    @property
    def Nz(self) -> int:
        return self.T.shape[-1]

    @property
    def Nt(self) -> int:
        return self.T.shape[-2]

    def to(self, device) -> "ColumnTimeSeries":
        """Every tensor field moved to ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if getattr(self, f.name) is not None
        })


def coarsen_dataset(ds: ColumnTimeSeries, n: int = 32) -> ColumnTimeSeries:
    """Coarse-grain all profiles to ``n`` centers / ``n + 1`` faces.

    Cell fields are block-mean pooled; face fields use endpoint-preserving
    linear interpolation (``data_containers.jl:343-360``).
    """
    return dataclasses.replace(
        ds,
        u=coarse_grain_center(ds.u, n),
        v=coarse_grain_center(ds.v, n),
        T=coarse_grain_center(ds.T, n),
        uw=coarse_grain_linear_interpolation(ds.uw, n + 1),
        vw=coarse_grain_linear_interpolation(ds.vw, n + 1),
        wT=coarse_grain_linear_interpolation(ds.wT, n + 1),
    )


def _any_nonzero(a) -> bool:
    return a is not None and bool(torch.any(torch.as_tensor(a) != 0.0))


def enforce_surface_fluxes(ds: ColumnTimeSeries) -> ColumnTimeSeries:
    """Pin the top face of ``uw``/``wT`` to the prescribed surface fluxes.

    Parity: ``enforce_top_surface_flux!`` (``data_containers.jl:282-294``).
    Refuses diurnal datasets, whose oscillating surface flux this would pin
    to a constant.
    """
    if _any_nonzero(ds.diurnal_amplitude):
        raise ValueError(
            "enforce_surface_fluxes on a diurnal dataset would pin the oscillating "
            "surface flux to a constant; skip it for diurnal sims"
        )
    uw = ds.uw.clone()
    wT = ds.wT.clone()
    uw[..., -1] = torch.broadcast_to(torch.as_tensor(ds.u_top)[..., None], uw.shape[:-1])
    wT[..., -1] = torch.broadcast_to(torch.as_tensor(ds.theta_top)[..., None], wT.shape[:-1])
    return dataclasses.replace(ds, uw=uw, wT=wT)


def stack_datasets(datasets: list[ColumnTimeSeries]) -> ColumnTimeSeries:
    """Stack same-shape simulations on a new leading axis (the suite axis)."""
    first = datasets[0]
    fields = {}
    for f in dataclasses.fields(first):
        values = [getattr(d, f.name) for d in datasets]
        fields[f.name] = None if values[0] is None else torch.stack([torch.as_tensor(v) for v in values], dim=0)
    return ColumnTimeSeries(**fields)


_SCALE_TYPES = {
    "zero_mean_unit_variance": ZeroMeanUnitVarianceScaling,
    "min_max": MinMaxScaling,
}


def fit_wind_mixing_scalings(datasets, kind: str = "zero_mean_unit_variance") -> WindMixingScalings:
    """Fit per-variable scalings over the concatenation of all simulations.

    Parity: ``data_containers.jl:379-394`` (fit on the coarse data of the
    training suite; reuse the result for test data).
    """
    if isinstance(datasets, ColumnTimeSeries):
        datasets = [datasets]
    cls = _SCALE_TYPES[kind]

    def fit(field):
        return cls.fit(torch.cat([getattr(d, field).reshape(-1) for d in datasets]))

    return WindMixingScalings(u=fit("u"), v=fit("v"), T=fit("T"), uw=fit("uw"), vw=fit("vw"), wT=fit("wT"))


def scaled_state_array(ds: ColumnTimeSeries, scalings: WindMixingScalings) -> torch.Tensor:
    """Scaled state ``x = [u; v; T]`` time series, ``(..., Nt, 3 Nz)``."""
    return torch.cat([scalings.u.scale(ds.u), scalings.v.scale(ds.v), scalings.T.scale(ds.T)], dim=-1)


def scaled_flux_arrays(ds: ColumnTimeSeries, scalings: WindMixingScalings):
    """Scaled flux faces ``(uw, vw, wT)``, each ``(..., Nt, Nz + 1)``."""
    return scalings.uw.scale(ds.uw), scalings.vw.scale(ds.vw), scalings.wT.scale(ds.wT)


@dataclasses.dataclass(frozen=True)
class TrainingBatch:
    """Everything one NDE training step consumes, for ``S`` simulations.

    ``x0 (S, 3 Nz)`` scaled initial states; ``targets (S, Nt_sel, 3 Nz)``;
    ``bcs`` with ``(S,)`` fields; ``t (Nt_sel,)`` non-dimensional save times;
    ``tau`` the time scale; ``t0`` optional ``(S,)`` per-row start times
    overriding ``t[0]`` (multiple-shooting batches put every (sim, window)
    pair on the batch axis, so rows start at different absolute times).
    """

    x0: torch.Tensor
    targets: torch.Tensor
    bcs: BoundaryConditions
    t: torch.Tensor
    tau: torch.Tensor
    t0: torch.Tensor | None = None


def training_tensors(ds: ColumnTimeSeries, scalings: WindMixingScalings, tsteps, tau=None,
                     diurnal: bool | None = None) -> TrainingBatch:
    """NDE training tensors from a stacked suite ``(S, Nt, ...)``.

    Parity: ``NDE_training.jl:220-243``: the initial state at ``tsteps[0]``,
    targets at every ``tsteps``, BCs frozen at the window start, time made
    non-dimensional by ``tau`` (the full simulation span by default).
    ``diurnal=True`` fills ``bcs.diurnal_amplitude`` with each sim's
    amplitude (``ds.diurnal_amplitude``, else ``theta_top``); ``None`` infers
    the flag from ``ds.diurnal_amplitude``.
    """
    if diurnal is None:
        diurnal = _any_nonzero(ds.diurnal_amplitude)
    n_frames = ds.t.shape[-1]
    t_arr = np.asarray(tsteps)
    if int(t_arr.max()) >= n_frames or int(t_arr.min()) < 0:
        raise ValueError(
            f"tsteps range [{int(t_arr.min())}, {int(t_arr.max())}] out of range for {n_frames} saved frames"
        )
    idx = torch.as_tensor(t_arr, dtype=torch.long, device=ds.T.device)
    x = scaled_state_array(ds, scalings)
    uw_s, vw_s, wT_s = scaled_flux_arrays(ds, scalings)

    t_row = ds.t[0] if ds.t.dim() > 1 else ds.t
    if tau is None:
        tau = torch.abs(t_row[-1] - t_row[0])

    i0 = int(t_arr[0])
    bot = uw_s[..., i0, 0]
    if diurnal:
        amp = ds.diurnal_amplitude if ds.diurnal_amplitude is not None else ds.theta_top
        amp = torch.broadcast_to(torch.as_tensor(amp, dtype=bot.dtype, device=bot.device), bot.shape)
    else:
        amp = torch.zeros_like(bot)
    bcs = BoundaryConditions(
        uw_bot=uw_s[..., i0, 0], uw_top=uw_s[..., i0, -1],
        vw_bot=vw_s[..., i0, 0], vw_top=vw_s[..., i0, -1],
        wT_bot=wT_s[..., i0, 0], wT_top=wT_s[..., i0, -1],
        diurnal_amplitude=amp,
    )
    return TrainingBatch(
        x0=x[..., i0, :],
        targets=x.index_select(-2, idx),
        bcs=bcs,
        t=t_row.index_select(0, idx) / tau,
        tau=tau,
    )


def multiple_shooting_tensors(ds: ColumnTimeSeries, scalings: WindMixingScalings, tsteps, n_windows: int,
                              tau=None, diurnal: bool | None = None) -> TrainingBatch:
    """Window-parallel (multiple-shooting) training tensors.

    Splits the save ladder ``tsteps`` into ``n_windows`` segments and puts
    every ``(sim, window)`` pair on the batch axis, sims-major (row
    ``s * n_windows + k``). Each window starts from the truth state at its
    first frame, and adjacent windows share their boundary frame. BC faces
    are frozen at each window's start; ``t0`` holds each row's start time
    ``t_row[start_k] / tau``, so a diurnal top BC keeps its phase in every
    window. ``tsteps`` must be uniformly strided, and its interval count
    divisible by ``n_windows``.
    """
    if diurnal is None:
        diurnal = _any_nonzero(ds.diurnal_amplitude)
    t_arr = np.asarray(tsteps)
    n_frames = ds.t.shape[-1]
    if int(t_arr.max()) >= n_frames or int(t_arr.min()) < 0:
        raise ValueError(
            f"tsteps range [{int(t_arr.min())}, {int(t_arr.max())}] out of range for {n_frames} saved frames"
        )
    strides = np.diff(t_arr)
    if strides.size == 0 or not np.all(strides == strides[0]):
        raise ValueError(f"multiple shooting needs a uniformly strided tstep ladder (got strides {strides[:4]}...)")
    n_intervals = len(t_arr) - 1
    if n_windows < 1 or n_intervals % n_windows:
        raise ValueError(
            f"n_windows={n_windows} must divide the {n_intervals} save intervals of the tstep ladder"
        )
    n_int = n_intervals // n_windows  # save intervals per window
    K, W = n_windows, n_int + 1
    # (K, W) frame indices; window k covers [k n_int, (k + 1) n_int] inclusive.
    idx = t_arr[np.arange(K)[:, None] * n_int + np.arange(W)[None, :]]
    device = ds.T.device

    x = scaled_state_array(ds, scalings)
    if x.dim() == 2:  # a single sim: add the suite axis
        x = x[None]
        ds = dataclasses.replace(ds, **{
            f.name: torch.as_tensor(getattr(ds, f.name))[None]
            for f in dataclasses.fields(ds) if getattr(ds, f.name) is not None
        })
    S = x.shape[0]
    uw_s, vw_s, wT_s = scaled_flux_arrays(ds, scalings)

    t_row = ds.t.reshape(-1, ds.t.shape[-1])[0]
    if tau is None:
        tau = torch.abs(t_row[-1] - t_row[0])

    starts = torch.as_tensor(idx[:, 0], dtype=torch.long, device=device)

    def merge(a):  # (S, K, ...) -> (S K, ...), sims-major
        return a.reshape((S * K,) + tuple(a.shape[2:]))

    def at_starts(flux_faces, face):
        return merge(flux_faces[..., face].index_select(-1, starts))

    if diurnal:
        amp = ds.diurnal_amplitude if ds.diurnal_amplitude is not None else ds.theta_top
        amp = torch.broadcast_to(torch.as_tensor(amp, dtype=x.dtype, device=device), (S,))
        amp = merge(torch.broadcast_to(amp[:, None], (S, K)))
    else:
        amp = torch.zeros((S * K,), dtype=x.dtype, device=device)
    bcs = BoundaryConditions(
        uw_bot=at_starts(uw_s, 0), uw_top=at_starts(uw_s, -1),
        vw_bot=at_starts(vw_s, 0), vw_top=at_starts(vw_s, -1),
        wT_bot=at_starts(wT_s, 0), wT_top=at_starts(wT_s, -1),
        diurnal_amplitude=amp,
    )
    frames = torch.as_tensor(idx.ravel(), dtype=torch.long, device=device)
    targets = merge(x.index_select(-2, frames).reshape(S, K, W, x.shape[-1]))
    t0 = t_row.index_select(0, starts) / tau
    return TrainingBatch(
        x0=targets[:, 0, :],
        targets=targets,
        bcs=bcs,
        t=t_row.index_select(0, torch.as_tensor(idx[0], dtype=torch.long, device=device)) / tau,
        tau=tau,
        t0=merge(torch.broadcast_to(t0[None, :], (S, K))),
    )


def direct_regression_pairs(ds: ColumnTimeSeries, scalings: WindMixingScalings, flux: str = "wT"):
    """(predictor, target) pairs for direct flux regression.

    Predictors are scaled states ``(S * Nt, 3 Nz)``; targets the scaled flux
    faces ``(S * Nt, Nz + 1)``. Parity: the ``training_data`` pairs in
    ``FluxData`` (``data_containers.jl:410-414``).
    """
    if flux not in ("uw", "vw", "wT"):
        raise KeyError(f"flux must be one of uw/vw/wT, got {flux!r}")
    x = scaled_state_array(ds, scalings)
    y = getattr(scalings, flux).scale(getattr(ds, flux))
    return x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
