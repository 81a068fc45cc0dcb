"""LESbrary ``.jld2`` readers and writers (JLD2 files are HDF5, read and written by ``data/hdf5.py``).

Port of ``climateparameterizations_jl_tpu/data/lesbrary.py``. Two on-disk
layouts, as the reference's two loaders read them:

- **wind-mixing statistics files** (``wind_mixing/src/lesbrary_data.jl:56-190``):
  ``timeseries/<var>/<iteration>`` profiles in Julia's ``(1, 1, N)`` axis
  order, unpadded, a halo-padded grid (``Nz = len(grid/zC) - 6``),
  ``buoyancy[/model]/equation_of_state/{α,β}`` with gravity, ``coriolis/f``
  and ``parameters/*``; the surface temperature flux is
  ``buoyancy_flux / (α g)`` (``lesbrary_data.jl:164-165``).
- **free-convection FieldDataset files** (``free_convection/src/data.jl:32-71``,
  ``instantaneous_statistics_with_halos.jld2``): ``T`` and ``wT`` padded by
  ``Hz`` halo cells, ``serialized/`` subgroups beside the iterations, and
  the surface flux at ``parameters/temperature_flux``.

:func:`read_les_profiles` returns a time-major :class:`ColumnTimeSeries` of
CPU tensors, ready for ``coarsen_dataset`` and scaling. The files go
through the port's own HDF5 reader and writer (numpy only), so they are
read and written on every host the port runs on, the card's included.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data import hdf5
from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _iterations(group) -> list[str]:
    """Numeric iteration keys in time order.

    FieldTimeSeries groups also hold a ``serialized/`` subgroup: skip every
    key that is not an iteration number, and sort numerically (``"9000"``
    comes before ``"10800"``).
    """
    return sorted((k for k in group.keys() if k.lstrip("-").isdigit()), key=int)


def _strip_halo(arr: np.ndarray, Nz: int, halo: int) -> np.ndarray:
    """Strip halos from one profile by its length: statistics files store
    ``Nz`` / ``Nz + 1`` entries, ``*_with_halos`` files pad both by ``halo``."""
    n = arr.size
    if n in (Nz, Nz + 1):
        return arr
    if halo > 0 and n in (Nz + 2 * halo, Nz + 1 + 2 * halo):
        return arr[halo:-halo]
    raise ValueError(f"profile of length {n} does not match Nz={Nz} (halo {halo})")


def _profile_series(f, name: str, Nz: int, halo: int) -> np.ndarray:
    """Stack ``timeseries/<name>/<iter>`` into ``(Nt, Nz[+1])``, halos stripped."""
    g = f["timeseries"][name]
    # Julia writes (1, 1, N); HDF5 readers see the dims reversed as (N, 1, 1).
    return np.stack([_strip_halo(np.asarray(g[it][()]).reshape(-1), Nz, halo) for it in _iterations(g)], axis=0)


_MISSING = object()


def _first(f, paths, default=_MISSING):
    for p in paths:
        if p in f:
            return f[p][()]
    if default is not _MISSING:
        return default
    raise KeyError(f"none of {paths} found in file")


def read_les_profiles(path: str, halo: int = 3, dtype=np.float32) -> ColumnTimeSeries:
    """Read a LESbrary ``.jld2`` file of either layout into a :class:`ColumnTimeSeries`.

    ``Nz = len(grid/zC) - 2 halo`` (``lesbrary_data.jl:65``), with the halo
    width from ``grid/Hz`` where the file stores it; profiles are stripped
    per variable by their length. ``dtype`` is a numpy dtype; the tensors
    are on the CPU.
    """
    with hdf5.File(path, "r") as f:
        if "grid/Hz" in f:
            halo = int(f["grid/Hz"][()])
        zc = np.asarray(f["grid/zC"][()]).reshape(-1) if "grid/zC" in f else None

        tgroup = f["timeseries"]["t"]
        t = np.asarray([np.asarray(tgroup[it][()]) for it in _iterations(tgroup)], dtype)

        # Probe the first T frame against the grid to fix Nz for this file.
        tg = f["timeseries"]["T"]
        n_probe = int(np.prod(tg[_iterations(tg)[0]].shape))
        if zc is None:
            Nz = n_probe
        elif n_probe == zc.size - 2 * halo:  # statistics layout: profiles unpadded
            Nz = n_probe
        elif n_probe == zc.size:  # *_with_halos layout: both padded
            Nz = zc.size - 2 * halo
        elif n_probe == zc.size + 2 * halo:  # legacy round-trip files (grid unpadded)
            Nz = zc.size
        else:
            raise ValueError(f"cannot reconcile T profile length {n_probe} with grid zC length {zc.size} (halo {halo})")

        series = f["timeseries"]
        T = _profile_series(f, "T", Nz, halo).astype(dtype)
        u = _profile_series(f, "u", Nz, halo).astype(dtype) if "u" in series else np.zeros_like(T)
        v = _profile_series(f, "v", Nz, halo).astype(dtype) if "v" in series else np.zeros_like(T)
        zeros_f = np.zeros((T.shape[0], Nz + 1), dtype)
        wT = _profile_series(f, "wT", Nz, halo).astype(dtype) if "wT" in series else zeros_f
        wu = _profile_series(f, "wu", Nz, halo).astype(dtype) if "wu" in series else zeros_f
        wv = _profile_series(f, "wv", Nz, halo).astype(dtype) if "wv" in series else zeros_f

        # Free-convection files carry only T, wT and a surface flux: every
        # wind-mixing key has a physical default, so both layouts read.
        alpha = _first(f, ["buoyancy/model/equation_of_state/α", "buoyancy/equation_of_state/α"], 2e-4)
        beta = _first(f, ["buoyancy/model/equation_of_state/β", "buoyancy/equation_of_state/β"], 0.0)
        g = _first(f, ["buoyancy/model/gravitational_acceleration", "buoyancy/gravitational_acceleration"], 9.80665)
        f_cor = _first(f, ["coriolis/f"], 0.0)
        L = _first(f, ["grid/Lz"])

        # A temperature flux where the file records one (add_surface_fluxes.jl:2),
        # else a buoyancy flux divided by alpha g (lesbrary_data.jl:164-165).
        theta_top = _first(
            f, ["parameters/temperature_flux", "parameters/surface_temperature_flux", "parameters/Qθ"], None)
        if theta_top is None:
            buoyancy_flux = _first(
                f, ["parameters/buoyancy_flux", "parameters/surface_buoyancy_flux", "parameters/Qb"], None)
            if buoyancy_flux is not None:
                theta_top = buoyancy_flux / alpha / g
            else:
                theta_top = float(wT[0, -1]) if wT.size else 0.0
        u_top = _first(f, ["parameters/boundary_condition_u_top", "parameters/momentum_flux", "parameters/Qu"], 0.0)
        theta_bottom = _first(
            f,
            ["parameters/boundary_condition_θ_bottom", "parameters/boundary_condition_theta_bottom",
             "parameters/temperature_gradient", "parameters/dθdz_deep"],
            0.0,
        )

    a = lambda x: torch.from_numpy(np.array(x, dtype))  # noqa: E731
    return ColumnTimeSeries(
        u=a(u), v=a(v), T=a(T), uw=a(wu), vw=a(wv), wT=a(wT), t=a(t),
        H=a(L), f=a(f_cor), g=a(g), alpha=a(alpha), beta=a(beta),
        u_top=a(u_top), theta_top=a(theta_top), theta_bottom=a(theta_bottom),
    )


def _halo_grid(H: float, Nz: int, halo: int):
    """Face and center coordinates with ``halo`` ghost cells each side, as
    Oceananigans stores ``grid/zC`` / ``grid/zF``."""
    dz = H / Nz
    zf = -H + dz * np.arange(-halo, Nz + halo + 1)  # Nz + 1 + 2 halo faces
    zc = 0.5 * (zf[:-1] + zf[1:])  # Nz + 2 halo centers
    return zc, zf


def write_les_profiles(path: str, ds: ColumnTimeSeries, halo: int = 3, iteration_stride: int = 1):
    """Write a :class:`ColumnTimeSeries` in the LESbrary statistics layout.

    The layout ``ReadJLD2_LESbraryData`` reads (``lesbrary_data.jl:56-190``):
    unpadded ``timeseries/<var>/<iteration>`` profiles in Julia's ``(1, 1,
    N)`` order, ``timeseries/t/<iteration>`` scalars keyed by iteration
    number (``i * iteration_stride``), a halo-padded ``grid/{zC, zF}`` with
    ``grid/Lz``, ``buoyancy/model/...``, ``coriolis/f`` and four
    ``parameters/*`` BC entries, the surface flux as a buoyancy flux.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    t = _numpy(ds.t).astype(np.float64)
    series = {"t": t, "u": _numpy(ds.u), "v": _numpy(ds.v), "T": _numpy(ds.T),
              "wu": _numpy(ds.uw), "wv": _numpy(ds.vw), "wT": _numpy(ds.wT)}
    with hdf5.File(path, "w") as f:
        for name, arr in series.items():
            g = f.create_group(f"timeseries/{name}")
            for i in range(t.shape[0]):
                key = str(i * iteration_stride)
                g[key] = arr[i] if name == "t" else arr[i].reshape(-1, 1, 1)
        H = float(ds.H)
        zc, zf = _halo_grid(H, ds.T.shape[-1], halo)
        f["grid/Lz"] = H
        f["grid/zC"] = zc
        f["grid/zF"] = zf
        f["buoyancy/model/equation_of_state/α"] = float(ds.alpha)
        f["buoyancy/model/equation_of_state/β"] = float(ds.beta)
        f["buoyancy/model/gravitational_acceleration"] = float(ds.g)
        f["coriolis/f"] = float(ds.f)
        f["parameters/buoyancy_flux"] = float(ds.theta_top) * float(ds.alpha) * float(ds.g)
        f["parameters/boundary_condition_u_top"] = float(ds.u_top)
        f["parameters/boundary_condition_u_bottom"] = 0.0
        f["parameters/boundary_condition_θ_bottom"] = float(ds.theta_bottom)
    return path


def write_fc_fieldset(path: str, ds: ColumnTimeSeries, halo: int = 3, iteration_stride: int = 1):
    """Write the free-convection ``instantaneous_statistics_with_halos.jld2`` layout.

    (``free_convection/src/data.jl:32-71``): ``T`` and ``wT`` padded by
    ``halo`` zeros each side, a ``serialized/`` subgroup in each variable's
    group, ``grid/{Nz, Hz, Lz, zC, zF}``, and the surface flux at
    ``parameters/temperature_flux`` (``add_surface_fluxes.jl:2``).
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    t = _numpy(ds.t).astype(np.float64)
    Nz = ds.T.shape[-1]

    def pad(row):
        return np.concatenate([np.zeros(halo, row.dtype), row, np.zeros(halo, row.dtype)])

    with hdf5.File(path, "w") as f:
        for name in ("t", "T", "wT"):
            g = f.create_group(f"timeseries/{name}")
            if name != "t":
                s = g.create_group("serialized")
                s["location"] = np.bytes_(b"(Center, Center, " + (b"Face)" if name == "wT" else b"Center)"))
            arr = t if name == "t" else _numpy(getattr(ds, name))
            for i in range(t.shape[0]):
                key = str(i * iteration_stride)
                g[key] = arr[i] if name == "t" else pad(arr[i]).reshape(-1, 1, 1)
        H = float(ds.H)
        zc, zf = _halo_grid(H, Nz, halo)
        f["grid/Nz"] = Nz
        f["grid/Hz"] = halo
        f["grid/Lz"] = H
        f["grid/zC"] = zc
        f["grid/zF"] = zf
        f["parameters/temperature_flux"] = float(ds.theta_top)
        f["parameters/buoyancy_flux"] = float(ds.theta_top) * float(ds.alpha) * float(ds.g)
        f["parameters/boundary_condition_θ_bottom"] = float(ds.theta_bottom)
    return path
