"""The wind-mixing simulation catalog, the free-convection ids, and the loader of a catalog name.

Port of ``climateparameterizations_jl_tpu/data/registry.py`` (reference
``wind_mixing/src/data_containers.jl:1-128``). The catalog names encode the
surface momentum flux ``Qu``, buoyancy flux ``Qb``, Coriolis ``f`` and the
suite: :func:`simulation_parameters` parses them, and
:func:`lesbrary_relative_path` rebuilds the reference's ``.jld2`` paths.
:func:`load_simulation` reads ``<data_dir>/<lesbrary_relative_path(name)>``
where that file exists (``data/lesbrary.py``, which needs h5py) and
otherwise generates the name's synthetic stand-in (``data/synthetic.py``);
``source="les3d"`` generates it with the 3-D LES (``data/les.py``). The JAX
package's downloader (``fetch_free_convection``) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import re

# The "2DaySuite" of 6 named 48-hour simulations (data_containers.jl:2-7):
# name -> (Qu, Qb, f, filename tag).
TWO_DAY_SUITE = {
    "free_convection": (0.0, 1.2e-7, 1e-4, "free_convection"),
    "strong_wind": (1.0e-3, 0.0, 1e-4, "strong_wind"),
    "strong_wind_no_coriolis": (2.0e-4, 0.0, 0.0, "strong_wind_no_rotation"),
    "weak_wind_strong_cooling": (3.0e-4, 1.0e-7, 1e-4, "weak_wind_strong_cooling"),
    "strong_wind_weak_cooling": (8.0e-4, 3.0e-8, 1e-4, "strong_wind_weak_cooling"),
    "strong_wind_weak_heating": (1.0e-3, -4.0e-8, 1e-4, "strong_wind_weak_heating"),
}

# 8-day suite axes (data_containers.jl:8-127). Names parse as:
#   "-1e-3"                        pure wind (old),      suite wind_mixing_8days_2
#   "wind_-5e-4_new"               pure wind (new),      suite WM_8days_new
#   "cooling_3e-8"                 pure cooling (old),   suite free_convection_8days
#   "cooling_3e-8_new"             pure cooling (new),   suite FC_8days
#   "heating_-3e-8"                pure heating,         suite free_convection_8days
#   "wind_-5e-4_cooling_3e-8[_new]"  wind+cooling,       suite WC_8days[_new]
#   "wind_-5e-4_heating_-3e-8[_new]" wind+heating,       suite WH_8days[_new]
#   "wind_-5e-4_diurnal_5e-8"      wind+diurnal Qb,      suite diurnal_8days
_WIND_GRID_OLD = ["-1e-3", "-9e-4", "-8e-4", "-7e-4", "-6e-4", "-5e-4", "-4e-4", "-3e-4", "-2e-4"]
_WIND_GRID_NEW = ["-5.5e-4", "-5e-4", "-4.5e-4", "-4e-4", "-3.5e-4", "-3e-4", "-2.5e-4", "-2e-4"]
_COOL_GRID_OLD = ["6e-8", "5e-8", "4e-8", "3e-8", "2e-8", "1e-8"]
_COOL_GRID_NEW = ["5e-8", "4.5e-8", "4e-8", "3.5e-8", "3e-8", "2.5e-8", "2e-8", "1.5e-8", "1e-8"]


@dataclasses.dataclass(frozen=True)
class SimulationSpec:
    name: str
    Qu: float  # surface kinematic momentum flux magnitude [m^2/s^2]
    Qb: float  # surface buoyancy flux [m^2/s^3]; negative = heating
    f: float  # Coriolis parameter [1/s]
    diurnal: bool
    suite: str  # filename suite tag


_NUM = r"-?\d+(?:\.\d+)?e[+-]?\d+"


def simulation_parameters(name: str) -> SimulationSpec:
    """Parse a catalog name into its physical parameters + suite tag."""
    if name in TWO_DAY_SUITE:
        Qu, Qb, f, tag = TWO_DAY_SUITE[name]
        return SimulationSpec(name, Qu, Qb, f, False, "2DaySuite:" + tag)

    f = 1e-4
    m = re.fullmatch(rf"({_NUM})", name)
    if m:  # "-1e-3" pure wind, old suite
        return SimulationSpec(name, abs(float(m.group(1))), 0.0, f, False, "wind_mixing_8days_2")
    m = re.fullmatch(rf"cooling_({_NUM})(_new)?", name)
    if m:
        suite = "FC_8days" if m.group(2) else "free_convection_8days"
        return SimulationSpec(name, 0.0, float(m.group(1)), f, False, suite)
    m = re.fullmatch(rf"heating_({_NUM})", name)
    if m:
        return SimulationSpec(name, 0.0, float(m.group(1)), f, False, "free_convection_8days")
    m = re.fullmatch(rf"wind_({_NUM})_new", name)
    if m:
        return SimulationSpec(name, abs(float(m.group(1))), 0.0, f, False, "WM_8days_new")
    m = re.fullmatch(rf"wind_({_NUM})_cooling_({_NUM})(_new)?", name)
    if m:
        suite = "WC_8days_new" if m.group(3) else "WC_8days"
        return SimulationSpec(name, abs(float(m.group(1))), float(m.group(2)), f, False, suite)
    m = re.fullmatch(rf"wind_({_NUM})_heating_({_NUM})(_new)?", name)
    if m:
        suite = "WH_8days_new" if m.group(3) else "WH_8days"
        return SimulationSpec(name, abs(float(m.group(1))), float(m.group(2)), f, False, suite)
    m = re.fullmatch(rf"wind_({_NUM})_diurnal_({_NUM})", name)
    if m:
        return SimulationSpec(name, abs(float(m.group(1))), float(m.group(2)), f, True, "diurnal_8days")
    raise KeyError(f"unknown simulation name: {name!r}")


def _fmt(x: float) -> str:
    """Format like the reference filenames: 5e-4 -> '5.0e-04', 0 -> '0.0e+00'."""
    s = f"{x:.1e}"
    return s


def lesbrary_relative_path(name: str) -> str:
    """Rebuild the reference's exact relative ``.jld2`` path for a catalog name."""
    spec = simulation_parameters(name)
    if spec.suite.startswith("2DaySuite:"):
        tag = spec.suite.split(":", 1)[1]
        return (
            f"2DaySuite/three_layer_constant_fluxes_hr48_Qu{_fmt(spec.Qu)}_Qb{_fmt(spec.Qb)}"
            f"_f{_fmt(spec.f)}_Nh256_Nz128_{tag}_statistics.jld2"
        )
    return (
        f"Data/three_layer_constant_fluxes_linear_hr192_Qu{_fmt(spec.Qu)}_Qb{_fmt(spec.Qb)}"
        f"_f{_fmt(spec.f)}_Nh256_Nz128_{spec.suite}_statistics.jld2"
    )


def _build_catalog() -> tuple:
    """All canonical 8-day names, reconstructed from the parameter grids."""
    names = list(TWO_DAY_SUITE)
    names += _WIND_GRID_OLD
    names += [f"cooling_{c}" for c in _COOL_GRID_OLD] + ["heating_-3e-8"]
    names += [f"cooling_{c}_new" for c in _COOL_GRID_NEW]
    names += [f"wind_{w}_new" for w in _WIND_GRID_NEW]
    for w in ["-1e-3", "-5e-4", "-2e-4"]:
        for c in ["1e-8", "2e-8", "3e-8", "4e-8", "5e-8"]:
            names.append(f"wind_{w}_cooling_{c}")
            names.append(f"wind_{w}_heating_-{c}")
    for w in ["-5e-4", "-3.5e-4", "-2e-4"]:
        for c in ["1e-8", "2e-8", "3e-8"]:
            names.append(f"wind_{w}_cooling_{c}_new")
            names.append(f"wind_{w}_heating_-{c}_new")
        for c in ["1e-8", "2e-8", "3e-8", "3.5e-8", "5e-8"]:
            names.append(f"wind_{w}_diurnal_{c}")
    for w in ["-4.5e-4", "-2.5e-4"]:
        for c in ["1.5e-8", "2.5e-8"]:
            names.append(f"wind_{w}_cooling_{c}")
            names.append(f"wind_{w}_heating_-{c}")
    # interpolation/extrapolation study points
    names += [
        "wind_-4.5e-4_diurnal_4e-8", "wind_-4.5e-4_diurnal_2e-8",
        "wind_-3e-4_diurnal_4e-8", "wind_-3e-4_diurnal_2e-8",
        "wind_-2e-4_diurnal_4e-8",
        "wind_-5.5e-4_diurnal_5.5e-8", "wind_-1.5e-4_diurnal_5.5e-8",
        "wind_-5.5e-4_new", "wind_-5.5e-4_heating_-3.5e-8", "wind_-1.5e-4_heating_-3.5e-8",
        "wind_-5.5e-4_cooling_3.5e-8", "wind_-1.5e-4_cooling_3.5e-8",
    ]
    # de-dup, preserve order
    seen, out = set(), []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return tuple(out)


WIND_MIXING_CATALOG = _build_catalog()
# The free-convection LESbrary runs (free_convection/src/data.jl:3-12).
FREE_CONVECTION_IDS = tuple(range(1, 10))


def require_ported_source(source: str = "auto", allowed=("auto", "les3d")) -> None:
    """Raise ``ValueError`` for a source not in ``allowed``."""
    if source not in allowed:
        raise ValueError(f"unknown source {source!r}")


def lesbrary_file(name: str, data_dir: str | None) -> str | None:
    """``<data_dir>/<lesbrary_relative_path(name)>`` where that file exists, else ``None``."""
    if data_dir is None:
        return None
    path = os.path.join(data_dir, lesbrary_relative_path(name))
    return path if os.path.exists(path) else None


def signed_momentum_flux(spec: SimulationSpec) -> float:
    """The generator's signed kinematic momentum flux (negative = eastward wind)."""
    return -abs(spec.Qu) if spec.Qu != 0.0 else 0.0


def load_simulation(name: str, data_dir: str | None = None, Nz_les: int = 128, n_save: int = 288,
                    dt_save: float = 600.0, source: str = "auto", device=None, **synthetic_kwargs):
    """One catalog simulation as a :class:`~..data.containers.ColumnTimeSeries` of CPU tensors.

    ``source="auto"``: the reference's ``.jld2`` file from ``data_dir`` when
    it exists (HDF5 reader), else the synthetic column stand-in of the name's
    forcing, generated on the CPU (``data/synthetic.py``). A file does not
    record the diurnal flag (the reference encodes it in the name): it is
    stamped from the catalog, ``diurnal_amplitude = theta_top`` for diurnal
    names and 0 otherwise.

    ``source="les3d"`` generates the data with the 3-D LES (``data/les.py``)
    under the name's signed fluxes, Coriolis and diurnal flag: an
    ``Nx = Ny = min(Nz_les, 64)`` box of ``Nz_les`` levels, forward Euler at
    :func:`~..data.les.stable_dt`, ``round(dt_save / dt)`` steps per save,
    noise from a generator seeded with 0. The LES runs on ``device`` (the
    card unless the caller passes the CPU); the profiles come back on the CPU.
    """
    require_ported_source(source)
    spec = simulation_parameters(name)
    if source == "les3d":
        from climateparameterizations_jl_tpu_torch.data.les import LESConfig, run_les, stable_dt

        n_h = min(Nz_les, 64)
        config = LESConfig.default(Nx=n_h, Ny=n_h, Nz=Nz_les, Qu=signed_momentum_flux(spec), Qb=spec.Qb, f=spec.f,
                                   diurnal=spec.diurnal, device=device)
        dt = stable_dt(config)
        return run_les(config, dt=dt, n_save=n_save, save_every=max(1, int(round(dt_save / dt)))).to("cpu")
    path = lesbrary_file(name, data_dir)
    if path is not None:
        import torch

        from climateparameterizations_jl_tpu_torch.data.lesbrary import read_les_profiles

        ds = read_les_profiles(path)
        amp = ds.theta_top if spec.diurnal else torch.zeros_like(ds.theta_top)
        return dataclasses.replace(ds, diurnal_amplitude=amp)

    from climateparameterizations_jl_tpu_torch.data.synthetic import synthetic_wind_mixing_les

    return synthetic_wind_mixing_les(
        Qu=signed_momentum_flux(spec), Qb=spec.Qb, f=spec.f, diurnal=spec.diurnal,
        Nz=Nz_les, n_save=n_save, dt_save=dt_save, **synthetic_kwargs,
    )
