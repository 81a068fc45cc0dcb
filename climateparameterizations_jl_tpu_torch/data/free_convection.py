"""Free-convection dataset helpers: the 9 LESbrary simulations.

Port of ``climateparameterizations_jl_tpu/data/free_convection.py``
(reference ``free_convection/src/data.jl``, ``validate_simulation_ids`` and
``load_data``, and ``free_convection/src/training_data.jl``). A simulation
id reads ``<data_dir>/free_convection_<id>/instantaneous_statistics_with_halos.jld2``
where that file exists (the reference's DataDeps layout, read by the port's
own HDF5 reader on every host), and
otherwise generates the id's synthetic stand-in on the CPU; ``source="les3d"``
generates it with the 3-D LES (``data/les.py``), optionally through a cache
directory that either package's files can fill. The files are downloaded
by ``data/registry.py::fetch_free_convection`` (the ``fetch`` command).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries, coarsen_dataset
from climateparameterizations_jl_tpu_torch.data.registry import FREE_CONVECTION_IDS, require_ported_source

logger = logging.getLogger(__name__)

# Surface buoyancy fluxes and initial stratifications spanning the LESbrary
# free-convection suite (9 numbered simulations, data.jl:3-12): the
# synthetic stand-ins' forcing when the files are absent.
_SYNTHETIC_PARAMS = {
    1: (1e-8, 2e-3), 2: (2.5e-8, 2e-3), 3: (5e-8, 2e-3),
    4: (7.5e-8, 2e-3), 5: (1e-7, 2e-3), 6: (2.5e-8, 1e-3),
    7: (5e-8, 1e-3), 8: (7.5e-8, 1e-3), 9: (1e-7, 1e-3),
}
SOURCES = ("auto", "synthetic", "les3d")


def validate_simulation_ids(ids_train, ids_test) -> bool:
    """Warn on overlapping, unused or unknown simulation ids (``data.jl:14-30``)."""
    train, test = set(ids_train), set(ids_test)
    ok = True
    overlap = train & test
    if overlap:
        logger.warning("simulations %s appear in both the training and test sets", sorted(overlap))
        ok = False
    unused = set(FREE_CONVECTION_IDS) - train - test
    if unused:
        logger.warning("simulations %s are not used for training or testing", sorted(unused))
        ok = False
    bad = (train | test) - set(FREE_CONVECTION_IDS)
    if bad:
        logger.warning("unknown simulation ids %s (valid: 1..9)", sorted(bad))
        ok = False
    return ok


def save_column_npz(path: str, ds: ColumnTimeSeries) -> None:
    """Dump a :class:`ColumnTimeSeries` to npz atomically (a temporary file, then a rename).

    Unset optional fields (``diurnal_amplitude=None``) are skipped;
    :func:`load_column_npz` restores only the keys present.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            arrays = {
                f_.name: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for f_ in dataclasses.fields(ds)
                if (v := getattr(ds, f_.name)) is not None
            }
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_column_npz(path: str) -> ColumnTimeSeries:
    """A :class:`ColumnTimeSeries` of CPU tensors from :func:`save_column_npz`'s file (either package's)."""
    with np.load(path) as z:
        names = {f.name for f in dataclasses.fields(ColumnTimeSeries)}
        return ColumnTimeSeries(**{k: torch.from_numpy(np.array(z[k])) for k in z.files if k in names})


def fieldset_path(data_dir: str | None, simulation_id: int) -> str | None:
    """The id's ``instantaneous_statistics_with_halos.jld2`` under ``data_dir`` where it exists, else ``None``."""
    if data_dir is None:
        return None
    path = os.path.join(data_dir, f"free_convection_{simulation_id}", "instantaneous_statistics_with_halos.jld2")
    return path if os.path.exists(path) else None


def _check_id(simulation_id: int):
    if simulation_id not in FREE_CONVECTION_IDS:
        raise KeyError(f"free-convection simulation id must be in 1..9, got {simulation_id}")


def load_free_convection_simulation(simulation_id: int, data_dir: str | None = None, Nz: int = 32,
                                    Nz_les: int = 128, n_save: int = 96, dt_save: float = 600.0,
                                    source: str = "auto", les_cache_dir: str | None = None,
                                    device=None) -> ColumnTimeSeries:
    """One free-convection simulation coarse-grained to ``Nz`` levels, as CPU tensors.

    ``source`` ``"auto"`` or ``"synthetic"`` (the JAX package's spelling;
    both read the id's file under ``data_dir`` where it exists, as the JAX
    loader does) falls back to the id's synthetic stand-in at ``Nz_les``
    levels and ``n_save`` saves. ``"les3d"`` runs the 3-D LES on ``device``
    (the card unless the caller passes the CPU; see :func:`les3d_simulation`),
    through ``les_cache_dir`` where given.
    """
    return load_free_convection_suite([simulation_id], data_dir, Nz, Nz_les, n_save, dt_save, source,
                                      les_cache_dir, device)[0]


def les3d_cache_path(les_cache_dir: str, simulation_id: int, Nz_les: int, n_save: int, dt_save: float) -> str:
    """The JAX package's cache file of an ``les3d`` run: one name and npz layout for both packages."""
    return os.path.join(les_cache_dir, f"les3d_sim{simulation_id}_N{Nz_les}_n{n_save}_dt{dt_save:g}.npz")


def les3d_simulation(simulation_id: int, Nz_les: int = 128, n_save: int = 96, dt_save: float = 600.0,
                     les_cache_dir: str | None = None, device=None) -> ColumnTimeSeries:
    """The id's free-convection run of the 3-D LES at ``Nz_les`` levels, before coarse-graining, as CPU tensors.

    The JAX package's ``source="les3d"``: the id's surface buoyancy flux
    (``Qu = 0``) and its stratification as the initial and bottom gradient,
    an ``Nx = Ny = min(Nz_les, 64)`` box, RK3 at ``stable_dt(cfl=0.6)``,
    ``round(dt_save / dt)`` steps per save, the noise from a generator seeded
    with the id (the port's generator: the fields are not the JAX
    package's). ``les_cache_dir`` keeps the profiles under
    :func:`les3d_cache_path`: a file there (written by either package) is
    read instead of running the LES, an unreadable one is regenerated with a
    warning.
    """
    from climateparameterizations_jl_tpu_torch.data.les import LESConfig, run_les, stable_dt

    _check_id(simulation_id)
    cache_path = None
    if les_cache_dir is not None:
        cache_path = les3d_cache_path(les_cache_dir, simulation_id, Nz_les, n_save, dt_save)
        if os.path.exists(cache_path):
            try:
                return load_column_npz(cache_path)
            except Exception as e:  # a corrupt or stale-schema cache: regenerate
                logger.warning("LES cache %s unreadable (%s); regenerating", cache_path, e)
    Qb, strat = _SYNTHETIC_PARAMS[simulation_id]
    n_h = min(Nz_les, 64)
    config = LESConfig.default(Nx=n_h, Ny=n_h, Nz=Nz_les, Qu=0.0, Qb=Qb, dTdz=strat, device=device)
    dt = stable_dt(config, cfl=0.6)
    ds = run_les(config, dt=dt, n_save=n_save, save_every=max(1, int(round(dt_save / dt))),
                 generator=torch.Generator().manual_seed(simulation_id), method="rk3").to("cpu")
    if cache_path is not None:
        save_column_npz(cache_path, ds)
    return ds


def load_free_convection_suite(simulation_ids, data_dir: str | None = None, Nz: int = 32, Nz_les: int = 128,
                               n_save: int = 96, dt_save: float = 600.0, source: str = "auto",
                               les_cache_dir: str | None = None, device=None) -> list:
    """:func:`load_free_convection_simulation` for each id, in order.

    Ids read from files are read one by one; the synthetic stand-ins of the
    others are generated in one batched solve, whose per-id result is the
    single-id generator's (``data/synthetic.py``). With ``source="les3d"``
    each id runs its own LES (:func:`les3d_simulation`) on ``device``.
    """
    require_ported_source(source, allowed=SOURCES)
    for i in simulation_ids:
        _check_id(i)
    if source == "les3d":
        return [coarsen_dataset(les3d_simulation(i, Nz_les, n_save, dt_save, les_cache_dir, device), Nz)
                for i in simulation_ids]
    out = [None] * len(simulation_ids)
    synthetic = []
    for k, i in enumerate(simulation_ids):
        path = fieldset_path(data_dir, i)
        if path is None:
            synthetic.append(k)
            continue
        from climateparameterizations_jl_tpu_torch.data.lesbrary import read_les_profiles

        out[k] = coarsen_dataset(read_les_profiles(path), Nz)
    if synthetic:
        from climateparameterizations_jl_tpu_torch.data.synthetic import _synthetic_free_convection_les_batch

        params = [_SYNTHETIC_PARAMS[simulation_ids[k]] for k in synthetic]
        generated = _synthetic_free_convection_les_batch([p[0] for p in params], [p[1] for p in params], Nz=Nz_les,
                                                         n_save=n_save, dt_save=dt_save)
        for k, ds in zip(synthetic, generated):
            out[k] = coarsen_dataset(ds, Nz)
    return out


def load_data(ids_train, ids_test, Nz: int = 32, data_dir: str | None = None, **kwargs):
    """Load and partition the suite (``load_data``, ``data.jl:32-71``): ``(train, test)`` dicts ``{id: ds}``."""
    validate_simulation_ids(ids_train, ids_test)
    load = lambda i: load_free_convection_simulation(i, data_dir, Nz, **kwargs)  # noqa: E731
    return {i: load(i) for i in ids_train}, {i: load(i) for i in ids_test}


def build_free_convection_model(ds: ColumnTimeSeries, T_scaling, wT_scaling,
                                base_closure: str = "convective_adjustment"):
    """Constants, scalings and per-simulation scaled BC fluxes of a (stacked) dataset, on its device.

    The reference builds one NDE per simulation with its own boundary
    fluxes (``free_convection_nde.jl:49-62``); a stacked suite gets ``(S,)``
    flux tensors that ``pad_faces`` broadcasts left-aligned over the suite
    axis. ``H`` and ``tau`` enter the scalar prefactor and must agree across
    members; raises ``ValueError`` otherwise.
    """
    from climateparameterizations_jl_tpu_torch.models.free_convection import FreeConvectionModel

    H = ds.H.detach().cpu().numpy().reshape(-1)
    if not np.allclose(H, H[0]):
        raise ValueError(f"free-convection suite members disagree on column depth H: {H}")
    t_rows = ds.t.detach().cpu().numpy().reshape(-1, ds.t.shape[-1])
    taus = np.abs(t_rows[:, -1] - t_rows[:, 0])
    if not np.allclose(taus, taus[0]):
        raise ValueError(f"free-convection suite members disagree on time span tau: {taus}")
    c = lambda v: torch.tensor(v, dtype=ds.T.dtype, device=ds.T.device)  # noqa: E731
    return FreeConvectionModel(
        H=c(H[0]),
        tau=c(taus[0]),
        T_scaling=T_scaling,
        wT_scaling=wT_scaling,
        bottom_flux=wT_scaling.scale(ds.wT[..., 0, 0]),
        top_flux=wT_scaling.scale(torch.as_tensor(ds.theta_top)),
        Nz=ds.Nz,
        base_closure=base_closure,
    )


def free_convection_regression_pairs(ds: ColumnTimeSeries, T_scaling, wT_scaling):
    """Per-snapshot (scaled T profile, scaled wT faces) pairs, ``(S Nt, Nz)`` and ``(S Nt, Nz + 1)``.

    Parity: ``wrangle_input_training_data`` / ``wrangle_output_training_data``
    (``training_data.jl:15-46``). The targets include the boundary faces,
    which the trainer pins (they are BCs, not learnable).
    """
    x = T_scaling.scale(ds.T).reshape(-1, ds.T.shape[-1])
    y = wT_scaling.scale(ds.wT).reshape(-1, ds.wT.shape[-1])
    return x, y
