"""Command-line helpers, partial port of ``climateparameterizations_jl_tpu/cli/main.py``.

Only what the training path needs: :func:`_suite_diurnal_flags`,
:func:`_load_suite` and :func:`_wind_model`. The argparse CLI itself is
later work (``ROADMAP.md``, queue 1 item 22).
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device


def _suite_diurnal_flags(names) -> list:
    from climateparameterizations_jl_tpu_torch.data.registry import simulation_parameters

    flags = []
    for n in names:
        try:
            flags.append(bool(simulation_parameters(n).diurnal))
        except KeyError:
            flags.append(False)
    return flags


def _load_suite(names, Nz: int, data_dir=None, n_save=288, dt_save=600.0, Nz_les=128, device=None):
    """The coarse suite of catalog ``names``, stacked on a leading axis, on ``device``.

    The synthetic stand-ins are generated on the CPU (``data/synthetic.py``)
    and moved to ``device`` (``cuda`` unless the caller asks for the CPU) at
    the end. Members that share the generator's column (``f``, ``H``,
    ``alpha``, ``g``, grid and diurnal flag) run as one batched split solve
    instead of one solve each. Diurnal members keep their time-varying top
    ``wT`` face; the others have their surface fluxes pinned.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import (
        coarsen_dataset,
        enforce_surface_fluxes,
        stack_datasets,
    )
    from climateparameterizations_jl_tpu_torch.data.registry import (
        require_synthetic,
        signed_momentum_flux,
        simulation_parameters,
    )
    from climateparameterizations_jl_tpu_torch.data.synthetic import _synthetic_wind_mixing_les_batch

    device = resolve_device(device)
    require_synthetic(data_dir)
    specs = [simulation_parameters(n) for n in names]
    groups: dict = {}
    for i, spec in enumerate(specs):
        groups.setdefault((spec.f, spec.diurnal), []).append(i)
    raw = [None] * len(names)
    for (f, diurnal), members in groups.items():
        generated = _synthetic_wind_mixing_les_batch(
            [signed_momentum_flux(specs[i]) for i in members], [specs[i].Qb for i in members],
            f=f, diurnal=diurnal, Nz=Nz_les, n_save=n_save, dt_save=dt_save,
        )
        for i, ds in zip(members, generated):
            raw[i] = ds
    datasets = []
    for ds, spec in zip(raw, specs):
        ds = coarsen_dataset(ds, Nz)
        datasets.append(ds if spec.diurnal else enforce_surface_fluxes(ds))
    suite = stack_datasets(datasets) if len(datasets) > 1 else datasets[0]
    return suite.to(device)


def _wind_model(ds, Nz: int, **overrides):
    """The wind-mixing model of a (stacked) suite, on the suite's device.

    Scalings are fitted on the suite; ``tau`` is its time span; the mPP
    parameters are the defaults. ``overrides`` replace any field.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import fit_wind_mixing_scalings
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import WindMixingModel
    from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

    device = ds.T.device
    scalings = fit_wind_mixing_scalings(ds)
    first = lambda x: x.reshape(-1)[0]  # noqa: E731 - suite-stacked constants are identical
    t_row = ds.t.reshape(-1, ds.t.shape[-1])[0]
    kw = dict(
        H=first(ds.H), tau=torch.abs(t_row[-1] - t_row[0]), f=first(ds.f), g=first(ds.g),
        alpha=first(ds.alpha), kappa=torch.tensor(10.0, dtype=torch.float32, device=device), scalings=scalings,
        mpp=MPPParameters.default(torch.float32, device), Nz=Nz,
    )
    kw.update(overrides)
    return WindMixingModel(**kw)
