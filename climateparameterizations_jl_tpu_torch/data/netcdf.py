"""Minimal netCDF-4 writer and reader on the port's HDF5 codec (no netCDF library, no h5py).

Port of ``climateparameterizations_jl_tpu/data/netcdf.py``. The
reference's host-model embedding writes its paired simulations with
Oceananigans' ``NetCDFOutputWriter`` (``free_convection/src/oceananigans_nn.jl:167-210``).
netCDF-4 is HDF5 with the dimension-scale convention, so with ``data/hdf5.py`` alone:

- every dimension is a 1-D dimension-scale dataset holding its coordinates;
- every variable attaches the scales of its dimensions (the HDF5
  ``DIMENSION_LIST`` / ``REFERENCE_LIST`` attributes netCDF walks);
- the root ``_NCProperties`` attribute marks the file as netCDF-4.

Flat (root-group) classic-model files only, as the reference writes them.
Arrays may be numpy arrays or tensors (moved to the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data import hdf5

_NC_PROPERTIES = "version=2,climateparameterizations_jl_tpu_torch=1"


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_netcdf(path, variables: dict, coords: dict, attrs: dict | None = None) -> None:
    """Write a netCDF-4 (HDF5 with dimension scales) file.

    ``variables`` is ``{name: (dims, array)}`` with ``len(dims) ==
    array.ndim``; ``coords`` is ``{dim_name: 1-D coordinates}`` for every
    dimension a variable uses; ``attrs`` are optional root attributes.
    """
    variables = {name: (dims, _numpy(arr)) for name, (dims, arr) in variables.items()}
    coords = {dim: _numpy(values) for dim, values in coords.items()}
    for name, (dims, arr) in variables.items():
        if len(dims) != arr.ndim:
            raise ValueError(f"variable {name!r}: {len(dims)} dims for {arr.ndim}-D data")
        for d, n in zip(dims, arr.shape):
            if d not in coords:
                raise ValueError(f"variable {name!r}: dimension {d!r} missing from coords")
            if len(coords[d]) != n:
                raise ValueError(f"variable {name!r}: dim {d!r} is {len(coords[d])}, data has {n}")

    with hdf5.File(path, "w") as f:
        f.attrs["_NCProperties"] = np.bytes_(_NC_PROPERTIES)
        scales = {}
        for dim, values in coords.items():
            ds = f.create_dataset(dim, data=values)
            ds.make_scale(dim)
            scales[dim] = ds
        for name, (dims, arr) in variables.items():
            var = f.create_dataset(name, data=arr)
            var.attrs["_dims"] = np.array([d.encode() for d in dims])
            for i, d in enumerate(dims):
                var.dims[i].attach_scale(scales[d])
        for key, value in (attrs or {}).items():
            f.attrs[key] = value


def read_netcdf(path):
    """Read a file written by :func:`write_netcdf` (or any flat netCDF-4 file).

    Returns ``(variables, coords, attrs)``: ``{name: (dims, np.ndarray)}``,
    ``{dim: np.ndarray}`` and the root attributes but ``_NCProperties``.
    """
    variables, coords, attrs = {}, {}, {}
    with hdf5.File(path, "r") as f:
        for key, value in f.attrs.items():
            if key != "_NCProperties":
                attrs[key] = value
        for name, ds in f.items():
            if ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                coords[name] = np.asarray(ds[()])
                continue
            if "_dims" in ds.attrs:
                dims = tuple(d.decode() for d in ds.attrs["_dims"])
            else:  # the attached dimension scales' names
                dims = tuple((dim[0].name.lstrip("/") if len(dim) else f"dim_{i}") for i, dim in enumerate(ds.dims))
            variables[name] = (dims, np.asarray(ds[()]))
    return variables, coords, attrs


def write_paired_column_netcdf(output_dir, zc, zf, t, T_baseline, T_nn, wT_nn, attrs: dict | None = None):
    """Write the reference's two embedded-simulation output files; returns their paths.

    Parity: ``oceananigans_nn.jl:174-192``: the baseline (convective
    adjustment only) file holds ``T(time, zC)``; the ``+NN`` file holds
    ``T(time, zC)`` and the closure's heat flux ``wT(time, zF)``.
    """
    t = _numpy(t)
    base = {"T": (("time", "zC"), T_baseline)}
    nn = {"T": (("time", "zC"), T_nn), "wT": (("time", "zF"), wT_nn)}
    coords_c = {"time": t, "zC": zc}
    coords_f = {"time": t, "zC": zc, "zF": zf}
    path_ca = os.path.join(output_dir, "oceananigans_convective_adjustment.nc")
    path_nn = os.path.join(output_dir, "oceananigans_neural_network.nc")
    write_netcdf(path_ca, base, coords_c, attrs)
    write_netcdf(path_nn, nn, coords_f, attrs)
    return path_ca, path_nn
