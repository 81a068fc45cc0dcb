"""Carry parameters over from the JAX package into the port's objects.

The port imports nothing of the JAX package, so this module works by names:
it takes an object of the JAX package (or any object with the same fields)
whose class name is one of the port's (``MLP``, ``FluxNNs``,
``PackedFluxNNs``, ``ZeroMeanUnitVarianceScaling``, ``WindMixingScalings``,
``MPPParameters``, ``BoundaryConditions``, ``WindMixingModel``, and the GP
classes ``GPKernel``, ``SpectralMixtureKernel``, ``GPModel``, ``FluxGPs``),
reads each field the port's class declares, and turns every array leaf into
a tensor through numpy (``np.asarray``). Static fields (``Nz``, flags,
activation names) pass through unchanged. The JAX RNG is never re-seeded on
this side: weights cross as numbers.

GP objects keep each leaf's own dtype (GP models are f64 by default), and a
``GPKernel``'s Gram backend is renamed: ``"xla"`` becomes ``"plain"`` and
``"pallas"`` becomes ``"cuda"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.gp import GPKernel, GPModel, SpectralMixtureKernel
from climateparameterizations_jl_tpu_torch.closures.mlp import MLP
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.models.gp_closure import FluxGPs
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    BoundaryConditions,
    FluxNNs,
    PackedFluxNNs,
    WindMixingModel,
    WindMixingScalings,
)
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

_GP_CLASSES = (GPKernel, SpectralMixtureKernel, GPModel, FluxGPs)
_CLASSES = {
    cls.__name__: cls
    for cls in (MLP, FluxNNs, PackedFluxNNs, ZeroMeanUnitVarianceScaling, WindMixingScalings,
                MPPParameters, BoundaryConditions, WindMixingModel, *_GP_CLASSES)
}
_GRAM_BACKENDS = {"xla": "plain", "pallas": "cuda"}


def from_reference(obj, device=None, dtype=torch.float32):
    """Convert a JAX-package object (parameters as arrays) into the port's twin on ``device``.

    Array leaves become ``dtype``, except inside GP objects, whose leaves
    keep their own dtype.
    """
    return _convert(obj, resolve_device(device), dtype)


def _convert(obj, device, dtype):
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    cls = _CLASSES.get(type(obj).__name__)
    if cls in _GP_CLASSES:
        dtype = None
    if cls in (FluxNNs, FluxGPs):
        return cls(*(_convert(getattr(obj, name), device, dtype) for name in cls._fields))
    if cls is not None:
        fields = {f.name: _convert(getattr(obj, f.name), device, dtype) for f in dataclasses.fields(cls)}
        if cls is GPKernel:
            fields["backend"] = _GRAM_BACKENDS.get(fields["backend"], fields["backend"])
        return cls(**fields)
    if isinstance(obj, (tuple, list)):
        return tuple(_convert(o, device, dtype) for o in obj)
    arr = np.asarray(obj)
    if arr.dtype.kind not in "fiu":
        raise TypeError(f"cannot carry over a leaf of type {type(obj).__name__} ({arr.dtype})")
    return torch.tensor(arr, dtype=dtype, device=device)
