"""MLP flux closures as frozen dataclasses of tensors.

Port of ``climateparameterizations_jl_tpu/closures/mlp.py``. The
wind-mixing closure is ``Dense(3Nz, 50, mish) -> Dense(50, 20, mish) ->
Dense(20, Nz-1)`` per flux (reference ``wind_mixing/train_NDE.jl:97-109``);
the free-convection closure is ``Dense(Nz, 4Nz, relu) -> Dense(4Nz, 4Nz,
relu) -> Dense(4Nz, Nz-1)``, optionally behind a 1-D convolution
(:class:`ConvMLP`, ``free_convection/train_free_convection_nde.jl:110-122``).
Weights keep the Flux ``(out, in)`` layout, so ``x @ W.T + b`` acts on the
last axis and one call serves a column or a ``(batch, features)`` block.
Initializers draw from a ``torch.Generator``; weights from the JAX package
cross through ``bridge.from_reference``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device


def softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def mish(x):
    return x * torch.tanh(softplus(x))


_ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "mish": mish,
    # jax.nn.gelu defaults to the tanh approximation.
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "swish": torch.nn.functional.silu,
    "linear": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class MLP:
    """Feed-forward network: ``weights[i]`` has shape ``(out_i, in_i)`` (Flux layout)."""

    weights: tuple
    biases: tuple
    activation: str = "relu"

    @property
    def sizes(self) -> tuple:
        return tuple(w.shape[1] for w in self.weights) + (self.weights[-1].shape[0],)

    def __call__(self, x):
        return mlp_apply(self, x)


def mlp_init(generator: torch.Generator, sizes: Sequence[int], activation: str = "relu",
             dtype=torch.float32, scale: float = 1.0, device=None) -> MLP:
    """Glorot-uniform init (Flux's default for ``Dense``) with an optional weight scale.

    ``scale`` supports the reference's ``weights ./ 1f5`` near-zero init
    (``wind_mixing/train_NDE.jl:102-109``). Draws come from ``generator``
    (a CPU ``torch.Generator``) and are then moved to ``device``: ``cuda``
    unless the caller asks for the CPU (:func:`resolve_device`).
    """
    device = resolve_device(device)
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; choose from {sorted(_ACTIVATIONS)}")
    weights, biases = [], []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
        W = (torch.rand((fan_out, fan_in), generator=generator, dtype=dtype) * (2 * bound) - bound) * scale
        weights.append(W.to(device))
        biases.append(torch.zeros((fan_out,), dtype=dtype, device=device))
    return MLP(weights=tuple(weights), biases=tuple(biases), activation=activation)


def mlp_apply(nn: MLP, x):
    """Apply over the last axis; batches over leading axes."""
    act = _ACTIVATIONS[nn.activation]
    n = len(nn.weights)
    for i, (W, b) in enumerate(zip(nn.weights, nn.biases)):
        x = x @ W.T + b
        if i < n - 1:
            x = act(x)
    return x


def wind_mixing_mlp(generator: torch.Generator, Nz: int = 32, hidden=(50, 20), activation: str = "mish",
                    dtype=torch.float32, scale: float = 1.0, device=None) -> MLP:
    """``3Nz -> hidden... -> Nz-1`` momentum/heat-flux closure (``train_NDE.jl:97-109``)."""
    return mlp_init(generator, (3 * Nz, *hidden, Nz - 1), activation, dtype, scale=scale, device=device)


def free_convection_mlp(generator: torch.Generator, Nz: int = 32, activation: str = "relu", dtype=torch.float32,
                        device=None) -> MLP:
    """``Nz -> 4Nz -> 4Nz -> Nz-1`` heat-flux closure (``train_free_convection_nde.jl:110-116``)."""
    return mlp_init(generator, (Nz, 4 * Nz, 4 * Nz, Nz - 1), activation, dtype, device=device)


def _leaves(nn) -> list:
    if isinstance(nn, ConvMLP):
        return [nn.kernel, nn.conv_bias, *_leaves(nn.mlp)]
    return [*nn.weights, *nn.biases]


def destructure(nn):
    """All parameters as one flat vector, and ``rebuild(vector)`` giving the closure back.

    The contract of ``Flux.destructure`` (``NDE_training.jl:11-13``) in the
    JAX package's order (all weights row-major, then all biases; a
    :class:`ConvMLP`'s kernel and bias first), not Flux's byte layout.
    """
    leaves = _leaves(nn)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def rebuild(vector):
        out, offset = [], 0
        for shape in shapes:
            size = math.prod(shape)
            out.append(vector[offset: offset + size].reshape(shape))
            offset += size
        return _rebuild(nn, out)

    return flat, rebuild


def _rebuild(nn, leaves: list):
    if isinstance(nn, ConvMLP):
        return ConvMLP(kernel=leaves[0], conv_bias=leaves[1], mlp=_rebuild(nn.mlp, leaves[2:]))
    n = len(nn.weights)
    return MLP(weights=tuple(leaves[:n]), biases=tuple(leaves[n:]), activation=nn.activation)


@dataclasses.dataclass(frozen=True)
class ConvMLP:
    """1-D convolution front end + dense MLP: the reference's ``--conv`` variant.

    ``Chain(Conv((w, 1), 1 => 1, relu), Dense(Nz - w + 1, 4Nz, relu), ...)``
    (``train_free_convection_nde.jl:110-118``); the valid single-channel
    convolution is ``w`` shifted adds.
    """

    kernel: torch.Tensor  # (width,)
    conv_bias: torch.Tensor  # ()
    mlp: MLP

    @property
    def width(self) -> int:
        return self.kernel.shape[0]

    def __call__(self, x):
        return conv_mlp_apply(self, x)


def conv_mlp_apply(nn: ConvMLP, x):
    """Apply over the last axis: ``(..., Nz) -> (..., n_out)``."""
    w = nn.width
    n = x.shape[-1]
    out = nn.kernel[0] * x[..., : n - w + 1]
    for k in range(1, w):
        out = out + nn.kernel[k] * x[..., k : n - w + 1 + k]
    return mlp_apply(nn.mlp, torch.relu(out + nn.conv_bias))


def free_convection_conv_mlp(generator: torch.Generator, Nz: int = 32, conv_width: int = 2, activation: str = "relu",
                             dtype=torch.float32, device=None) -> ConvMLP:
    """Convolutional free-convection closure (``--conv w`` with ``w > 1``), on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    bound = float(np.sqrt(6.0 / (conv_width + 1)))
    kernel = torch.rand((conv_width,), generator=generator, dtype=dtype) * (2 * bound) - bound
    mlp = mlp_init(generator, [Nz - conv_width + 1, 4 * Nz, 4 * Nz, Nz - 1], activation, dtype, device=device)
    return ConvMLP(kernel=kernel.to(device), conv_bias=torch.zeros((), dtype=dtype, device=device), mlp=mlp)


def _first_dense(nn) -> MLP:
    return nn.mlp if isinstance(nn, ConvMLP) else nn


def spatial_causality_mask(shape: tuple, device=None) -> torch.Tensor:
    """Boolean mask of the acausal entries of an ``(n_out, n_in)`` weight: ``mask[i, j] = i < j``.

    The reference's ``[x < y for x in 1:nrows, y in 1:ncols]``
    (``train_free_convection_nde.jl:188-193``).
    """
    i = torch.arange(shape[0], device=device)[:, None]
    j = torch.arange(shape[1], device=device)[None, :]
    return i < j


def spatial_causality_penalty(nn) -> torch.Tensor:
    """Soft penalty ``sum(W1[mask]^2)`` on the first dense layer (``train_free_convection_nde.jl:195-197``)."""
    W1 = _first_dense(nn).weights[0]
    return torch.sum(torch.where(spatial_causality_mask(W1.shape, W1.device), W1, 0.0) ** 2)


def apply_spatial_causality_mask(nn):
    """Hard variant: the closure with the acausal entries of every weight matrix zeroed.

    Parity: ``dense_spatial_causality_train!``
    (``free_convection/src/training.jl:24-42``) masks every weight matrix;
    lower-triangularity survives composition only if all layers are masked.
    Call after each optimizer update.
    """
    dense = _first_dense(nn)
    masked = tuple(torch.where(spatial_causality_mask(W.shape, W.device), 0.0, W) for W in dense.weights)
    new_dense = dataclasses.replace(dense, weights=masked)
    return dataclasses.replace(nn, mlp=new_dense) if isinstance(nn, ConvMLP) else new_dense


def apply_spatial_causality_mask_(nn):
    """:func:`apply_spatial_causality_mask` in place, without autograd; returns ``nn``.

    The projection a trainer applies to its parameters after each update.
    """
    with torch.no_grad():
        for W in _first_dense(nn).weights:
            W.masked_fill_(spatial_causality_mask(W.shape, W.device), 0.0)
    return nn


def apply_closure(nn, x):
    """Apply either closure flavor (:class:`MLP` or :class:`ConvMLP`) over the last axis."""
    return conv_mlp_apply(nn, x) if isinstance(nn, ConvMLP) else mlp_apply(nn, x)
