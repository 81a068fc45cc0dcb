"""MLP flux closures as frozen dataclasses of tensors.

Port of ``climateparameterizations_jl_tpu/closures/mlp.py:33-99``. The
wind-mixing closure is ``Dense(3Nz, 50, mish) -> Dense(50, 20, mish) ->
Dense(20, Nz-1)`` per flux (reference ``wind_mixing/train_NDE.jl:97-109``).
Weights keep the Flux ``(out, in)`` layout, so ``x @ W.T + b`` acts on the
last axis and one call serves a column or a ``(batch, features)`` block.
"""

from __future__ import annotations

import dataclasses
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
