"""Read the JAX package's npz checkpoints (no JAX needed).

Partial port of ``climateparameterizations_jl_tpu/train/checkpoint.py:71``
(``load_checkpoint``). A run directory holds ``state.npz`` (flattened pytree
leaves under path keys such as ``.uw/.weights/[0]``: ``.name`` for a field,
``[i]`` for a sequence element, joined by ``/``) and ``meta.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import MLP
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs


def _map_leaves(tree, fn, path=()):
    """Rebuild ``tree`` with each tensor leaf replaced by ``fn(key, leaf)``.

    Keys follow the JAX package's ``tree_flatten_with_path`` spelling. Static
    fields (strings, ints, bools) and ``None`` are not leaves.
    """
    if isinstance(tree, torch.Tensor):
        return fn("/".join(path), tree)
    if tree is None or isinstance(tree, (str, bool, int)):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map_leaves(getattr(tree, n), fn, path + (f".{n}",)) for n in tree._fields))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(getattr(tree, f.name), fn, path + (f".{f.name}",)) for f in dataclasses.fields(tree)
        })
    if isinstance(tree, (tuple, list)):
        return tuple(_map_leaves(v, fn, path + (f"[{i}]",)) for i, v in enumerate(tree))
    raise TypeError(f"unsupported checkpoint node {type(tree).__name__}")


def _read_meta(directory: str) -> dict:
    meta_path = os.path.join(directory, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_checkpoint(directory: str, skeleton):
    """Restore arrays into ``skeleton`` (same structure); returns ``(state, meta)``.

    Each leaf takes the skeleton leaf's shape, dtype and device.
    """
    with np.load(os.path.join(directory, "state.npz")) as data:
        def restore(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.asarray(data[key]).reshape(tuple(leaf.shape))
            return torch.tensor(arr, dtype=leaf.dtype, device=leaf.device)

        state = _map_leaves(skeleton, restore)
    return state, _read_meta(directory)


def load_flux_nns(directory: str, device=None, dtype=torch.float32) -> FluxNNs:
    """The three flux MLPs of a wind-mixing run directory.

    Layer sizes and activations come from ``meta.json``'s ``arch`` entry
    (default: the flagship ``96 -> 50 -> 20 -> 31``, mish).
    """
    device = resolve_device(device)
    arch = _read_meta(directory).get("arch", {})

    def skeleton(name):
        spec = arch.get(name, {"sizes": [96, 50, 20, 31], "activation": "mish"})
        sizes = spec["sizes"]
        weights = tuple(torch.zeros((o, i), dtype=dtype, device=device) for i, o in zip(sizes[:-1], sizes[1:]))
        biases = tuple(torch.zeros((o,), dtype=dtype, device=device) for o in sizes[1:])
        return MLP(weights=weights, biases=biases, activation=spec["activation"])

    nns, _ = load_checkpoint(directory, FluxNNs(skeleton("uw"), skeleton("vw"), skeleton("wT")))
    return nns
