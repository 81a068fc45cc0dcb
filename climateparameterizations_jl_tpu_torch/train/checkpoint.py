"""Checkpoints in the JAX package's npz format (no JAX needed).

Port of ``climateparameterizations_jl_tpu/train/checkpoint.py:37-186``. A
run directory holds ``state.npz`` (flattened pytree leaves under path keys:
``.name`` for a field, ``[i]`` for a sequence element, ``['key']`` for a
dict entry, joined by ``/``, as ``jax.tree_util.tree_flatten_with_path``
spells them), ``meta.json`` and an append-only ``history.jsonl``. A
checkpoint moves between the two packages in both directions. A train state
is ``{"params": nns, "opt_state": opt_state}`` with ``opt_state`` in optax's
layout (:func:`optax_state`); ``torch.optim.Adam``'s state maps onto it.

The JAX package's orbax variants (``save_checkpoint_orbax``,
``load_checkpoint_orbax``) write sharded checkpoints; their counterparts
here are :func:`save_checkpoint_dcp` and :func:`load_checkpoint_dcp`, on
``torch.distributed.checkpoint``: each rank writes the shards it owns,
replicated leaves are written once, and a checkpoint restores into a world
of another size.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import MLP, ConvMLP
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs


@dataclasses.dataclass
class TrainingHistory:
    """Append-only per-iteration history writer (``history.jsonl``)."""

    path: str

    def append(self, record: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def read(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def _map_leaves(tree, fn, path=()):
    """Rebuild ``tree`` with each tensor leaf replaced by ``fn(key, leaf)``.

    Keys follow the JAX package's ``tree_flatten_with_path`` spelling. Static
    fields (strings, ints, bools) and ``None`` are not leaves.
    """
    if isinstance(tree, torch.Tensor):
        return fn("/".join(path), tree)
    if tree is None or isinstance(tree, (str, bool, int)):
        return tree
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (f"[{k!r}]",)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map_leaves(getattr(tree, n), fn, path + (f".{n}",)) for n in tree._fields))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(getattr(tree, f.name), fn, path + (f".{f.name}",)) for f in dataclasses.fields(tree)
        })
    if isinstance(tree, (tuple, list)):
        return tuple(_map_leaves(v, fn, path + (f"[{i}]",)) for i, v in enumerate(tree))
    raise TypeError(f"unsupported checkpoint node {type(tree).__name__}")


def _tensors(tree) -> list:
    """The tensor leaves of ``tree``, in :func:`_map_leaves` order."""
    out = []
    _map_leaves(tree, lambda _key, leaf: out.append(leaf) or leaf)
    return out


def _read_meta(directory: str) -> dict:
    meta_path = os.path.join(directory, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def save_checkpoint(directory: str, state, meta: dict | None = None):
    """Save the tensors of ``state`` to ``state.npz`` and ``meta`` to ``meta.json``."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}

    def collect(key, leaf):
        arrays[key] = leaf.detach().cpu().numpy()
        return leaf

    _map_leaves(state, collect)
    np.savez(os.path.join(directory, "state.npz"), **arrays)
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)


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


def _dcp_state_dict(state, mesh, sharded: tuple):
    """``{key: tensor}`` of ``state``'s leaves; those under a ``sharded`` key prefix become row-sharded ``DTensor``s."""
    import torch.distributed as dist

    flat = {}

    def collect(key, leaf):
        if leaf.dim() >= 1 and any(key.startswith(p) for p in sharded) and dist.is_initialized():
            from torch.distributed.tensor import DTensor, Shard

            leaf = DTensor.from_local(leaf, mesh, [Shard(0)], run_check=False)
        flat[key] = leaf
        return leaf

    _map_leaves(state, collect)
    return flat


def save_checkpoint_dcp(directory: str, state, meta: dict | None = None, mesh=None, sharded: tuple = ()):
    """Sharded checkpoint through ``torch.distributed.checkpoint`` (the JAX package's ``save_checkpoint_orbax``).

    Every rank calls it. Leaves whose key (the ``state.npz`` spelling,
    e.g. ``['params'].wT.weights[0]``) starts with one of the ``sharded``
    prefixes (``""`` for every leaf) are this rank's block of a leading axis
    split evenly over the 1-D ``mesh`` (the member-sharded deep ensemble):
    each rank writes its own. The other leaves are replicated and written
    once. The tree goes to ``<directory>/dcp``; rank 0 writes ``meta.json``
    beside it, as in the npz layout. 0-d leaves are always replicated.
    """
    import torch.distributed.checkpoint as dcp

    from climateparameterizations_jl_tpu_torch.parallel import world

    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    dcp.save(_dcp_state_dict(state, mesh, tuple(sharded)), checkpoint_id=os.path.join(directory, "dcp"))
    if world.is_rank0():
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta or {}, f, indent=2, default=str)


def load_checkpoint_dcp(directory: str, skeleton, mesh=None, sharded: tuple = ()):
    """Restore a :func:`save_checkpoint_dcp` checkpoint into ``skeleton``; returns ``(state, meta)``.

    The JAX package's ``load_checkpoint_orbax`` with a skeleton. Every rank
    calls it with its own skeleton: under a ``sharded`` prefix a leaf is
    this rank's block on ``mesh``, elsewhere the whole tensor. The world
    may differ in size from the one that saved, down to no world at all
    (then every leaf is whole).
    """
    import torch.distributed.checkpoint as dcp

    directory = os.path.abspath(directory)
    targets = _dcp_state_dict(_map_leaves(skeleton, lambda _k, leaf: torch.empty_like(leaf)), mesh, tuple(sharded))
    dcp.load(targets, checkpoint_id=os.path.join(directory, "dcp"))
    state = _map_leaves(skeleton, lambda key, _leaf: getattr(targets[key], "to_local", lambda: targets[key])())
    return state, _read_meta(directory)


def mlp_skeleton(spec: dict, device=None, dtype=torch.float32) -> MLP:
    """A zero :class:`MLP` of ``spec = {"sizes": [...], "activation": ...}`` (a ``meta["arch"]`` entry)."""
    device = resolve_device(device)
    sizes = spec["sizes"]
    weights = tuple(torch.zeros((o, i), dtype=dtype, device=device) for i, o in zip(sizes[:-1], sizes[1:]))
    biases = tuple(torch.zeros((o,), dtype=dtype, device=device) for o in sizes[1:])
    return MLP(weights=weights, biases=biases, activation=spec["activation"])


def stacked_skeleton(skeleton, n_members: int):
    """``skeleton`` with a leading member axis of ``n_members`` on every tensor (zeros), to restore into."""
    return _map_leaves(skeleton, lambda _key, leaf: leaf.new_zeros((n_members, *leaf.shape)))


def load_run(directory: str, device=None, dtype=torch.float32) -> tuple[FluxNNs, dict]:
    """``(nns, meta)`` of a wind-mixing run directory written by either package.

    Layer sizes and activations come from ``meta.json``'s ``arch`` entry; a
    member missing there loads as ``None`` (the JAX package's ``_load_nns``),
    and a directory without ``arch`` holds three flagship MLPs
    (``96 -> 50 -> 20 -> 31``, mish). ``meta["mpp"]``, where present, is the
    mPP base the MLPs were trained over. ``meta["ensemble"] = K`` marks a
    deep ensemble: every tensor carries a leading member axis of ``K``.
    """
    meta = _read_meta(directory)
    flagship = {"sizes": [96, 50, 20, 31], "activation": "mish"}
    arch = meta.get("arch", dict.fromkeys(FluxNNs._fields, flagship))
    skeleton = FluxNNs(*(mlp_skeleton(arch[name], device, dtype) if name in arch else None
                         for name in FluxNNs._fields))
    if meta.get("ensemble"):
        skeleton = stacked_skeleton(skeleton, int(meta["ensemble"]))
    return load_checkpoint(directory, skeleton)


def load_fc_run(directory: str, device=None, dtype=torch.float32):
    """``(nn, meta)`` of a free-convection run directory (``train-fc-nde``) written by either package.

    ``meta["arch"]`` holds the dense layers' sizes and activation, and
    ``conv_width`` for a :class:`ConvMLP`; ``meta["ensemble"] = K`` stacks
    ``K`` members on a leading axis.
    """
    meta = _read_meta(directory)
    arch, device = meta["arch"], resolve_device(device)
    skeleton = mlp_skeleton(arch, device, dtype)
    if "conv_width" in arch:
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        skeleton = ConvMLP(kernel=zeros(arch["conv_width"]), conv_bias=zeros(), mlp=skeleton)
    if meta.get("ensemble"):
        skeleton = stacked_skeleton(skeleton, int(meta["ensemble"]))
    return load_checkpoint(directory, skeleton)


def load_flux_nns(directory: str, device=None, dtype=torch.float32) -> FluxNNs:
    """The flux MLPs of a wind-mixing run directory (:func:`load_run` without its meta)."""
    return load_run(directory, device, dtype)[0]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: step count (int32) and the two moment trees."""

    count: torch.Tensor
    mu: object
    nu: object


def optax_state(optimizer: torch.optim.Optimizer, params):
    """The state of ``optimizer`` over the leaves of ``params`` in optax's layout.

    ``torch.optim.Adam`` becomes ``(AdamState(count, mu, nu),)``, the state
    of ``optax.adam`` (``count`` = ``step``, ``mu`` = ``exp_avg``, ``nu`` =
    ``exp_avg_sq``; zeros before the first step). ``torch.optim.SGD``
    without momentum keeps no state, as ``optax.sgd`` keeps no leaves: ``()``.
    The moment tensors are the optimizer's own, not copies. Stacked
    (ensemble) parameters map the same way, their moments stacked alike.
    """
    if isinstance(optimizer, torch.optim.SGD):
        return ()
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(f"no optax layout for {type(optimizer).__name__}")
    steps = []

    def moment(name):
        def get(_key, p):
            state = optimizer.state.get(p, {})
            if "step" in state:
                steps.append(int(state["step"]))
            return state[name] if name in state else torch.zeros_like(p)
        return get

    mu = _map_leaves(params, moment("exp_avg"))
    nu = _map_leaves(params, moment("exp_avg_sq"))
    if len(set(steps)) > 1:
        raise ValueError(f"parameters of one Adam differ in their step counts: {sorted(set(steps))}")
    count = torch.tensor(steps[0] if steps else 0, dtype=torch.int32)
    return (AdamState(count=count, mu=mu, nu=nu),)


def load_optax_state(optimizer: torch.optim.Optimizer, params, opt_state):
    """Set ``optimizer``'s state over the leaves of ``params`` from :func:`optax_state`'s layout.

    The moments are copied (to each parameter's dtype and device), so the
    given ``opt_state`` is left as it was.
    """
    if isinstance(optimizer, torch.optim.SGD):
        if len(opt_state):
            raise ValueError("torch.optim.SGD takes the empty optax state ()")
        return
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(f"no optax layout for {type(optimizer).__name__}")
    (adam,) = opt_state
    step = float(int(adam.count))
    for p, m, v in zip(_tensors(params), _tensors(adam.mu), _tensors(adam.nu), strict=True):
        optimizer.state[p] = {
            "step": torch.tensor(step),
            "exp_avg": m.detach().to(dtype=p.dtype, device=p.device, copy=True),
            "exp_avg_sq": v.detach().to(dtype=p.dtype, device=p.device, copy=True),
        }


def optax_state_skeleton(optimizer: str, params):
    """Zeros in the optax layout of ``optimizer`` (``"adam"`` or ``"sgd"``), to restore into."""
    if optimizer == "sgd":
        return ()
    if optimizer != "adam":
        raise ValueError(f"no checkpoint layout for optimizer {optimizer!r}")
    zeros = lambda: _map_leaves(params, lambda _k, p: torch.zeros_like(p))  # noqa: E731
    return (AdamState(count=torch.zeros((), dtype=torch.int32), mu=zeros(), nu=zeros()),)


def history_path(directory: str) -> TrainingHistory:
    os.makedirs(directory, exist_ok=True)
    return TrainingHistory(os.path.join(directory, "history.jsonl"))


def extract_checkpoint(run_dir: str, out_dir: str):
    """Compact an append-only run directory into a final "extracted" directory.

    Parity: ``extract_NN`` (``wind_mixing/src/data_extraction.jl:1-150``):
    ``state.npz`` (the final leaves), ``train_state.npz`` (params and
    optimizer state, where the run saved them), ``meta.json`` (run metadata
    plus ``n_iterations`` and ``extracted_from``) and ``losses.npz`` (each
    history channel as one dense array; index ``k`` of every array is
    iteration ``k``, NaN where a record lacks the channel; booleans are not
    channels).
    """
    os.makedirs(out_dir, exist_ok=True)
    records = TrainingHistory(os.path.join(run_dir, "history.jsonl")).read()
    numeric = lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)  # noqa: E731
    keys = sorted({k for rec in records for k, v in rec.items() if numeric(v)})
    channels = {
        k: np.asarray([rec[k] if numeric(rec.get(k)) else np.nan for rec in records], np.float64)
        for k in keys
    }
    np.savez(os.path.join(out_dir, "losses.npz"), **channels)

    for src, dst in ((("state.npz",), "state.npz"), (("train_state", "state.npz"), "train_state.npz")):
        path = os.path.join(run_dir, *src)
        if os.path.exists(path):
            with np.load(path) as data:
                np.savez(os.path.join(out_dir, dst), **{k: data[k] for k in data.files})

    meta = _read_meta(run_dir)
    meta["n_iterations"] = len(records)
    meta["extracted_from"] = os.path.abspath(run_dir)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_extracted_losses(out_dir: str) -> dict:
    """The dense loss-history arrays written by :func:`extract_checkpoint`."""
    with np.load(os.path.join(out_dir, "losses.npz")) as data:
        return {k: data[k] for k in data.files}
