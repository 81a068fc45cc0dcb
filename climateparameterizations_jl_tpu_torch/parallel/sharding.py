"""The column ensemble on one card: the JAX package's mesh API with one device.

Port of two names of ``climateparameterizations_jl_tpu/parallel/sharding.py``
(``make_mesh`` and ``make_sharded_ensemble_solver``, its ``:32-38`` and
``:292-309``). There the ensemble's columns shard over a 1-D device mesh
and the solve is one jitted program; on one device that program is the
plain batched split solve of ``train/nde.py::solve_with_config``, which is
what the port runs: every member on the batch axis of each implicit solve
(on the card one Thomas launch per substep for all members). The mesh is
therefore just its one device. A mesh of more than one device, and the rest
of the JAX module (sharded training steps, shard maps), belong to the
parallel port (``ROADMAP.md``, queue 1, item 4) and raise here.
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device


def make_mesh(n_devices: int | None = None, device=None) -> torch.device:
    """The mesh's one device: ``device`` (the card unless the caller asks for the CPU).

    ``n_devices`` greater than 1 raises ``NotImplementedError``: sharding an
    ensemble over several cards waits for the parallel port.
    """
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(f"make_mesh({n_devices}): a mesh of more than one device shards over several cards, "
                                  "which waits for the port of ROADMAP.md queue 1, item 4 (parallel)")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"make_mesh needs at least one device, got n_devices={n_devices}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_sharded_ensemble_solver(model, config, mesh: torch.device):
    """The forward ensemble solver on ``mesh``: ``solve(nns, bcs, x0, t0, dt_save, n_save)``.

    ``x0`` is ``(E, 3 Nz)`` with per-member (or shared) BCs on the device
    ``mesh``; the result is the ``(n_save + 1, E, 3 Nz)`` trajectory of
    :func:`~climateparameterizations_jl_tpu_torch.train.nde.solve_with_config`
    with ``config``'s solver knobs, run without autograd.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import solve_with_config

    def solve(nns, bcs, x0, t0, dt_save, n_save: int):
        if x0.device != mesh:
            raise ValueError(f"x0 lies on {x0.device}, the mesh on {mesh}")
        with torch.no_grad():
            return solve_with_config(model, nns, bcs, x0, t0, dt_save, n_save, config)

    return solve
