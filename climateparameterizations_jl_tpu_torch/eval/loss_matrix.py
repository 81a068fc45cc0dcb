"""Loss matrices across simulations and the replay of training epochs.

Port of ``climateparameterizations_jl_tpu/eval/loss_matrix.py``:

- ``plot_loss_matrix`` (``free_convection/src/testing.jl:186-231``): the
  losses of every simulation x every solution type;
- ``compute_nde_solution_history`` (``free_convection/src/testing.jl:1-32``):
  re-solve the free-convection NDE for every checkpointed epoch.

The JAX package stacks the epochs and vmaps one solve over them. Here the
epochs are replayed one solve each: the closure may be a ``ConvMLP``, which
has no block-diagonal fold onto the batch axis (``eval/ensemble_uq.py``
loops over free-convection members for the same reason), and a replay is
an offline pass over a handful of checkpoints.
"""

from __future__ import annotations

import torch


def _mse(truth, sol, dims):
    truth = torch.as_tensor(truth)
    return (torch.as_tensor(sol, device=truth.device) - truth).pow(2).mean(dim=dims).detach().cpu().numpy()


def loss_matrix(truth, solutions: dict) -> dict:
    """Time-mean MSE of each named solution against ``truth``, batched over leading axes.

    ``truth``: ``(..., Nt, N)``; each solution the same shape (or
    broadcastable). Returns ``{name: (...,) ndarray}``: one number per
    simulation per solution type (``testing.jl:186-231``).
    """
    return {name: _mse(truth, sol, (-2, -1)) for name, sol in solutions.items()}


def loss_per_timestep_matrix(truth, solutions: dict) -> dict:
    """Per-timestep MSE curves ``{name: (..., Nt)}`` (``testing.jl:64-101``)."""
    return {name: _mse(truth, sol, -1) for name, sol in solutions.items()}


def solution_history(model, nn_history: list, T0_scaled, t0, dt_save, n_save: int, n_substeps: int = 2,
                     method: str = "split"):
    """Solve the free-convection NDE for every training epoch; scaled trajectories ``(E, n_save + 1, ..., Nz)``.

    One solve per epoch, without autograd; ``split`` runs its implicit
    solves on the Thomas kernel for card tensors and on the plain scan on
    the CPU. Parity: ``compute_nde_solution_history`` (``testing.jl:1-32``).
    """
    from climateparameterizations_jl_tpu_torch.models.free_convection import solve_free_convection_nde
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    backend = resolve_tridiag_backend("auto", n_save * n_substeps, T0_scaled.device)
    with torch.no_grad():
        return torch.stack([solve_free_convection_nde(model, nn, T0_scaled, t0, dt_save, n_save, n_substeps,
                                                      method=method, tridiag_backend=backend)
                            for nn in nn_history])


def epoch_losses(trajectories, truth_scaled):
    """Per-epoch scalar loss ``(E,)`` of :func:`solution_history`'s output."""
    trajectories = torch.as_tensor(trajectories)
    return _mse(truth_scaled[None], trajectories, tuple(range(1, trajectories.dim())))
