"""Fixed-step explicit timesteppers.

Port of ``climateparameterizations_jl_tpu/models/timestepper.py:23-91``,
forward only: the JAX package's ``lax.scan`` becomes a Python loop, and its
``checkpoint`` (rematerialization for the backward pass) is accepted and has
no effect here. All steppers advance ``dx/dt = rhs(x, t)`` with arbitrary
leading batch axes on ``x``.
"""

from __future__ import annotations

import torch


def euler_step(rhs, x, t, dt):
    return x + dt * rhs(x, t)


def heun_step(rhs, x, t, dt):
    k1 = rhs(x, t)
    k2 = rhs(x + dt * k1, t + dt)
    return x + 0.5 * dt * (k1 + k2)


def rk4_step(rhs, x, t, dt):
    k1 = rhs(x, t)
    k2 = rhs(x + 0.5 * dt * k1, t + 0.5 * dt)
    k3 = rhs(x + 0.5 * dt * k2, t + 0.5 * dt)
    k4 = rhs(x + dt * k3, t + dt)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {"euler": euler_step, "heun": heun_step, "rk4": rk4_step}


def solve_fixed_step(rhs, x0, t0, dt_save, n_save: int, n_substeps: int = 1, method="rk4",
                     checkpoint: bool = True, unroll: int = 1):
    """Integrate and save ``n_save + 1`` states (including ``x0``) at uniform intervals.

    ``method`` is ``euler | heun | rk4`` or a callable ``step(rhs, x, t, dt)``.
    ``checkpoint`` and ``unroll`` are the JAX package's scan knobs; they do
    not change the result and are accepted so that callers carry over.
    Returns a tensor of shape ``(n_save + 1, *x0.shape)``.
    """
    del checkpoint, unroll
    step = method if callable(method) else _STEPPERS[method]
    dt = dt_save / n_substeps
    xs = [x0]
    x = x0
    for i in range(n_save):
        t_start = t0 + i * dt_save
        for j in range(n_substeps):
            x = step(rhs, x, t_start + j * dt, dt)
        xs.append(x)
    return torch.stack(xs, dim=0)


def trajectory_times(t0, dt_save, n_save: int):
    """Save times matching :func:`solve_fixed_step` output."""
    return t0 + dt_save * torch.arange(n_save + 1)
