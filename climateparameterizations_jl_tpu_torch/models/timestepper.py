"""Fixed-step explicit timesteppers.

Port of ``climateparameterizations_jl_tpu/models/timestepper.py``:
the JAX package's ``lax.scan`` becomes a Python loop, and its
``jax.checkpoint`` around one save interval becomes
``torch.utils.checkpoint`` (non-reentrant): a backward pass keeps only the
saved states and recomputes each interval's substeps. All steppers advance
``dx/dt = rhs(x, t)`` with arbitrary leading batch axes on ``x``.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint


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
    ``checkpoint=True`` wraps each save interval in
    ``torch.utils.checkpoint.checkpoint`` where autograd records the solve
    (the substeps run again in the backward pass instead of being stored);
    it does not change the result. ``unroll`` is the JAX package's scan knob
    and has no effect here. Returns a tensor of shape ``(n_save + 1, *x0.shape)``.
    """
    del unroll
    step = method if callable(method) else _STEPPERS[method]
    dt = dt_save / n_substeps

    def interval(x, t_start):
        for j in range(n_substeps):
            x = step(rhs, x, t_start + j * dt, dt)
        return x

    remat = checkpoint and torch.is_grad_enabled()
    xs = [x0]
    x = x0
    for i in range(n_save):
        t_start = t0 + i * dt_save
        if remat:
            x = torch.utils.checkpoint.checkpoint(interval, x, t_start, use_reentrant=False)
        else:
            x = interval(x, t_start)
        xs.append(x)
    return torch.stack(xs, dim=0)


def trajectory_times(t0, dt_save, n_save: int):
    """Save times matching :func:`solve_fixed_step` output."""
    return t0 + dt_save * torch.arange(n_save + 1)


def stable_substeps(nu_max: float, dt_save: float, dz: float, method: str = "rk4", safety: float = 0.5) -> int:
    """Substep count keeping explicit diffusion stable: ``dt < safety * dz^2 / (2 nu)``.

    The Euler bound scaled by ``safety`` for every ``method`` (RK4's
    real-axis stability interval, about 2.79, would allow a little more).
    """
    if nu_max <= 0:
        return 1
    dt_stable = safety * dz * dz / (2.0 * nu_max)
    return max(1, int(math.ceil(dt_save / dt_stable)))
