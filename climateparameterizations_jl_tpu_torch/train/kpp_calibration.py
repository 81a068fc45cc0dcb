"""KPP parameter calibration: random plugin search, then a random line search or exact-gradient adam.

Port of ``climateparameterizations_jl_tpu/train/kpp_calibration.py``
(reference ``free_convection/train_kpp.jl:101-249``): draw parameter sets
from uniform priors (``RandomPlugin``), keep the best, refine it with a
finite-difference line search along one random coordinate per iteration
(``RandomLineSearch``) or with projected adam through the solve. Every loss
evaluation is a KPP solve against the LES temperature.

A population of P parameter sets is ONE solve: the JAX package vmaps the
single evaluation, and here the P sets ride the solve's batch axis (each
overridden field ``(P, 1, ...)`` against ``(P, S, Nz)`` states), so on the
card every KPP step of the whole population is one Thomas launch on
``(3, P, S, Nz)``. The loss and forward functions take ``(d,)`` (one set) or
``(P, d)`` (a population) and give ``()`` / ``(P,)`` losses. Random draws
come from a ``torch.Generator``; the JAX package's ``jax.random`` draws are
not reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries
from climateparameterizations_jl_tpu_torch.physics.kpp import KPPForcing, KPPParameters, KPPState, solve_kpp

DEFAULT_PRIORS = {
    # train_kpp.jl:205-210 (uniform priors over the four free parameters)
    "CSL": (0.01, 0.99),
    "CNL": (0.0, 8.0),
    "Cb_T": (0.0, 6.0),
    "CKE": (0.0, 5.0),
}


def _with_overrides(base: KPPParameters, names, values) -> KPPParameters:
    return dataclasses.replace(base, **{n: v for n, v in zip(names, values)})


def _suite_constant(x, name: str):
    """A suite constant (``H``, ``f``, ``g``, ``alpha``) as a 0-d tensor; members that differ raise.

    The JAX function passes a stacked suite's ``(S,)`` constants to its
    solve, where they broadcast against the level axis and fail (or, at
    ``S = Nz``, pair each level with a simulation). One column geometry per
    solve is what the solve supports.
    """
    x = torch.as_tensor(x)
    flat = x.reshape(-1)
    if flat.numel() > 1 and not bool(torch.all(flat == flat[0])):
        raise ValueError(f"make_kpp_forward_fn: the suite's members differ in {name}; calibrate them separately")
    return flat[0]


def make_kpp_forward_fn(ds: ColumnTimeSeries, tsteps, Nz: int, base_params: KPPParameters | None = None,
                        names: tuple = ("CSL", "CNL", "Cb_T", "CKE"), n_substeps: int = 1,
                        tridiag_backend: str = "auto"):
    """Forward map ``values -> flattened T trajectory`` and the matching flattened LES truth.

    Returns ``(forward, y_obs)``: ``forward`` maps ``(d,)`` to ``(n,)`` and a
    population ``(P, d)`` to ``(P, n)`` in one solve (the ``(G, y)`` pair of
    Ensemble Kalman Inversion; ``train_kpp.jl:78-99``). The save grid must be
    uniform. Diurnal datasets thread their cycle into the solve; a suite
    that mixes diurnal and constant members raises.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import _require_uniform

    tsteps = np.asarray(tsteps)
    idx = torch.as_tensor(tsteps, dtype=torch.long, device=ds.T.device)
    T_truth = ds.T.index_select(-2, idx)
    t_row = ds.t[0] if ds.t.dim() > 1 else ds.t
    t_save = t_row.index_select(0, idx)
    _require_uniform(t_save, "make_kpp_forward_fn")
    base = base_params if base_params is not None else KPPParameters.default(device=ds.T.device)
    i0 = int(tsteps[0])
    state0 = KPPState(U=ds.u[..., i0, :], V=ds.v[..., i0, :], T=ds.T[..., i0, :])
    # A diurnal dataset's surface flux cycles: its amplitude as a constant flux would be wrong physics.
    amp = None if ds.diurnal_amplitude is None else ds.diurnal_amplitude.detach().cpu().numpy()
    diurnal = amp is not None and bool(np.any(amp != 0.0))
    if diurnal and bool(np.any(amp == 0.0)):
        raise ValueError("make_kpp_forward_fn: mixed diurnal/constant suite: calibrate these separately "
                         "(solve_kpp's diurnal flag is whole-batch)")
    theta_surface = ds.diurnal_amplitude if diurnal else ds.theta_top
    forcing = KPPForcing(Fu=ds.u_top, Fb=theta_surface * ds.g * ds.alpha, dTdz_bottom=ds.theta_bottom)
    H, f_cor, g, alpha = (_suite_constant(getattr(ds, k), k) for k in ("H", "f", "g", "alpha"))
    batch = ds.T.shape[:-2]

    def forward(values):
        values = torch.as_tensor(values, dtype=ds.T.dtype, device=ds.T.device)
        if values.dim() == 1:
            params, s0 = _with_overrides(base, names, [values[i] for i in range(len(names))]), state0
        else:
            P = values.shape[0]
            per_set = lambda i: values[:, i].reshape(P, *([1] * len(batch)))  # noqa: E731
            params = _with_overrides(base, names, [per_set(i) for i in range(len(names))])
            s0 = KPPState(**{k: getattr(state0, k).expand(P, *state0.T.shape) for k in ("U", "V", "T")})
        sol = solve_kpp(s0, t_save, params, forcing, H, Nz, f_cor, g, alpha, n_substeps=n_substeps,
                        tridiag_backend=tridiag_backend, diurnal=diurnal)
        # Time-major (Nt, [P,] ..., Nz) -> ([P,] ..., Nt, Nz), flattened per set.
        T = torch.movedim(sol.T, 0, -2)
        return T.reshape(-1) if values.dim() == 1 else T.reshape(values.shape[0], -1)

    return forward, T_truth.reshape(-1)


def make_kpp_loss_fn(ds: ColumnTimeSeries, tsteps, Nz: int, base_params: KPPParameters | None = None,
                     names: tuple = ("CSL", "CNL", "Cb_T", "CKE"), n_substeps: int = 1,
                     tridiag_backend: str = "auto") -> Callable:
    """``loss(values)``: the MSE of the KPP temperature trajectory against the dataset.

    ``values`` is ``(d,)`` ordered like ``names`` (a 0-d loss) or a
    population ``(P, d)`` (``(P,)`` losses from one solve).
    """
    forward, y = make_kpp_forward_fn(ds, tsteps, Nz, base_params, names, n_substeps, tridiag_backend)

    def loss(values):
        return torch.mean((forward(values) - y) ** 2, dim=-1)

    return loss


def _finite_or_inf(losses):
    return torch.where(torch.isfinite(losses), losses, torch.full_like(losses, float("inf")))


def random_plugin(loss_fn: Callable, priors: dict, n_samples: int, generator: torch.Generator | None = None):
    """Uniform random search; returns ``(best_values, best_loss, all_losses)``.

    The candidates are drawn in f64 from ``generator`` (a CPU generator,
    seed 0 by default) and evaluated as one population, one solve. Parity:
    ``RandomPlugin`` (``train_kpp.jl:101-152``).
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    names = list(priors.keys())
    lo = torch.tensor([priors[n][0] for n in names], dtype=torch.float64)
    hi = torch.tensor([priors[n][1] for n in names], dtype=torch.float64)
    candidates = lo + (hi - lo) * torch.rand((n_samples, len(names)), generator=generator, dtype=torch.float64)
    with torch.no_grad():
        losses = _finite_or_inf(loss_fn(candidates))
    best = int(torch.argmin(losses))
    return candidates[best], losses[best], losses


def random_line_search(loss_fn: Callable, values0, generator: torch.Generator | None = None, n_iters: int = 20,
                       n_steps: int = 12, max_step: float = 0.5, fd_eps: float = 1e-4, bounds: tuple | None = None):
    """Numerical-gradient line search along one random coordinate per iteration.

    Each iteration picks a coordinate, takes a central finite difference of
    the loss there, and evaluates a geometric ladder of ``n_steps`` step
    sizes along the descent direction as one population, keeping the best
    if it improves. Returns ``(values, history)``; ``history`` is the
    best-so-far loss, monotone. Parity: ``RandomLineSearch``
    (``train_kpp.jl:154-249``).
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    values = torch.as_tensor(values0, dtype=torch.float64).detach().cpu()
    n_dim = values.shape[0]
    steps = max_step * torch.logspace(-3.0, 0.0, n_steps, dtype=torch.float64)

    def scalar(v):
        return float(loss_fn(v))

    with torch.no_grad():
        history = [scalar(values)]
        for _ in range(n_iters):
            coord = int(torch.randint(0, n_dim, (), generator=generator))
            e = torch.zeros_like(values)
            e[coord] = 1.0
            g = (scalar(values + fd_eps * e) - scalar(values - fd_eps * e)) / (2 * fd_eps)
            direction = -float(np.sign(g))
            scale = max(abs(float(values[coord])), 1e-2)
            candidates = values[None, :] + (direction * scale * steps)[:, None] * e[None, :]
            if bounds is not None:
                lo, hi = (torch.as_tensor(b, dtype=torch.float64) for b in bounds)
                candidates = torch.minimum(torch.maximum(candidates, lo), hi)
            losses = _finite_or_inf(loss_fn(candidates)).cpu()
            best = int(torch.argmin(losses))
            if float(losses[best]) < history[-1]:
                values = candidates[best]
                history.append(float(losses[best]))
            else:
                history.append(history[-1])
    return values, history


def gradient_refine_kpp(loss_fn: Callable, values0, bounds: tuple, n_iters: int = 100, learning_rate: float = 0.02):
    """Projected adam with exact gradients through the KPP solve; returns ``(values, history)``.

    In box-normalised units ``theta = (v - lo) / (hi - lo)`` clipped to
    [0, 1] after each update, so one learning rate fits parameters whose
    scales span [0.01, 8]; a degenerate box (``lo == hi``) pins its
    coordinate with a zero gradient. Returns the best EVALUATED iterate (the
    history is the raw, non-monotone adam trace: its minimum is the returned
    values' loss), as ``train/mpp_calibration.py::optimise_mpp_parameters``
    does. On the card the gradient runs through the Thomas kernel's
    implicit-function-theorem backward (``ops/tridiagonal.py::_ImplicitSolve``).
    """
    lo, hi = (torch.as_tensor(b, dtype=torch.float64) for b in bounds)
    values = torch.as_tensor(values0, dtype=torch.float64).detach().cpu()
    span = hi - lo
    safe_span = torch.where(span > 0, span, torch.ones_like(span))
    theta = torch.clamp((values - lo) / safe_span, 0.0, 1.0)
    if n_iters == 0:
        with torch.no_grad():
            return lo + span * theta, [float(loss_fn(lo + span * theta))]
    theta.requires_grad_(True)
    # torch's Adam with optax's defaults computes optax.adam's update.
    optimizer = torch.optim.Adam([theta], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    history, best_loss, best_theta = [], float("inf"), theta.detach().clone()
    for _ in range(n_iters):
        before = theta.detach().clone()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(lo + span * theta)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            theta.clamp_(0.0, 1.0)
        history.append(float(loss.detach()))
        if history[-1] < best_loss:
            best_loss, best_theta = history[-1], before
    return lo + span * best_theta, history


def calibrate_kpp(ds: ColumnTimeSeries, tsteps, Nz: int, generator: torch.Generator | None = None,
                  priors: dict | None = None, n_plugin: int = 128, n_line_search: int = 30,
                  base_params: KPPParameters | None = None, n_substeps: int = 1,
                  refine: str = "line-search") -> tuple[KPPParameters, dict]:
    """Plugin search, then refinement; returns the calibrated :class:`KPPParameters` and an info dict.

    ``refine="line-search"`` is the reference's recipe (``train_kpp.jl:212-249``);
    ``"gradient"`` is :func:`gradient_refine_kpp`. ``generator`` (seed 0 by
    default) draws the plugin candidates, then the line search's
    coordinates. ``info["final_loss"]`` is the loss of the adopted
    parameters: both refiners return their best evaluated iterate.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    priors = priors if priors is not None else dict(DEFAULT_PRIORS)
    names = tuple(priors.keys())
    base = base_params if base_params is not None else KPPParameters.default(device=ds.T.device)
    loss_fn = make_kpp_loss_fn(ds, tsteps, Nz, base, names, n_substeps)

    best_values, best_loss, _ = random_plugin(loss_fn, priors, n_plugin, generator)
    lo = [priors[n][0] for n in names]
    hi = [priors[n][1] for n in names]
    if refine == "gradient":
        values, history = gradient_refine_kpp(loss_fn, best_values, (lo, hi), n_iters=n_line_search)
    elif refine == "line-search":
        values, history = random_line_search(loss_fn, best_values, generator, n_iters=n_line_search,
                                             bounds=(lo, hi))
    else:
        raise ValueError(f"unknown refine method {refine!r} (line-search | gradient)")
    values = values.to(ds.T.device)
    calibrated = _with_overrides(base, names, [values[i] for i in range(len(names))])
    info = {"names": names, "values": values, "plugin_best_loss": float(best_loss), "final_loss": min(history),
            "history": history}
    return calibrated, info
