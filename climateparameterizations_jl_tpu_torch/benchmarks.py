"""Forward benchmark of the port on the card.

Port of ``climateparameterizations_jl_tpu/benchmarks.py:192``
(``bench_nde_forward``): the flagship wind-mixing model, 1,024 columns x
1,024 RK4 steps, through the fused runner, i.e. the hand-written CUDA
kernel ``csrc/fused_rk4.cu``. Timed with CUDA events after one warm-up
call. Runs on the card only: with no card it raises.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import wind_mixing_mlp
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    BoundaryConditions,
    FluxNNs,
    WindMixingModel,
    WindMixingScalings,
)
from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fused_runner_mxu
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

FORWARD_DT = 1e-5  # non-dimensional step of the JAX package's forward benchmark


def make_setup(Nz: int = 32, n_columns: int = 1024, seed: int = 0, nns=None, device=None):
    """``(model, nns, bcs, x0)``: the flagship configuration of ``__graft_entry__._make_setup``.

    The constants are the JAX package's; the flux MLPs are ``nns`` when
    given, else drawn from a ``torch.Generator`` seeded with ``seed`` (at the
    JAX setup's 1e-5 weight scale). ``x0`` is ``0.1 N(0, 1)`` from a numpy
    generator seeded with ``seed``.
    """
    device = resolve_device(device)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    sc = lambda m, s: ZeroMeanUnitVarianceScaling(f(m), f(s))  # noqa: E731
    scalings = WindMixingScalings(
        u=sc(0.0, 0.05), v=sc(0.0, 0.05), T=sc(19.0, 0.5),
        uw=sc(0.0, 1e-4), vw=sc(0.0, 1e-4), wT=sc(0.0, 1e-5),
    )
    model = WindMixingModel(
        H=f(256.0), tau=f(691200.0), f=f(1e-4), g=f(9.80665), alpha=f(2e-4),
        kappa=f(10.0), scalings=scalings, mpp=MPPParameters.default(torch.float32, device), Nz=Nz,
    )
    if nns is None:
        gen = torch.Generator().manual_seed(seed)
        nns = FluxNNs(*(wind_mixing_mlp(gen, Nz, scale=1e-5, device=device) for _ in range(3)))
    z = f(0.0)
    bcs = BoundaryConditions(uw_bot=z, uw_top=f(-0.5), vw_bot=z, vw_top=z, wT_bot=z, wT_top=f(0.3))
    x0 = np.random.default_rng(seed).normal(size=(n_columns, 3 * Nz)) * 0.1
    return model, nns, bcs, torch.tensor(x0, dtype=torch.float32, device=device)


def bench_nde_forward(n_columns: int = 1024, Nz: int = 32, n_steps: int = 1024, repeats: int = 5,
                      nns=None, seed: int = 0, device=None) -> dict:
    """Time the fused forward solve; returns ms (min/median/max) and column-timesteps/s.

    ``calls`` is the number of runner calls made (warm-up included), each
    one kernel launch.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_nde_forward times the CUDA kernel; it needs a card")
    model, nns, bcs, x0 = make_setup(Nz, n_columns, seed, nns, device)
    run = make_fused_runner_mxu(model, nns, bcs, FORWARD_DT, n_steps, n_columns, device=device)
    out = run(x0)  # warm-up: builds and loads the kernel on first use
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(x0)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("forward solve produced non-finite values")
    median = statistics.median(times)
    return {
        "device": torch.cuda.get_device_name(device),
        "n_columns": n_columns, "n_steps": n_steps, "repeats": repeats,
        "ms": times, "ms_min": min(times), "ms_median": median, "ms_max": max(times),
        "column_timesteps_per_sec": n_columns * n_steps / (median * 1e-3),
        "calls": repeats + 1,
    }
