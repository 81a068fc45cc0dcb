"""Port parity at flagship size: the trained ensembles and closures of ``runs/`` across the packages.

Each package loads the trained stacked ensembles (``runs/wm_flagship_ens4``,
``wm_flagship_ens8``, ``wm_les_composed_fold``) to the same numbers. Then, on
2 of the 18 flagship sims generated by the JAX package and handed over
through numpy (the first half of the flagship window, 65 saves x 9 split
substeps: the whole window cost about 45 s of one process, most of it JAX
compiling, and four times that under the six loaded workers; Nz = 32),
each package's loss over a trained checkpoint, on its ``meta["mpp"]`` base:
the folded K = 4 ensembles, and their single-member twins
``runs/wm_flagship_fold`` and ``runs/wm_les_shoot16`` (the latter on its
16-window multiple-shooting batch). Loss only, with fixed channel weights.

Tolerances: ``RTOL = 1e-9`` in float64 (the same operations in the same
order); in float32 the two packages sum in other orders through the substeps
(measured 0 to 7.3e-6), held to ``F32_RTOL = 1e-4``.
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.train import deep_ensemble as jde
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.train import checkpoint as tck
from climateparameterizations_jl_tpu_torch.train import deep_ensemble as tde
from climateparameterizations_jl_tpu_torch.train import nde as tnde

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
REPO = Path(__file__).resolve().parents[1]
RTOL, F32_RTOL = 1e-9, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the folded losses' small matmuls lose more to thread hand-offs on a
    loaded CPU than threads gain (the K = 4 cases ran about 4x faster on one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


@pytest.mark.parametrize("run", ["wm_flagship_ens4", "wm_flagship_ens8", "wm_les_composed_fold"])
def test_load_run_reads_trained_ensembles(run):
    tnns, tmeta = tck.load_run(str(REPO / "runs" / run), "cpu")
    jnns, jmeta = jcli._load_nns(str(REPO / "runs" / run))
    assert tmeta == jmeta and tde.ensemble_size(tnns) == jmeta["ensemble"]
    for p, q in zip(tnde.nn_parameters(tnns), jax.tree.leaves(jnns)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))


FLAGSHIP_SIMS = ("wind_-5e-4_cooling_3e-8_new", "wind_-2e-4_heating_-1e-8_new")
FLAGSHIP_WINDOW, FLAGSHIP_STRIDE = 577, 9  # 65 saves x 9 substeps = 576 split substeps: half the flagship window


@pytest.fixture(scope="module")
def flagship_data():
    """2 of the flagship sims, generated by the JAX package (f32) and handed over."""
    return jcli._load_suite(list(FLAGSHIP_SIMS), 32, None, FLAGSHIP_WINDOW - 1, 600.0)


@pytest.mark.parametrize("run", ["wm_flagship_ens4", "wm_les_composed_fold"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flagship_size_folded_loss_matches_jax(flagship_data, run, dtype):
    """The folded-ensemble loss over a trained K = 4 ensemble (its meta["mpp"] base), 1,152 substeps."""
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32, torch.float32)
    jnns, meta = jcli._load_nns(str(REPO / "runs" / run))
    ds = jax.tree.map(lambda a: jnp.asarray(a, jdt) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
                      flagship_data)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)  # noqa: E731
    jmodel = cast(jcli._wind_model(ds, 32, **jcli._restore_mpp(meta)))
    jnns = cast(jnns)
    tsteps = np.arange(0, FLAGSHIP_WINDOW, FLAGSHIP_STRIDE)
    jb = jc.training_tensors(ds, jmodel.scalings, tsteps, tau=jmodel.tau)
    # Fixed channel weights (no auto-balance pre-solve): the loss alone, one folded solve per package.
    config = dict(n_substeps=FLAGSHIP_STRIDE, method="split")
    jconf, tconf = jnde.NDETrainConfig(**config), tnde.NDETrainConfig(**config)
    jloss, _ = jde.make_folded_ensemble_loss_fn(jmodel, jb, jde.ensemble_loss_scalings(jmodel, jnns, jb, jconf),
                                                jconf)(jnns)
    tmodel, tnns = from_reference(jmodel, "cpu", tdt), from_reference(jnns, "cpu", tdt)
    tb = tc.training_tensors(_to_torch(ds), tmodel.scalings, tsteps, tau=tmodel.tau)
    with torch.no_grad():
        tloss, _ = tde.make_folded_ensemble_loss_fn(tmodel, tb, tde.ensemble_loss_scalings(tmodel, tnns, tb, tconf),
                                                    tconf)(tnns)
    rel = abs(float(tloss) - float(jloss)) / abs(float(jloss))
    print(f"{run} {dtype}: loss port {float(tloss)!r} JAX {float(jloss)!r} rel {rel:.3e}")
    assert np.isfinite(float(tloss)) and rel <= (RTOL if dtype == "float64" else F32_RTOL), rel


@pytest.mark.parametrize("run,shooting", [("wm_flagship_fold", 0), ("wm_les_shoot16", 16)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flagship_size_solo_loss_matches_jax(flagship_data, run, shooting, dtype):
    """The single-member twin: the loss of a trained MLP triple over its meta["mpp"] base, 1,152 substeps (the
    plain batch), or 16 windows of 72 substeps each (``runs/wm_les_shoot16``'s multiple-shooting batch)."""
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32, torch.float32)
    jnns, meta = jcli._load_nns(str(REPO / "runs" / run))
    ds = jax.tree.map(lambda a: jnp.asarray(a, jdt) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
                      flagship_data)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)  # noqa: E731
    jmodel, jnns = cast(jcli._wind_model(ds, 32, **jcli._restore_mpp(meta))), cast(jnns)
    tmodel, tnns = from_reference(jmodel, "cpu", tdt), from_reference(jnns, "cpu", tdt)
    tsteps = np.arange(0, FLAGSHIP_WINDOW, FLAGSHIP_STRIDE)
    tds = _to_torch(ds)
    if shooting:
        jb = jc.multiple_shooting_tensors(ds, jmodel.scalings, tsteps, shooting, tau=jmodel.tau)
        tb = tc.multiple_shooting_tensors(tds, tmodel.scalings, tsteps, shooting, tau=tmodel.tau)
    else:
        jb = jc.training_tensors(ds, jmodel.scalings, tsteps, tau=jmodel.tau)
        tb = tc.training_tensors(tds, tmodel.scalings, tsteps, tau=tmodel.tau)
    config = dict(n_substeps=FLAGSHIP_STRIDE, method="split")
    jconf, tconf = jnde.NDETrainConfig(**config), tnde.NDETrainConfig(**config)
    jloss, _ = jnde.make_wind_mixing_loss_fn(jmodel, jb, jnde.determine_loss_scalings(jmodel, jnns, jb, jconf),
                                             jconf)(jnns)
    with torch.no_grad():
        tloss, _ = tnde.make_wind_mixing_loss_fn(tmodel, tb, tnde.determine_loss_scalings(tmodel, tnns, tb, tconf),
                                                 tconf)(tnns)
    rel = abs(float(tloss) - float(jloss)) / abs(float(jloss))
    print(f"{run} {dtype}: loss port {float(tloss)!r} JAX {float(jloss)!r} rel {rel:.3e}")
    assert np.isfinite(float(tloss)) and rel <= (RTOL if dtype == "float64" else F32_RTOL), rel
