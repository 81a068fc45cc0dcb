"""Port parity: the free-convection fair-substep check (``studies/fc_fair_substep_check.py``) against its port.

``run_baselines`` of both on the first 49 frames of
``runs/fc_les3d_eval/sim8.npz``, the truth in f64, on the plain scan, with
the constants in f64 at 1 substep (4,800 s steps) and in the JAX script's
default f32 (promoted by the f64 truth, as its ``main`` runs) at 8:

- the KPP and TKE temperature and velocity trajectories to ``TRAJ_RTOL =
  1e-7`` of T's scale. Both packages run the same f64 operations, but they
  evaluate powers and hyperbolic functions and sum in other orders, and the
  long implicit steps amplify those last-bit differences: measured 3.4e-10
  (KPP) and 5.1e-8 (TKE) of T's scale after 48 steps of 4,800 s, while one
  step agrees to 1.6e-11. So 1e-10 over the 49 frames does not hold;
- the diagnostic heat fluxes and the TKE field to ``FLUX_RTOL = 1e-3`` of
  their scale: they are differences of nearly equal temperatures times large
  diffusivities, and the TKE field sits at its floor where production and
  dissipation nearly cancel (measured up to 1.8e-5 for KPP's flux, 1.3e-4 for
  TKE's and 2.7e-4 for the TKE field).

The full check (``main``) runs on the CPU in f64 and must reproduce the JAX
script's printed losses (4 digits: ``rtol = 5e-5``), the stored ones within
its own 5e-3, and every record key.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch.studies import fc_fair_substep_check as tfc

TRAJ_RTOL, FLUX_RTOL = 1e-7, 1e-3
FRAMES = 49


@pytest.fixture(scope="module")
def jfc():
    # The JAX script switches x64 on (and the CPU platform) at import, as the test configuration already does.
    assert jax.config.jax_enable_x64
    return importlib.import_module("studies.fc_fair_substep_check")


@pytest.fixture(scope="module")
def sim8():
    z = np.load(tfc.RUNS / "fc_les3d_eval" / "sim8.npz")
    return {k: z[k] for k in ("t", "truth_T", "zf", "zc")}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("n_substeps,constants", [(1, "float64"), (8, "float32")])
def test_run_baselines_matches_jax(jfc, sim8, n_substeps, constants):
    import jax.numpy as jnp

    t, T = sim8["t"][:FRAMES], sim8["truth_T"][:FRAMES]
    jk, jkw, jt, jtw = jfc.run_baselines(jnp.asarray(T[0], jnp.float64), jnp.asarray(t, jnp.float64), sim8["zf"],
                                         sim8["zc"], 8, n_substeps, dtype=getattr(jnp, constants))
    tk, tkw, tt, ttw = tfc.run_baselines(torch.tensor(T[0], dtype=torch.float64), torch.tensor(t, dtype=torch.float64),
                                         sim8["zf"], sim8["zc"], 8, n_substeps, dtype=getattr(torch, constants))
    assert tk.T.dtype == torch.float64  # f32 constants are promoted by the f64 truth, as in JAX
    for got, want in ((tk.T, jk.T), (tk.U, jk.U), (tt.T, jt.T), (tt.U, jt.U)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TRAJ_RTOL * float(np.abs(jk.T).max()))
    for got, want in ((tkw, jkw), (tt.e, jt.e), (ttw, jtw)):
        _close(got.numpy(), want, FLUX_RTOL)
    assert tk.T.shape == (FRAMES, 32)
    assert float((tk.T[-1] - tk.T[0]).abs().max()) > 1e-3  # the column evolved


def test_f32_solve_on_the_kernel_backend_is_its_plain_version(sim8):
    """On CPU tensors the kernel backend runs _thomas_scan; in f32 it equals the scan-backed run bit for bit."""
    t = torch.tensor(sim8["t"][:FRAMES])
    T0 = torch.tensor(sim8["truth_T"][0])
    a = tfc.run_baselines(T0, t, sim8["zf"], sim8["zc"], 8, 2, tridiag_backend="cuda")
    b = tfc.run_baselines(T0, t, sim8["zf"], sim8["zc"], 8, 2, tridiag_backend="scan")
    assert a[0].T.dtype == torch.float32
    for x, y in zip(a, b):
        x, y = (x, y) if isinstance(x, torch.Tensor) else (x.T, y.T)
        assert torch.equal(x, y)


def test_main_reproduces_the_jax_losses(tmp_path):
    """The full check on the CPU (f64, as JAX): JAX's printed losses, the stored check and every key."""
    out = tfc.main(["--device", "cpu", "--out", str(tmp_path / "fair.npy")])
    saved = np.load(tmp_path / "fair.npy", allow_pickle=True).item()
    assert set(saved) == set(out) == {"fc_les3d", "fc_les3d_conv"}
    # The JAX script's numbers on this CPU (f64, x64): its printed 4-digit losses.
    jax_printed = {8: {"stored_check": (1.4825e-1, 1.4907e-1), "fair": (1.4869e-1, 1.5171e-1)},
                   9: {"stored_check": (8.1964e-2, 8.4556e-2), "fair": (8.1534e-2, 8.7416e-2)}}
    jax_keys = {"stored_check", "fair", "fair_arrays", "stored", "stored_full"}
    for ckpt, res in out.items():
        assert set(res) == {8, 9}
        for sim, rec in res.items():
            assert jax_keys <= set(rec) and rec["dtype"] == "float64" and rec["tridiag_backend"] == "scan"
            assert set(rec["fair_arrays"]) == {"kpp_T", "kpp_wT", "tke_T", "tke_wT", "losses_kpp_T", "losses_tke_T"}
            for tag, (kpp, tke) in jax_printed[sim].items():
                np.testing.assert_allclose([rec[tag]["kpp"], rec[tag]["tke"]], [kpp, tke], rtol=5e-5)
            assert max(rec["stored_check_rel"].values()) < tfc.RECONSTRUCTION_RTOL
    assert out["fc_les3d"][9]["fair_arrays"]["kpp_T"].shape == (144, 32)


def _cut_runs(tmp_path, frames=5):
    """A copy of the two checkpoints and their eval files with the truth cut to its first ``frames`` frames."""
    import shutil

    runs = tmp_path / "runs"
    for ckpt, eval_dir in tfc.CHECKPOINTS:
        shutil.copytree(tfc.RUNS / ckpt, runs / ckpt)
        (runs / eval_dir).mkdir()
        for sim in (8, 9):
            z = dict(np.load(tfc.RUNS / eval_dir / f"sim{sim}.npz"))
            z["t"], z["truth_T"] = z["t"][:frames], z["truth_T"][:frames]
            np.savez(runs / eval_dir / f"sim{sim}.npz", **z)
    return runs


def test_reconstruction_mismatch_raises(tmp_path):
    """A stored loss the reconstruction cannot reproduce (here: the truth cut to 5 of its 144 frames, so the
    reconstructed mean covers another window) ends the run, never relabelled "fair"."""
    with pytest.raises(AssertionError, match="reconstruction mismatch"):
        tfc.check_losses(_cut_runs(tmp_path), device="cpu")


def test_absolute_T_measures_without_the_shift(tmp_path):
    """``absolute_T`` is the f32 solve on T itself, as the port's other f32 KPP / TKE paths run it: a measurement of
    their gap, recorded (``T_shift`` 0, the gaps in ``stored_check_rel``) where the check would raise."""
    out = tfc.check_losses(_cut_runs(tmp_path), device="cpu", solve_dtype=torch.float32, tridiag_backend="scan",
                           with_arrays=False, absolute_T=True)
    for res in out.values():
        for rec in res.values():
            assert (rec["dtype"], rec["T_shift"]) == ("float32", 0.0)
            assert max(rec["stored_check_rel"].values()) >= tfc.RECONSTRUCTION_RTOL  # the cut window, unraised


@pytest.mark.parametrize("n_substeps", [1, 8])
def test_f32_solves_carry_the_anomaly(sim8, n_substeps):
    """KPP and TKE read T only through differences: shifting the column by a constant changes only the rounding
    (f64: measured 2e-11 K in T, 2.5e-9 of the flux scale), and the f32 run on the anomaly stays within 1e-5 K (KPP)
    and 1e-3 K (TKE) of the f64 solve (measured 3.4e-6 and 2.8e-4 K), where f32 on the full 19 K column misses by
    up to 2.9e-3 K (KPP, 8 substeps) and 3.7e-3 K (TKE, 1 substep)."""
    t = torch.tensor(sim8["t"][:FRAMES], dtype=torch.float64)
    T = torch.tensor(sim8["truth_T"][:FRAMES], dtype=torch.float64)
    c = float(T[0].mean())
    ref = tfc.run_baselines(T[0], t, sim8["zf"], sim8["zc"], 8, n_substeps)
    shifted = tfc.run_baselines(T[0] - c, t, sim8["zf"], sim8["zc"], 8, n_substeps)
    f32 = tfc.run_baselines((T[0] - c).float(), t.float(), sim8["zf"], sim8["zc"], 8, n_substeps)
    for i in (0, 2):  # KPP, TKE states
        assert float((shifted[i].T + c - ref[i].T).abs().max()) < 1e-9
    for i in (1, 3):  # their heat fluxes
        _close(shifted[i].numpy(), ref[i].numpy(), 1e-7)
    assert float((f32[0].T.double() + c - ref[0].T).abs().max()) < 1e-5
    assert float((f32[2].T.double() + c - ref[2].T).abs().max()) < 1e-3
