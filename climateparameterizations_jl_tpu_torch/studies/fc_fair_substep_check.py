"""Recompute the free-convection held-out KPP / TKE baselines at fair substepping from the saved eval npz.

Port of ``studies/fc_fair_substep_check.py``. The truth trajectories in
``runs/fc_les3d_eval/sim{8,9}.npz`` were generated by the 3-D LES; the KPP and
TKE baselines need only ``truth_T[0]``, the registry constants and the
checkpoints' scalings, so they are re-run here.

Step 1 validates the reconstruction by reproducing the stored (unfair,
``n_substeps=1``) losses within 5e-3; step 2 computes the fair ones
(``n_substeps=8``, dt = 600 s).

The solve's precision: the JAX script loads the truth in f64
under x64 and builds its constants in f32, so its solves run in f64 with
f32-rounded constants. With ``--device cpu`` the port does the same, on the
plain scan. On the card the solves run in f32: the truth is
handed to the solves in f32, so every KPP and TKE step is one launch of the
Thomas kernel ``csrc/thomas.cu`` (f32-only). The f32 solves carry T as its
anomaly from the initial column mean (``T_shift``, added back before the
losses): KPP and TKE read T only through its differences (gradients,
buoyancy differences, fluxes), so the shift changes nothing but the
rounding, and an f32 column near 19 K with 4,800 s implicit steps loses the
digits the reconstruction check needs (unshifted f32 misses the stored TKE
losses by 0.66 % on the card and 1.1 % on the CPU; shifted f32 lands within
4e-4 of the f64 solve). The JAX script's f64 solve on the plain scan is
recorded beside the f32 run in each record's ``f64_scan``, and the f32 run on
T itself (the way the port's other f32 KPP / TKE paths solve) in
``f32_absolute_T``. Every record carries its ``dtype``, ``tridiag_backend``
and ``T_shift``.

The baselines depend only on (sim, n_substeps): both eval directories hold
the same truth, so each is solved once and reused across the two checkpoints
(2 sims x (143 + 1,144) steps, one KPP and one TKE launch each: 5,148 Thomas
launches on the card for the f32 run). ``runs/`` is read from this
repository's root, wherever it lies.

    python -m climateparameterizations_jl_tpu_torch.studies.fc_fair_substep_check
    python -m climateparameterizations_jl_tpu_torch.studies.fc_fair_substep_check --device cpu --out fair.npy
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.device import resolve_device

RUNS = Path(__file__).resolve().parents[2] / "runs"
F_COR, G, ALPHA, H = 1e-4, 9.80665, 2e-4, 256.0
SYN = {8: (7.5e-8, 1e-3), 9: (1e-7, 1e-3)}
NZ = 32
CHECKPOINTS = (("fc_les3d", "fc_les3d_eval"), ("fc_les3d_conv", "fc_les3d_conv_eval"))
DTYPES = {"f32": torch.float32, "f64": torch.float64}
RECONSTRUCTION_RTOL = 5e-3


def run_baselines(truth_T0, t_dim, zf, zc, sim_id, n_substeps, dtype=torch.float32, tridiag_backend: str = "auto"):
    """``(kpp, kpp_wT, tke, tke_wT)`` of sim ``sim_id`` from ``truth_T0``, on the device of ``truth_T0``.

    The constants are built in ``dtype`` (the JAX script's default f32) and
    the solve runs in the promoted dtype of the truth; ``tridiag_backend``
    is each step's implicit solve (``auto``: the Thomas kernel on the card).
    """
    from climateparameterizations_jl_tpu_torch.physics.kpp import (
        KPPForcing,
        KPPParameters,
        KPPState,
        kpp_diagnostic_fluxes,
        solve_kpp,
    )
    from climateparameterizations_jl_tpu_torch.physics.tke import (
        TKEParameters,
        TKEState,
        solve_tke,
        tke_diagnostic_heat_flux,
    )

    device = truth_T0.device
    Qb, strat = SYN[sim_id]
    d = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    zeros = torch.zeros_like(truth_T0)
    kpp_params, tke_params = KPPParameters.default(dtype, device), TKEParameters.default(dtype, device)
    forcing = KPPForcing(Fu=d(0.0), Fb=d(Qb), dTdz_bottom=d(strat))
    kpp = solve_kpp(
        KPPState(U=zeros, V=zeros, T=truth_T0), t_dim, kpp_params, forcing, d(H), NZ, d(F_COR), d(G), d(ALPHA),
        n_substeps=n_substeps, tridiag_backend=tridiag_backend,
    )
    _, _, kpp_wT = kpp_diagnostic_fluxes(kpp.U, kpp.V, kpp.T, d(zf), d(zc), kpp_params, forcing, d(G), d(ALPHA),
                                         d(H), NZ)
    tke = solve_tke(
        TKEState(U=zeros, V=zeros, T=truth_T0, e=torch.full_like(zeros, 1e-6)), t_dim, tke_params, d(0.0), d(Qb),
        d(H), NZ, d(F_COR), d(G), d(ALPHA), n_substeps=n_substeps, tridiag_backend=tridiag_backend,
    )
    tke_wT = tke_diagnostic_heat_flux(tke, d(H / NZ), tke_params, d(Qb), d(G), d(ALPHA))
    return kpp, kpp_wT, tke, tke_wT


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def check_losses(runs=RUNS, device=None, solve_dtype=torch.float64, tridiag_backend: str = "auto",
                 with_arrays: bool = True, absolute_T: bool = False) -> dict:
    """``{checkpoint: {sim: record}}``: the stored check and the fair losses, with the truth in ``solve_dtype``.

    Raises ``AssertionError`` where a reconstructed loss lies 5e-3 or more
    (relative) from the stored one. ``absolute_T`` solves on T itself, as
    the port's other f32 KPP / TKE paths do (a measurement of their f32 gap:
    no shift and no raise).
    """
    runs, out, baseline_cache = Path(runs), {}, {}
    for ckpt, eval_dir in CHECKPOINTS:
        sc = json.loads((runs / ckpt / "meta.json").read_text())["scalings"]["T"]
        T_scaling = ZeroMeanUnitVarianceScaling(torch.tensor(sc["mu"], dtype=torch.float64, device=device),
                                                torch.tensor(sc["sigma"], dtype=torch.float64, device=device))
        res = {}
        for sim in (8, 9):
            z = np.load(runs / eval_dir / f"sim{sim}.npz")
            t_dim = torch.as_tensor(z["t"], dtype=solve_dtype, device=device)
            truth = torch.as_tensor(z["truth_T"], dtype=torch.float64, device=device)
            shift = float(truth[0].mean()) if solve_dtype == torch.float32 and not absolute_T else 0.0
            truth_T = (truth - shift).to(solve_dtype)
            truth_scaled = T_scaling.scale(truth)
            losses = lambda a: torch.mean((T_scaling.scale(a.double() + shift) - truth_scaled) ** 2, dim=-1)  # noqa: E731
            rec = {"dtype": str(solve_dtype).removeprefix("torch."), "tridiag_backend": tridiag_backend,
                   "T_shift": shift}
            for tag, nsub in (("stored_check", 1), ("fair", 8)):
                if (sim, nsub) not in baseline_cache:
                    # zf/zc come from the npz the eval itself wrote, so the flux diagnostics are pinned to the grid
                    # convention of the data they describe.
                    baseline_cache[(sim, nsub)] = run_baselines(truth_T[0], t_dim, z["zf"], z["zc"], sim, nsub,
                                                                tridiag_backend=tridiag_backend)
                kpp, kpp_wT, tke, tke_wT = baseline_cache[(sim, nsub)]
                rec[tag] = {"kpp": float(torch.mean(losses(kpp.T))), "tke": float(torch.mean(losses(tke.T)))}
                if tag == "fair" and with_arrays:
                    rec["fair_arrays"] = dict(
                        kpp_T=_np(kpp.T.double() + shift), kpp_wT=_np(kpp_wT), tke_T=_np(tke.T.double() + shift),
                        tke_wT=_np(tke_wT), losses_kpp_T=_np(losses(kpp.T)), losses_tke_T=_np(losses(tke.T)),
                    )
            rec["stored"] = {"kpp": float(np.mean(z["losses_kpp_T"])), "tke": float(np.mean(z["losses_tke_T"]))}
            # The fair numbers are only trustworthy if the npz-only reconstruction reproduces the stored unfair
            # ones (an explicit raise, not an assert, so -O cannot strip it).
            for m in ("kpp", "tke"):
                rel = abs(rec["stored_check"][m] / rec["stored"][m] - 1.0)
                rec.setdefault("stored_check_rel", {})[m] = rel
                if not (rel < RECONSTRUCTION_RTOL or absolute_T):
                    raise AssertionError(f"reconstruction mismatch for {m} (sim{sim}, {rec['dtype']}): {rel:.2%}")
            rec["stored_full"] = {"nde": float(np.mean(z["losses_nde_T"])),
                                  "conv_adj": float(np.mean(z["losses_conv_adj_T"]))}
            res[sim] = rec
        out[ckpt] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' runs on the CPU)")
    ap.add_argument("--out", default="fc_fair_substep_result.npy", help="the records and fair arrays (numpy pickle)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # f32 on the card (every step on the Thomas kernel, which is f32-only), f64 on the plain scan elsewhere (as JAX).
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    backend = "auto" if dtype == torch.float32 else "scan"

    from climateparameterizations_jl_tpu_torch.ops import _cuda

    launches = _cuda.THOMAS.launches
    out = check_losses(device=device, solve_dtype=dtype, tridiag_backend=backend)
    launches = _cuda.THOMAS.launches - launches
    if dtype == torch.float32:
        f64 = check_losses(device=device, solve_dtype=torch.float64, tridiag_backend="scan", with_arrays=False)
        absolute = check_losses(device=device, solve_dtype=dtype, tridiag_backend=backend, with_arrays=False,
                                absolute_T=True)
        for ckpt, res in out.items():
            for sim, rec in res.items():
                for key, other in (("f64_scan", f64), ("f32_absolute_T", absolute)):
                    rec[key] = {k: other[ckpt][sim][k] for k in ("stored_check", "fair", "stored_check_rel")}
    for ckpt, res in out.items():
        for sim, rec in res.items():
            print(f"{ckpt} sim{sim}: stored kpp={rec['stored']['kpp']:.4e} tke={rec['stored']['tke']:.4e} | "
                  f"recon@1 kpp={rec['stored_check']['kpp']:.4e} tke={rec['stored_check']['tke']:.4e} | "
                  f"fair@8 kpp={rec['fair']['kpp']:.4e} tke={rec['fair']['tke']:.4e} ({rec['dtype']}, "
                  f"{rec['tridiag_backend']})" + (
                      f" | f64 scan recon@1 kpp={rec['f64_scan']['stored_check']['kpp']:.4e} "
                      f"tke={rec['f64_scan']['stored_check']['tke']:.4e} fair@8 "
                      f"kpp={rec['f64_scan']['fair']['kpp']:.4e} tke={rec['f64_scan']['fair']['tke']:.4e}"
                      if "f64_scan" in rec else "") + (
                      " | f32 on absolute T recon@1 rel kpp={kpp:.3e} tke={tke:.3e}".format(
                          **rec["f32_absolute_T"]["stored_check_rel"]) if "f32_absolute_T" in rec else ""), flush=True)
    print(f"thomas launches ({str(dtype).removeprefix('torch.')} run): {launches}", flush=True)
    np.save(args.out, out, allow_pickle=True)
    print("DONE")
    return out


if __name__ == "__main__":
    main()
