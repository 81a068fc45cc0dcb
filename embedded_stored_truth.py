#!/usr/bin/env python3
"""The port's embedded evaluation on the stored JAX run's own truth.

    python3 embedded_stored_truth.py [--device cpu] [--out FILE]

``runs/wm_flagship_default_eval`` was written by the JAX package's
``evaluate --embedded`` of ``runs/wm_flagship_default`` on the three held-out
sims: 128 frames (every 9th of 1,152 saves of 600 s), 9 split substeps and 9
KPP steps per save, 10 host steps per save. Its ``evaluation_<sim>.npz``
files hold the truth it compared against (``truth_u/v/T`` and the truth
fluxes). This script runs the port's ``eval/profile.py::nde_profile`` with
``include_embedded`` on that truth, at that layout: each sim's constants
come from the port's stand-in of the sim, its profiles and fluxes from the
stored file, and the scaling context is the port's stand-in suite of the 18
training sims (the checkpoint's recorded sims). It prints, and writes to
``--out`` as JSON, each member's mean T loss per sim beside the stored
run's, so a gap between the card's phase 37 (the port's stand-ins) and the
stored summary can be split into the truth it is measured on and the rest.
Runs on the card unless ``--device cpu``; about a minute on either, most of
it generating the stand-in suite.

``--old-ri-rule`` runs the host column's mPP on the Richardson rule the JAX
host column had before its gradient-safe regularizer: ``1e-12`` added to
dT/dz alone and no floor on the shear, in place of ``1e-7`` on every
gradient and the ``1e-20`` shear floor. It tests whether that change
explains a gap of ``embedded`` to the stored run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
RUN, EVAL = REPO / "runs" / "wm_flagship_default", REPO / "runs" / "wm_flagship_default_eval"
TEST_SIMS = ("wind_-4.5e-4_cooling_2.5e-8", "wind_-2.5e-4_cooling_1.5e-8", "wind_-4.5e-4_heating_-2.5e-8")
N_SAVE, STRIDE, NZ = 1152, 9, 32
MEMBERS = ("nde", "mpp", "kpp", "embedded", "embedded_baseline")


def main() -> int:
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.eval.profile import nde_profile

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--out", default=None, help="write the losses here as JSON")
    parser.add_argument("--old-ri-rule", action="store_true",
                        help="the host column's Ri without the gradient-safe regularizer (see the docstring)")
    args = parser.parse_args()
    if args.old_ri_rule:
        _use_old_ri_rule()
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    nns, meta = cli._load_nns(str(RUN), device)
    names = cli._sims(meta["sims"])
    train = cli._load_suite(names, NZ, None, N_SAVE, 600.0, device=device)
    model = cli._wind_model(train, NZ, diurnal=bool(meta.get("diurnal", False)),
                            **cli._base_closure_overrides(meta.get("base_closure", "mpp")),
                            **cli._restore_mpp(meta, None, device))
    stand_ins = cli._load_suite(list(TEST_SIMS), NZ, None, N_SAVE, 600.0, device=device)
    stored = json.loads((EVAL / "summary.json").read_text())["per_sim"]
    out: dict = {"per_sim": {}, "stored": {m: stored[m] for m in MEMBERS}}
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    for k, name in enumerate(TEST_SIMS):
        with np.load(EVAL / f"evaluation_{name}.npz") as ev:
            truth = {f: ev[f"truth_{f}"] for f in ("u", "v", "T", "uw", "vw", "wT")}
            t = ev["t"]
        stand_in = cli._select_sims(stand_ins, k)
        gap = float(np.abs(stand_in.T[::STRIDE][: t.shape[0]].cpu().numpy() - truth["T"]).max())
        ds = dataclasses.replace(stand_in, t=f32(t), **{f: f32(v) for f, v in truth.items()})
        ev = nde_profile(model, nns, ds, np.arange(t.shape[0]), solver="split", n_substeps=STRIDE,
                         include_embedded=True, kpp_n_substeps=STRIDE)
        losses = {m: float(np.mean(ev[f"losses_{m}_T"])) for m in MEMBERS}
        out["per_sim"][name] = {"losses": losses, "stand_in_max_abs_T_gap": gap}
        print(f"{name}: the port's stand-in lies up to {gap:.4f} K from the stored truth; on the stored truth:")
        for m in MEMBERS:
            print(f"  {m}: port {losses[m]:.6e}, stored JAX run {stored[m][k]:.6e} "
                  f"(port / stored - 1 = {losses[m] / stored[m][k] - 1:+.4f})")
    means = {m: float(np.mean([out["per_sim"][n]["losses"][m] for n in TEST_SIMS])) for m in MEMBERS}
    out["mean"] = means
    print("mean over the sims: " + ", ".join(
        f"{m} {means[m]:.6e} against {np.mean(stored[m]):.6e} ({means[m] / np.mean(stored[m]) - 1:+.4f})"
        for m in MEMBERS))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2))
    return 0


def _use_old_ri_rule():
    """Replace the host column's diffusivities with the mPP rule of ``Ri = g alpha (dT/dz + 1e-12) / S^2``."""
    from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
    from climateparameterizations_jl_tpu_torch.embed import column_model
    from climateparameterizations_jl_tpu_torch.physics.mpp import mpp_diffusivity
    from climateparameterizations_jl_tpu_torch.physics.richardson import sanitize_richardson

    new_rule = column_model._diffusivities

    def diffusivities(model, state):
        if model.closure != "mpp":
            return new_rule(model, state)
        dudz = d_center_to_face(state.u, model.dz)
        dvdz = d_center_to_face(state.v, model.dz)
        dTdz = d_center_to_face(state.T, model.dz) + 1e-12
        Ri = sanitize_richardson(model.g * model.alpha * dTdz / (dudz**2 + dvdz**2))
        nu = mpp_diffusivity(Ri, model.mpp)
        kappa = nu / model.mpp.Pr
        if model.mpp_conv_adjust:
            kappa = torch.where(Ri > 0.0, kappa, model.kappa_conv)
        return nu, kappa

    column_model._diffusivities = diffusivities


if __name__ == "__main__":
    raise SystemExit(main())
