"""Training-results report: the one-call evaluation orchestrator.

Port of the JAX package's ``eval/report.py`` (the reference's
``animate_training_results``, ``wind_mixing/src/animation.jl:832-962``):
plot the training-loss history, solve the held-out simulation with an
explicit ("rk4") and an operator-split ("split") integrator through
:func:`eval.profile.nde_profile` (the embedded host-column pair with the
first), and assemble the comparison animation. The split solves and the
host column run their implicit steps on the Thomas kernel on the card.

Figures need matplotlib, which the card's machine does not have: there the
report writes every array and the summary, and names the figures it did
not draw in one line on stderr (``animate=True`` raises instead).
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import numpy as np

from climateparameterizations_jl_tpu_torch.eval.profile import nde_profile

NO_MATPLOTLIB = "matplotlib cannot be imported"


def animations_or_none():
    """The port's ``eval/animations.py``, or ``None`` where matplotlib cannot be imported."""
    try:
        return importlib.import_module("climateparameterizations_jl_tpu_torch.eval.animations")
    except ImportError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        return None


def report_undrawn(names) -> None:
    """One line on stderr naming the figures that were not drawn for want of matplotlib."""
    if names:
        print(f"figures not drawn ({NO_MATPLOTLIB}): {', '.join(names)}", file=sys.stderr, flush=True)


def training_report(
    model,
    nns,
    ds_test,
    tsteps,
    output_dir: str,
    *,
    history: list | None = None,
    solvers=("rk4", "split"),
    n_substeps: int = 4,
    include_embedded: bool = True,
    animate: bool = True,
    gif_stride: int = 4,
    animation_format: str = "gif",
) -> dict:
    """Produce the post-training report for one held-out simulation.

    ``history``: per-iteration records (dicts with a ``loss`` key), e.g. a
    run's ``history.jsonl``. Writes ``profile_<solver>.npz`` and
    ``summary.json`` (the time-mean T loss of each member and solver), and
    the figures ``training_loss.png``, ``loss_<solver>.png`` and, with
    ``animate``, ``comparison.<animation_format>`` of the first solver.
    Returns ``{name: filepath}`` with the ``summary`` dict.
    """
    anim = animations_or_none()
    if anim is None and animate:
        raise RuntimeError(f"training_report(animate=True) draws comparison.{animation_format}, and {NO_MATPLOTLIB}")
    os.makedirs(output_dir, exist_ok=True)
    outputs: dict = {}
    undrawn: list = []

    if history:
        totals = [rec.get("loss", rec.get("T", np.nan)) for rec in history]
        path = os.path.join(output_dir, "training_loss.png")
        if anim is None:
            undrawn.append(os.path.basename(path))
        else:
            outputs["training_loss"] = anim.plot_epoch_loss(np.asarray(totals, dtype=np.float64), path)

    members = ("nde", "mpp", "kpp", "embedded", "embedded_baseline")
    summary: dict = {}
    for solver in solvers:
        ev = nde_profile(model, nns, ds_test, tsteps, solver=solver, n_substeps=n_substeps,
                         include_embedded=include_embedded and solver == solvers[0])
        tag = f"profile_{solver}"
        np.savez(os.path.join(output_dir, f"{tag}.npz"), **ev.to_dict())
        outputs[tag] = os.path.join(output_dir, f"{tag}.npz")
        path = os.path.join(output_dir, f"loss_{solver}.png")
        if anim is None:
            undrawn.append(os.path.basename(path))
        else:
            outputs[f"loss_{solver}"] = anim.plot_loss(
                {m: ev[f"losses_{m}_T"] for m in members if f"losses_{m}_T" in ev.keys()}, ev["t"], path)
        for m in members:
            if f"losses_{m}_T" in ev.keys():
                summary[f"{m}_{solver}"] = float(np.mean(ev[f"losses_{m}_T"]))
        if animate and solver == solvers[0]:
            outputs["comparison"] = anim.animate_profiles_fluxes_comparison(
                ev, os.path.join(output_dir, f"comparison.{animation_format}"), stride=gif_stride)

    outputs["summary"] = summary
    with open(os.path.join(output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    report_undrawn(undrawn)
    return outputs
