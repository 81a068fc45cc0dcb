"""Prediction helper: run a closure over a dataset, scaled or unscaled.

Port of the JAX package's ``utils/predict.py`` (reference
``src/predict.jl:12-34``): apply a fitted model to every snapshot of a flux
dataset at once (one batched MLP or GP call) and return ``(prediction,
truth)``, optionally unscaled back to dimensional units.
"""

from __future__ import annotations

import torch


def predict(model_fn, x, y, unscale_fn=None):
    """Apply ``model_fn`` to all rows of ``x``; return ``(pred, truth)``.

    ``x``: ``(N, n_features)`` scaled inputs; ``y``: ``(N, n_out)`` scaled
    targets. With ``unscale_fn`` both outputs are mapped back to dimensional
    units (the ``scaled=false`` path of ``predict.jl:22-33``).
    """
    pred = model_fn(x)
    truth = torch.as_tensor(y)
    if unscale_fn is not None:
        pred = unscale_fn(pred)
        truth = unscale_fn(truth)
    return pred, truth
