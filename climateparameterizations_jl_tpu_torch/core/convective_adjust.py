"""Profile fixer: remove negative temperature gradients by sweeping downward.

Port of ``climateparameterizations_jl_tpu/core/convective_adjust.py``
(reference ``src/DataWrangling/convective_adjust.jl:6-16``): a top-down
sweep over the 1-based indices ``length(x)-3 : -1 : 2``. Each fix can
expose the next, so the sweep is a loop over levels; leading axes batch.

This is the data-wrangling fixer. The differentiable convective-adjustment
closures used inside NDEs live in ``physics/convective_adjustment.py``.
"""

from __future__ import annotations

import torch


def convective_adjust_profile(x) -> torch.Tensor:
    """A copy of profile(s) ``x`` (bottom to top on the LAST axis) with unstable kinks removed.

    Leading axes batch. The sweep indexes the level axis, never axis 0: a
    batched ``(B, n)`` input indexed on axis 0 would compare whole rows.
    """
    out = torch.as_tensor(x).clone()
    n = out.shape[-1]
    # Julia's i runs length(x)-3 down to 2 (1-based): 0-based n-4 down to 1.
    for i in range(n - 4, 0, -1):
        xi, xip, xim = out[..., i], out[..., i + 1], out[..., i - 1]
        new = torch.where(xim > xi, xip, 0.5 * (xim + xip))
        out[..., i] = torch.where(xi > xip, new, xi)
    return out
