"""Shared physical constants and the diurnal surface-flux cycle.

Port of ``climateparameterizations_jl_tpu/core/constants.py``: one
definition of the sinusoidal daily forcing ``Q(t) = amplitude * sin(2 pi t
/ day)`` (reference ``wind_mixing/src/data_containers.jl:131-156``).
"""

from __future__ import annotations

import math

import torch

SECONDS_PER_DAY = 86400.0


def diurnal_cycle(t):
    """``sin(2 pi t / day)`` for dimensional time ``t`` [s] (a tensor)."""
    return torch.sin(2.0 * math.pi * torch.as_tensor(t) / SECONDS_PER_DAY)
