"""Device selection: the card unless the caller asks for the CPU.

There is no fallback. An entry point given ``device=None`` runs on
``cuda`` and raises where no card is present, so a run that was meant for
the card never quietly measures the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` for ``None``; otherwise ``device`` as given.

    A CUDA device without an index gets the current one (``cuda:0``), the
    device its tensors report, so that device comparisons hold. Raises
    ``RuntimeError`` when a CUDA device is asked for (or implied by
    ``None``) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
