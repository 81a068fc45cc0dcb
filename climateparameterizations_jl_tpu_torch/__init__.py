"""PyTorch/CUDA port of ``climateparameterizations_jl_tpu``.

The module tree mirrors the JAX package one to one (``core/``, ``physics/``,
``closures/``, ``models/``, ``ops/``, ``train/``), so each function has its
counterpart under the same path and name. The JAX package is the reference
this package is tested against; nothing here imports it, or JAX.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (:func:`resolve_device`). Hand-written CUDA kernels live
under ``csrc/`` and are compiled with ``nvcc`` on first use
(``ops/_cuda.py``); each has a plain PyTorch version beside it that runs
for CPU tensors.
"""

from climateparameterizations_jl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
