"""Port of the JAX package's ``train`` modules (see the module docstrings)."""
