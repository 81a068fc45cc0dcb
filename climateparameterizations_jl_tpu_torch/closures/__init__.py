"""Port of the JAX package's ``closures`` modules (see the module docstrings)."""
