"""Port of the JAX package's ``core`` modules (see the module docstrings)."""
