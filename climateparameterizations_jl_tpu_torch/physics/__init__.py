"""Port of the JAX package's ``physics`` modules (see the module docstrings)."""
