"""Port of the JAX package's ``ops`` modules (see the module docstrings)."""
