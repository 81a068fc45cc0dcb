"""Port of the JAX package's ``models`` modules (see the module docstrings)."""
