"""Port of the JAX package's ``eval`` modules (see the module docstrings)."""
