"""Device layout of the port: one card, described as the JAX package's 1-D mesh (``parallel/sharding.py``)."""
