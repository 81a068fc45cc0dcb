"""The parallel layer on ``torch.distributed``: the JAX package's ``parallel/`` (``sharding.py``, ``les_sharding.py``,
``gyre_sharding.py``) with one process per device; ``world.py`` joins and spawns worlds and logs every collective,
``dryrun.py`` runs every sharded path on a mesh."""
