"""Training of the port on one device (``parallel.train``).

The JAX package's mesh layer (data and task sharding, ``param_shardings``)
is not ported yet: a ``mesh`` argument raises, naming ROADMAP.md item 22.
"""
