"""The benchmark of ``repro_torch``: range-filtered search served through
``ServingEngine`` on deployments of the iRangeGraph paper (see README.md).

Nothing here imports ``jax`` or the JAX package; ``reference.py`` and
``judge.py`` import nothing of ``repro_torch`` either.
"""
