"""Datasets and partitioners: numpy copies of ``repro.data`` (the port
keeps its own copy and imports nothing of the JAX package)."""
