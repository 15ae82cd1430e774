"""Checkpoints the JAX package and the port both read (npz + manifest)."""
