"""Checkpoint I/O of the port (the JAX package's on-disk format)."""
