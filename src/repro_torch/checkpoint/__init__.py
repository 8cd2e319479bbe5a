"""Checkpoints through the port's LSM store (the JAX package's
``repro.checkpoint``)."""
