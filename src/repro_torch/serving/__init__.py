"""The port's serving engine (the JAX package's ``repro.serving``)."""
