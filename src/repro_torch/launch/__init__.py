"""The port's command-line launchers (the JAX package's ``repro.launch``)."""
