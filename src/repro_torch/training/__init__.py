"""The port's training path (the JAX package's ``repro.training``): AdamW,
the train step and the train loop."""
