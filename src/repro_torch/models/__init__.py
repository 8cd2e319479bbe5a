"""The port's models (the JAX package's ``repro.models``): params and
caches are plain dicts of tensors in the JAX package's tree layout."""
