"""The port's failure supervision (the JAX package's ``repro.distributed``;
its mesh and sharding modules are not ported yet)."""
