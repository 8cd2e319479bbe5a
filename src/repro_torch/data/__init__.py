"""Workload generators (the JAX package's ``repro.data``): YCSB, the
paper's driver."""
