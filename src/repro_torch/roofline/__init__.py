"""The roofline and the dry run's counters (the JAX package's
``repro.roofline``), for the H100."""
