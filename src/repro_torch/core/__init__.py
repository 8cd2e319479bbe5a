"""The compaction pipeline over tensors (the port of ``repro.core``)."""
