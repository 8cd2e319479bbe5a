"""PyTorch / CUDA port of the LUDA LSM store and its model server (the JAX
package ``repro`` is the reference).

Module layout mirrors ``repro``: ``kernels`` (the hand-written Hopper
kernels, their plain PyTorch versions and the dispatch), ``core`` (SST
image format, the compaction pipeline, the executor and the scheduler),
``lsm`` (engine, SST files, memtable, WAL, manifest and the store),
``configs`` and ``models`` (the architecture configs; the Mamba model),
``serving`` (the engine) and ``launch`` (the serving launcher).  The
package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.
"""
