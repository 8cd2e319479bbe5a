"""Checkpoints on the port's LSM store (the JAX package's
``repro.checkpoint.store``): the same keys, chunks, manifest and puts, so
the two packages write the same SST files and read each other's
checkpoints.

Tensors are stored whole (logical, unsharded), chunked into KV records.
Keys are fixed-width 16 B:

    [8 B tensor-path hash][4 B step][4 B chunk index]

plus one JSON manifest per step (chunked the same way under the reserved
path ``"//manifest"``).  A tensor's path is JAX's ``_tree_paths`` string:
dict keys (sorted) and list indices as they are, a named tuple's field as
``.name`` (``".params/blocks/p0/mixer/A_log"``, ``".opt/.step"``).

Checkpoint churn is the LSM pattern the paper targets: every step writes
new records, ``gc()`` turns old steps into tombstones, and the store's
compactions (the hand-written kernels on the card) reclaim them.

Checkpoints are mesh-agnostic: a save writes whole tensors, and
``restore(..., shardings=)`` places each onto any mesh (the elastic
restart).  In a world of several ranks one rank owns the store: it opens
it, reads and distributes each tensor, while the others call ``receive``
with the same ``like`` and ``shardings`` and get their shards.  A save of
DTensors is streamed the same way: the owner's ``save`` gathers one leaf
at a time while the others ``send`` (join each gather and drop the whole
tensor at once), so no rank holds more than one whole leaf.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.formats import SSTGeometry
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.lsm.db import DBConfig, LsmDB
from repro_torch.models.convert import tree_map_with_path

CHUNK_BYTES = 4000   # payload bytes per KV record

# numpy's dtype names, as JAX's manifest writes them (bf16 is
# ``ml_dtypes``' "bfloat16" there)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _key(path_hash: bytes, step: int, chunk: int) -> bytes:
    # low chunk byte is kept odd: fixed-width LSM keys must not end in NUL
    return path_hash + step.to_bytes(4, "big") \
        + ((chunk << 1) | 1).to_bytes(4, "big")


def _hash_path(path: str) -> bytes:
    return hashlib.blake2b(path.encode(), digest_size=8).digest()


def _placed(read, like, shardings):
    """Each leaf of ``like`` read by ``read(path, leaf)`` and placed by its
    ``partition.NamedSharding`` (rank 0's values distributed), in
    JAX's flatten order on every rank."""
    from repro_torch.distributed import partition
    return tree_map_with_path(
        lambda path, leaf, sh: partition.place(read(path, leaf), sh),
        like, shardings)


def receive(like, shardings, device=None):
    """A non-owner rank's side of the owner's ``restore(step, like,
    shardings)``: its shards of every tensor, distributed from the owner
    (which must be rank 0).  ``device`` None means ``cuda``."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return _placed(lambda path, leaf: torch.empty(
        leaf.shape, dtype=leaf.dtype, device=dev), like, shardings)


def _whole(leaf):
    """A DTensor leaf gathered whole (a collective that every rank of its
    mesh joins); any other leaf as it is."""
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def send(tree):
    """A non-owner rank's side of the owner's ``save(step, tree)`` of a
    tree of DTensors: its part in each leaf's gather, in the owner's
    order, the whole tensor dropped at once."""
    for _, leaf in _tree_paths(tree):
        _whole(leaf)


def _tree_paths(tree) -> list[tuple[str, object]]:
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def _raw(t: torch.Tensor) -> tuple[str, list, bytes]:
    """A tensor's numpy dtype name, shape and C-order bytes."""
    t = t.detach().contiguous().cpu()
    name = _DTYPE_NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return name, list(t.shape), t.numpy().tobytes()


def checkpoint_db_config(engine: str = "device") -> DBConfig:
    geom = SSTGeometry(key_bytes=16, value_bytes=CHUNK_BYTES + 96,
                       block_bytes=64 * 1024, sst_bytes=4 * 1024 * 1024)
    return DBConfig(geom=geom, engine=engine,
                    memtable_bytes=2 * 1024 * 1024,
                    scheduler=SchedulerConfig(l0_trigger=4,
                                              base_bytes=32 * 1024 * 1024))


class CheckpointStore:
    """Checkpoints in an ``LsmDB`` at ``path`` (``checkpoint_db_config()``
    unless ``cfg`` is given) on ``device`` (None means ``cuda``: the
    store's flushes and compactions launch the kernels there); restored
    tensors land on that device."""

    def __init__(self, path: str, cfg: DBConfig | None = None, *,
                 device=None):
        self.db = LsmDB(path, cfg or checkpoint_db_config(), device=device)
        self.device = self.db.device

    # ------------------------------------------------------------- save

    def save(self, step: int, tree) -> dict:
        """Write a tree of tensors (or numpy arrays) as one checkpoint: one
        ``put`` a chunk, then the manifest, then a flush.  A DTensor leaf
        is gathered whole as its turn comes, while the other ranks of its
        mesh ``send``."""
        manifest = {"step": step, "tensors": []}
        for path, leaf in _tree_paths(tree):
            leaf = _whole(leaf)
            if isinstance(leaf, torch.Tensor):
                dtype, shape, raw = _raw(leaf)
            else:
                arr = np.asarray(leaf)
                dtype, shape, raw = str(arr.dtype), list(arr.shape), \
                    arr.tobytes()
            h = _hash_path(path)
            n_chunks = max(1, -(-len(raw) // CHUNK_BYTES))
            for c in range(n_chunks):
                self.db.put(_key(h, step, c),
                            raw[c * CHUNK_BYTES:(c + 1) * CHUNK_BYTES])
            manifest["tensors"].append(
                {"path": path, "dtype": dtype, "shape": shape,
                 "chunks": n_chunks, "bytes": len(raw)})
        mraw = json.dumps(manifest).encode()
        mh = _hash_path("//manifest")
        n_chunks = max(1, -(-len(mraw) // CHUNK_BYTES))
        for c in range(n_chunks):
            self.db.put(_key(mh, step, c),
                        mraw[c * CHUNK_BYTES:(c + 1) * CHUNK_BYTES])
        self.db.put(_key(_hash_path("//manifest-len"), step, 0),
                    str(n_chunks).encode())
        self.db.flush()
        return manifest

    # ---------------------------------------------------------- restore

    def load_manifest(self, step: int) -> dict | None:
        nraw = self.db.get(_key(_hash_path("//manifest-len"), step, 0))
        if nraw is None:
            return None
        mh = _hash_path("//manifest")
        raw = b"".join(self.db.get(_key(mh, step, c))
                       for c in range(int(nraw)))
        return json.loads(raw)

    def restore(self, step: int, like=None, shardings=None):
        """Rebuild the checkpoint of ``step`` as tensors on the store's
        device: a dict path -> tensor, or, given ``like`` (a tree of
        tensors, ``meta`` ones too), a tree of its structure.  With
        ``shardings`` (a matching tree of ``partition.NamedSharding``s,
        any mesh) each tensor is placed as a DTensor: a collective, run by
        rank 0 while the other ranks ``receive``."""
        manifest = self.load_manifest(step)
        if manifest is None:
            raise KeyError(f"no checkpoint for step {step}")
        by_path = {t["path"]: t for t in manifest["tensors"]}

        def read_tensor(path, _leaf=None):
            t = by_path[path]
            h = _hash_path(path)
            raw = b"".join(self.db.get(_key(h, step, c))
                           for c in range(t["chunks"]))[:t["bytes"]]
            dtype = _DTYPES[t["dtype"]]
            flat = torch.frombuffer(bytearray(raw), dtype=dtype) if raw \
                else torch.empty(0, dtype=dtype)
            return flat.reshape(t["shape"]).to(self.device)

        if like is None:
            return {t["path"]: read_tensor(t["path"])
                    for t in manifest["tensors"]}
        if shardings is not None:
            return _placed(read_tensor, like, shardings)
        return tree_map_with_path(read_tensor, like)

    def steps(self) -> list[int]:
        """All steps with a manifest."""
        h = _hash_path("//manifest-len")
        found = []
        lo = h + (0).to_bytes(4, "big") + (1).to_bytes(4, "big")
        hi = h + (2**32 - 1).to_bytes(4, "big") + (3).to_bytes(4, "big")
        for k, _ in self.db.scan(lo, hi):
            found.append(int.from_bytes(k[8:12], "big"))
        return sorted(set(found))

    # --------------------------------------------------------------- gc

    def gc(self, keep_steps: list[int]):
        """Delete all steps not in ``keep_steps``: their records become
        tombstones that the store's compactions reclaim."""
        keep = set(keep_steps)
        for step in self.steps():
            if step in keep:
                continue
            manifest = self.load_manifest(step)
            for t in manifest["tensors"]:
                h = _hash_path(t["path"])
                for c in range(t["chunks"]):
                    self.db.delete(_key(h, step, c))
            mh = _hash_path("//manifest")
            nraw = self.db.get(_key(_hash_path("//manifest-len"), step, 0))
            for c in range(int(nraw)):
                self.db.delete(_key(mh, step, c))
            self.db.delete(_key(_hash_path("//manifest-len"), step, 0))
        self.db.flush()
        self.db.maybe_compact()

    def close(self):
        self.db.close()
