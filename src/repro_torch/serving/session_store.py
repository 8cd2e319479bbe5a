"""SessionStore: paging backends for serving sessions (the JAX package's
``repro.serving.session_store``).

A *session* is the resumable state of one conversation -- the tree
``(cache, pos)`` that ``ServeEngine.generate`` returns.  This module owns
how sessions are serialized and where they live; the engine only calls
the small ``SessionStore`` protocol:

  * ``save(session, state) -> int``   -- persist (atomic per backend)
  * ``load(session) -> state``        -- raise ``KeyError`` if absent
  * ``load_many(sessions, missing_ok=False) -> list[state | None]``
  * ``drop(session) -> bool``         -- remove head + every chunk
  * ``exists(session) -> bool``

Backends:

``MemorySessionStore``
    Holds the *encoded* payload in a dict, so a resumed state is
    bit-identical to the LSM backend's.

``LsmSessionStore``
    Pages sessions into an ``LsmDB``.  Layout per session (16-byte keys;
    ``h`` is an 8-byte blake2b of the name):

      h + idx(0)   head   = n_chunks(4B BE) + meta_len(4B BE)
      h + idx(i)   chunk  = slice i-1 of (meta_json + raw leaf bytes)

    where ``idx(i) = ((i << 1) | 1) 8B BE`` -- the odd low byte keeps
    fixed-width LSM keys from ending in NUL.  ``save`` and ``drop`` each
    issue ONE ``write_batch`` (one WAL record), so a crash mid page-out or
    mid-drop leaves the session fully old, fully new, or cleanly absent
    after replay.  A save that shrinks the chunk count deletes the stale
    tail in the same batch.  ``load`` fetches the head, then every chunk
    in ONE ``multi_get``; ``load_many`` reads all heads in one
    ``multi_get`` and all chunks of all sessions in a second,
    bit-identical to a loop of ``load`` calls.

The bytes are the JAX package's: the leaves are walked in its order
(dict keys sorted, as ``jax.tree.leaves`` walks them, whatever order the
dict was built in), the metadata is the same JSON (numpy dtype names,
shapes as lists), and bf16 leaves travel as their 16-bit patterns.  So a
session either package saved loads in the other.

Rebuilding a state needs the tree *structure*, which the stored metadata
does not carry.  Each store therefore takes a ``template``: a tree of the
same structure, or a zero-arg callable returning one (evaluated lazily,
once).  ``ServeEngine`` supplies its own.  Decoded leaves land on the
store's device: ``MemorySessionStore``'s (None: ``cuda``) or the
``LsmDB``'s.
"""

from __future__ import annotations

import hashlib
import json
from typing import Iterable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.device import resolve_device


# --------------------------------------------------------------- encoding

def _leaves(tree) -> list:
    """The leaves of ``tree`` in the JAX package's order: dict keys
    sorted, lists and tuples in order, None an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in ``_leaves``
    order from the iterator ``leaves``; dicts keep the template's key
    order."""
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return None if template is None else next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    # torch's names match numpy's for every dtype a state holds
    # ("float32", "bfloat16", "int32", "bool", ...)
    return str(t.dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise IOError(f"stored session names an unknown dtype {name!r}")
    return dt


def encode_state(state) -> tuple[bytes, bytes]:
    """Flatten a tree of tensors into ``(meta_json, raw)`` bytes.

    ``meta_json`` lists ``(dtype, shape, nbytes)`` per leaf in the JAX
    package's leaf order; ``raw`` is the concatenated leaf bytes (each
    leaf copied to the host once).  Deterministic, and equal to
    ``repro.serving.session_store.encode_state`` of the same values."""
    blobs = []
    for leaf in _leaves(state):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
        name = _dtype_name(t)
        if t.dtype == torch.bfloat16:   # numpy has no bf16: its bit patterns
            t = t.view(torch.int16)
        blobs.append((name, list(t.shape), t.numpy().tobytes()))
    meta = json.dumps([(d, s, len(b)) for d, s, b in blobs]).encode()
    raw = b"".join(b for _, _, b in blobs)
    return meta, raw


def decode_state(meta: bytes, raw: bytes, template, device=None):
    """Inverse of ``encode_state``; ``template`` supplies the structure.
    The leaves are put on ``device`` (None: ``cuda``, which must be
    present), one copy each."""
    dev = resolve_device(device)
    specs = json.loads(meta)
    n_template = len(_leaves(template))
    if n_template != len(specs):
        raise IOError(
            f"stored session has {len(specs)} leaves but the template "
            f"tree has {n_template}; wrong template?")
    leaves = []
    off = 0
    for dtype, shape, nbytes in specs:
        dt = _torch_dtype(dtype)
        host = np.frombuffer(raw, np.uint8, nbytes, off).copy()
        leaves.append(torch.from_numpy(host).view(dt).reshape(shape).to(dev))
        off += nbytes
    return _unflatten(template, iter(leaves))


# --------------------------------------------------------------- protocol

@runtime_checkable
class SessionStore(Protocol):
    """What ``ServeEngine`` requires of a paging backend."""

    def save(self, session: str, state) -> int: ...

    def load(self, session: str): ...

    def load_many(self, sessions: Iterable[str], *,
                  missing_ok: bool = False) -> list: ...

    def drop(self, session: str) -> bool: ...

    def exists(self, session: str) -> bool: ...


class _TemplateMixin:
    """Lazy template resolution shared by both backends."""

    _template_src = None
    _template_tree = None

    def _init_template(self, template):
        if callable(template) and not hasattr(template, "shape"):
            self._template_src = template
        else:
            self._template_tree = template

    def _template(self):
        if self._template_tree is None:
            self._template_tree = self._template_src()
        return self._template_tree


# ---------------------------------------------------------- memory backend

class MemorySessionStore(_TemplateMixin):
    """Dict-backed backend.  Stores the encoded payload (not live
    tensors) so the decode path -- and therefore the resumed state -- is
    byte-for-byte the same as the LSM backend's.  ``device``: where
    loaded states land (None: ``cuda``, which must be present)."""

    def __init__(self, template, device=None):
        self.device = resolve_device(device)
        self._init_template(template)
        self._d: dict[str, tuple[bytes, bytes]] = {}

    def save(self, session: str, state) -> int:
        self._d[session] = encode_state(state)
        return 1

    def load(self, session: str):
        try:
            meta, raw = self._d[session]
        except KeyError:
            raise KeyError(f"no session {session!r}") from None
        return decode_state(meta, raw, self._template(), self.device)

    def load_many(self, sessions: Iterable[str], *,
                  missing_ok: bool = False) -> list:
        out = []
        for s in sessions:
            if s not in self._d:
                if not missing_ok:
                    raise KeyError(f"no session {s!r}")
                out.append(None)
                continue
            out.append(self.load(s))
        return out

    def drop(self, session: str) -> bool:
        return self._d.pop(session, None) is not None

    def exists(self, session: str) -> bool:
        return session in self._d


# ------------------------------------------------------------- lsm backend

class LsmSessionStore(_TemplateMixin):
    """Pages sessions into an LSM store (``LsmDB`` or ``ShardedDB``);
    loaded states land on the store's device.  See the module docstring
    for the key layout and the atomicity / batching contract."""

    def __init__(self, db, template):
        self.db = db
        self._init_template(template)
        geom = getattr(db, "geom", None)
        if geom is None:
            geom = db.cfg.geom
        if geom.key_bytes < 16:
            raise ValueError(
                f"session paging needs key_bytes >= 16, got {geom.key_bytes}")
        # head values are 8 bytes; chunk payloads match for simplicity
        self._payload = geom.value_bytes - 8

    # -- keys ------------------------------------------------------------

    @staticmethod
    def _key(session: str, i: int) -> bytes:
        h = hashlib.blake2b(session.encode(), digest_size=8).digest()
        # odd low byte: fixed-width LSM keys must not end in NUL
        return h + ((i << 1) | 1).to_bytes(8, "big")

    @staticmethod
    def _parse_head(head: bytes) -> tuple[int, int]:
        return (int.from_bytes(head[:4], "big"),
                int.from_bytes(head[4:8], "big"))

    # -- write path ------------------------------------------------------

    def save(self, session: str, state) -> int:
        """Page out in ONE atomic write_batch.  Returns the number of
        KV records written (head + chunks + stale-tail deletes)."""
        meta, raw = encode_state(state)
        stream = meta + raw
        p = self._payload
        chunks = [stream[i:i + p] for i in range(0, len(stream), p)]
        head = (len(chunks).to_bytes(4, "big")
                + len(meta).to_bytes(4, "big"))
        ops = [("put", self._key(session, 0), head)]
        ops += [("put", self._key(session, i + 1), ch)
                for i, ch in enumerate(chunks)]
        # a shrinking overwrite must not leave orphan chunks behind
        old_head = self.db.get(self._key(session, 0))
        if old_head is not None:
            old_n, _ = self._parse_head(old_head)
            ops += [("delete", self._key(session, i + 1))
                    for i in range(len(chunks), old_n)]
        self.db.write_batch(ops)
        return len(ops)

    def drop(self, session: str) -> bool:
        """Delete head + every chunk in ONE atomic write_batch."""
        head = self.db.get(self._key(session, 0))
        if head is None:
            return False
        n, _ = self._parse_head(head)
        self.db.write_batch([("delete", self._key(session, i))
                             for i in range(n + 1)])
        return True

    # -- read path -------------------------------------------------------

    def exists(self, session: str) -> bool:
        return self.db.get(self._key(session, 0)) is not None

    def load(self, session: str):
        head = self.db.get(self._key(session, 0))
        if head is None:
            raise KeyError(f"no session {session!r}")
        n, meta_len = self._parse_head(head)
        vals = self.db.multi_get([self._key(session, i + 1)
                                  for i in range(n)])
        return self._assemble(session, vals, meta_len)

    def load_many(self, sessions: Iterable[str], *,
                  missing_ok: bool = False) -> list:
        """Resume many sessions with two batched waves: one multi_get
        for all heads, one for all chunks of all present sessions.
        Bit-identical to a loop of ``load`` calls."""
        sessions = list(sessions)
        heads = self.db.multi_get([self._key(s, 0) for s in sessions])
        specs, keys = [], []
        for s, head in zip(sessions, heads):
            if head is None:
                if not missing_ok:
                    raise KeyError(f"no session {s!r}")
                specs.append(None)
                continue
            n, meta_len = self._parse_head(head)
            specs.append((len(keys), n, meta_len))
            keys += [self._key(s, i + 1) for i in range(n)]
        vals = self.db.multi_get(keys) if keys else []
        out = []
        for s, spec in zip(sessions, specs):
            if spec is None:
                out.append(None)
                continue
            start, n, meta_len = spec
            out.append(self._assemble(s, vals[start:start + n], meta_len))
        return out

    def _assemble(self, session: str, chunk_vals, meta_len: int):
        if any(v is None for v in chunk_vals):
            raise IOError(
                f"session {session!r} is truncated: head present but "
                f"{sum(v is None for v in chunk_vals)} chunk(s) missing")
        stream = b"".join(chunk_vals)
        return decode_state(stream[:meta_len], stream[meta_len:],
                            self._template(), self.db.device)
