"""Batched serving engine with pluggable session paging (the JAX
package's ``repro.serving.engine``).

``ServeEngine.generate`` runs prefill and greedy decode for a batch of
equal-length prompts and returns a resumable ``(cache, pos)``.  Sessions
are paged out through a ``SessionStore`` backend
(``repro_torch.serving.session_store``) -- by default an
``LsmSessionStore`` over the given LSM store, so long-lived sessions
churn the store as the paper's YCSB updates do and the device
compactions reclaim superseded pages.

Decode is one captured step, the counterpart of JAX's jitted
``_decode``: on ``cuda`` each batch size captures
``model.decode_step`` once in a CUDA graph over static cache, token and
position buffers, and every later step replays it.  On the CPU the step
runs eagerly.  The prefill stays eager.  A capture may run while a
session store's background workers launch on the card (an async
``LsmDB``): it is captured in ``thread_local`` mode, so their allocations,
copies and synchronizations on other threads neither fail nor end up in
the graph; a capture that fails raises.

``generate`` takes token prompts only, as JAX's does: the
encoder-decoder arch (whisper: ``frames``) and the vision arch (internvl2:
``patches``) run through ``model.prefill`` and ``model.decode_step``, and
``generate`` raises for them (``check_servable``) where JAX's fails on the
missing input.

Metrics and tracing, as in JAX: the histograms
``serve.op.latency_us{op=generate|page_out|page_in|page_in_many}`` and
the spans ``serve.generate``, ``serve.page_out``, ``serve.page_in`` and
``serve.page_in_many``.  They wrap host-level calls only, never the
captured region: host code there runs once at capture and never on
replay.  ``metrics`` and ``tracer`` default to the page store's, so the
serving spans land in the trace of the store's flushes and compactions.
"""

from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_map
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.session_store import LsmSessionStore


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an arch that needs more than tokens (the
    encoder's ``frames``, the vision prefix's ``patches``): ``generate``
    cannot feed it."""
    if cfg.enc_dec or cfg.frontend is not None:
        need = "frames" if cfg.enc_dec else "patches"
        raise ValueError(
            f"{cfg.name}: ServeEngine.generate takes token prompts only, and "
            f"this arch also needs {need!r} (run model.prefill and "
            "model.decode_step with them)")


def _load(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into the static buffer ``dst``; ``copy_`` alone would
    broadcast or cast an input that does not fit."""
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"decode input {tuple(src.shape)} {src.dtype} does "
                         f"not fit the captured {tuple(dst.shape)} "
                         f"{dst.dtype}")
    dst.copy_(src)


class _CapturedDecode:
    """``model.decode_step`` captured in a CUDA graph over static
    buffers: a call copies its inputs into them, replays the graph and
    returns copies of the outputs, so no result is ever a view of a
    buffer that the next replay overwrites.

    The capture stream is a side stream that does not synchronize with
    the default stream other threads launch on, and the capture is in
    ``thread_local`` mode: only this thread is barred from the calls a
    capture forbids (a ``cudaMalloc``, a synchronizing copy), so a store's
    flush or compaction worker that runs meanwhile neither breaks the
    capture nor is broken by it.  (The default, ``global``, bars every
    thread of the process.)"""

    def __init__(self, params: dict, cfg: ModelConfig, cache, tokens, pos):
        self.cache = tree_map(torch.clone, cache)
        self.tokens = tokens.clone()
        self.pos = pos.clone()
        # PyTorch requires warm-up launches on a side stream before a
        # capture (cuBLAS handles and workspaces are made there)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                model.decode_step(params, self.cache, self.tokens, self.pos,
                                  cfg)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.logits, self.new_cache = model.decode_step(
                params, self.cache, self.tokens, self.pos, cfg)

    def __call__(self, cache, tokens, pos):
        tree_map(_load, (self.cache, self.tokens, self.pos),
                 (cache, tokens, pos))
        self.graph.replay()
        return self.logits.clone(), tree_map(torch.clone, self.new_cache)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, max_len: int = 256,
                 device=None, page_store=None, session_store=None,
                 metrics=None, tracer=None):
        """``params``: the model's fp32 tree (``model.init``).  The engine
        keeps its own copy on ``device`` (None: ``cuda``) with the leaves
        every use casts to the compute dtype cast once
        (``model.cast_params``: the same results, and at bf16 half the
        bytes of those leaves); the caller may drop its fp32 tree.

        ``session_store`` is any ``SessionStore``; ``page_store`` is an
        ``LsmDB`` that gets wrapped in an ``LsmSessionStore`` with this
        engine's state template.  Pass at most one of the two.

        ``metrics`` / ``tracer``: an ``obs`` registry and tracer; by
        default the page store's, else ``NULL_REGISTRY`` /
        ``NULL_TRACER``."""
        if page_store is not None and session_store is not None:
            raise ValueError("pass page_store or session_store, not both")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        self.params = model.cast_params(
            tree_map(lambda a: a.to(self.device), params), cfg)
        if session_store is None and page_store is not None:
            session_store = LsmSessionStore(page_store, self._state_template)
        self.sessions = session_store
        # .store keeps pointing at the underlying LSM handle (tests and
        # benches reach through it for flush/compact/stats)
        self.store = (page_store if page_store is not None
                      else getattr(session_store, "db", None))
        if metrics is None:
            metrics = getattr(self.store, "metrics", None)
        if tracer is None:
            tracer = getattr(self.store, "tracer", None)
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._h_gen = self.metrics.histogram(
            "serve.op.latency_us", op="generate",
            help="serving op latency (us)")
        self._h_out = self.metrics.histogram("serve.op.latency_us",
                                             op="page_out")
        self._h_in = self.metrics.histogram("serve.op.latency_us",
                                            op="page_in")
        self._h_in_many = self.metrics.histogram("serve.op.latency_us",
                                                 op="page_in_many")
        self._graphs: dict[int, _CapturedDecode] = {}   # by batch size

    def _state_template(self):
        # only the tree STRUCTURE is used; leaf shapes come from the
        # stored metadata, so batch size 1 is fine for any saved batch
        return (model.init_cache(self.cfg, 1, self.max_len,
                                 device=self.device),
                torch.zeros((1, 1), dtype=torch.int32, device=self.device))

    # ----------------------------------------------------------- generate

    def _decode(self, params: dict, cache, tokens: torch.Tensor,
                pos: torch.Tensor):
        """One decode step, ``model.decode_step``'s contract.  On ``cuda``
        it replays the graph captured for this batch size,
        capturing it at the first call (the capture is over the engine's
        params, so ``params`` must be ``self.params``); a capture or
        replay that fails raises.  On the CPU it runs eagerly."""
        if self.device.type != "cuda":
            return model.decode_step(params, cache, tokens, pos, self.cfg)
        if params is not self.params:
            raise ValueError("the captured decode step runs over the "
                             "engine's own params (pass engine.params)")
        key = tokens.shape[0]
        step = self._graphs.get(key)
        if step is None:
            step = _CapturedDecode(params, self.cfg, cache, tokens, pos)
            self._graphs[key] = step
        return step(cache, tokens, pos)

    def generate(self, prompts, max_new: int, eos: int | None = None):
        """``prompts``: int ``[B, S]`` (equal length).  Returns ``(tokens
        [B, max_new] int32 numpy, cache, pos)``.  ``eos`` is accepted and
        not used, as in the JAX package: every request decodes ``max_new``
        tokens.

        The returned ``(cache, pos)`` is resumable: the last emitted token
        has NOT been decoded into the cache yet, so feeding it back through
        ``_decode`` at ``pos`` continues exactly where an uninterrupted run
        would have gone."""
        t0 = time.perf_counter_ns()
        with self.tracer.span("serve.generate",
                              batch=len(prompts), max_new=max_new):
            out = self._generate_inner(prompts, max_new)
        self._h_gen.pend((time.perf_counter_ns() - t0) / 1000.0)
        return out

    def _generate_inner(self, prompts, max_new: int):
        check_servable(self.cfg)
        prompts = torch.as_tensor(prompts, dtype=torch.int32,
                                  device=self.device)
        logit, cache, pos = model.prefill(
            self.params, {"tokens": prompts}, self.cfg, self.max_len)
        outs = []
        tok = torch.argmax(logit, -1)[:, None].to(torch.int32)
        for i in range(max_new):
            outs.append(tok[:, 0])
            if i + 1 == max_new:
                break   # keep the state resumable (and skip a dead decode)
            logits, cache = self._decode(self.params, cache, tok, pos)
            tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
            pos = pos + 1
        return torch.stack(outs, dim=1).cpu().numpy(), cache, pos

    # ------------------------------------------------------- KV paging

    def save_session(self, session: str, cache, pos) -> int:
        """Page the session state out through the session store.
        Returns the number of records written (backend-defined)."""
        assert self.sessions is not None, "no session store configured"
        t0 = time.perf_counter_ns()
        with self.tracer.span("serve.page_out", session=session):
            count = self.sessions.save(session, (cache, pos))
        self._h_out.pend((time.perf_counter_ns() - t0) / 1000.0)
        return count

    def load_session(self, session: str):
        """Page one session back in; raises ``KeyError`` if absent."""
        assert self.sessions is not None, "no session store configured"
        t0 = time.perf_counter_ns()
        with self.tracer.span("serve.page_in", session=session):
            cache, pos = self.sessions.load(session)
        self._h_in.pend((time.perf_counter_ns() - t0) / 1000.0)
        return cache, pos

    def load_sessions(self, sessions, *, missing_ok: bool = False):
        """Batched resume: ``load_many`` on the backend collapses the
        per-session reads into two multi_get waves on the LSM backend.
        Returns ``[(cache, pos) | None, ...]`` aligned with input."""
        assert self.sessions is not None, "no session store configured"
        sessions = list(sessions)
        t0 = time.perf_counter_ns()
        with self.tracer.span("serve.page_in_many", n=len(sessions)):
            out = self.sessions.load_many(sessions, missing_ok=missing_ok)
        self._h_in_many.pend((time.perf_counter_ns() - t0) / 1000.0)
        return out

    def drop_session(self, session: str) -> bool:
        """Remove a paged session (head + all chunks, atomically on the
        LSM backend).  Returns True if it existed."""
        assert self.sessions is not None, "no session store configured"
        return self.sessions.drop(session)
