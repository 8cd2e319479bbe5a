"""Batched serving engine (the JAX package's ``repro.serving.engine``).

``ServeEngine.generate`` runs prefill and greedy decode for a batch of
equal-length prompts and returns a resumable ``(cache, pos)``.  Paging
sessions through the LSM store (``page_store`` / ``session_store`` and the
session methods) waits for ROADMAP A11, metrics and tracing for A10:
passing any of those arguments raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_map


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict, *, max_len: int = 256,
                 device=None, page_store=None, session_store=None,
                 metrics=None, tracer=None):
        """``params``: the model's fp32 tree (``model.init``).  The engine
        keeps its own copy on ``device`` (None: ``cuda``) with the leaves
        every use casts to the compute dtype cast once
        (``model.cast_params``: the same results, and at bf16 half the
        bytes of those leaves); the caller may drop its fp32 tree."""
        late = {"page_store": (page_store, "A11"),
                "session_store": (session_store, "A11"),
                "metrics": (metrics, "A10"), "tracer": (tracer, "A10")}
        for name, (value, item) in late.items():
            if value is not None:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet (ROADMAP "
                    f"{item})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        self.params = model.cast_params(
            tree_map(lambda a: a.to(self.device), params), cfg)

    def generate(self, prompts, max_new: int, eos: int | None = None):
        """``prompts``: int ``[B, S]`` (equal length).  Returns ``(tokens
        [B, max_new] int32 numpy, cache, pos)``.  ``eos`` is accepted and
        not used, as in the JAX package: every request decodes ``max_new``
        tokens.

        The returned ``(cache, pos)`` is resumable: the last emitted token
        has NOT been decoded into the cache yet, so feeding it back through
        ``model.decode_step`` at ``pos`` continues exactly where an
        uninterrupted run would have gone."""
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
            logits, cache = model.decode_step(self.params, cache, tok, pos,
                                              self.cfg)
            tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
            pos = pos + 1
        return torch.stack(outs, dim=1).cpu().numpy(), cache, pos
