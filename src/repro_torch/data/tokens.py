"""Deterministic synthetic LM data (the JAX package's ``repro.data.tokens``,
byte for byte).

Sequences follow a noisy random bigram chain, so the loss can decrease,
and every batch is a function of ``(seed, step)``.  As in JAX's, the step's
generator is seeded from Python's ``hash(("batch", step))``, and a tuple
holding a string hashes differently in each process unless
``PYTHONHASHSEED`` is fixed: a resumed run reproduces an uninterrupted
one within one process (or under a fixed ``PYTHONHASHSEED``), and the two
packages give the same batches within one process.
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


class BigramStream:
    def __init__(self, vocab: int, *, seed: int = 0, noise: float = 0.15,
                 branch: int = 4):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.noise = noise
        # each token transitions to one of `branch` successors
        self.table = rng.integers(0, vocab, size=(vocab, branch))

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng((hash(("batch", step)) & 0xFFFFFFFF))
        toks = np.empty((batch, seq), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        branch = rng.integers(0, self.table.shape[1], (batch, seq))
        noise_mask = rng.random((batch, seq)) < self.noise
        noise_tok = rng.integers(0, self.vocab, (batch, seq))
        for t in range(1, seq):
            nxt = self.table[toks[:, t - 1], branch[:, t]]
            toks[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return toks


def make_train_batch(cfg: ModelConfig, stream: BigramStream, step: int,
                     batch: int, seq: int) -> dict:
    """One step's batch as numpy arrays: ``tokens`` and ``labels`` (int32),
    plus ``patches`` (vision) or ``frames`` (encoder-decoder), fp32."""
    toks = stream.batch(step, batch, seq)
    out = {}
    rng = np.random.default_rng(hash(("front", step)) & 0xFFFFFFFF)
    if cfg.frontend == "vision":
        out["tokens"] = toks[:, :seq - cfg.frontend_len]
        out["patches"] = rng.standard_normal(
            (batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        out["labels"] = out["tokens"]
    else:
        out["tokens"] = toks
        out["labels"] = toks
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
    return out
