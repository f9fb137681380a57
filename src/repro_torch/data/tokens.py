"""Synthetic LM data pipeline (numpy only; no corpora).

A copy of `repro.data.tokens` for the PyTorch port, which imports nothing
of the JAX package: the same numpy RNG streams, so the tokens are bitwise
the reference's for the same arguments.

Markov-chain token streams with arch-matched vocab give a learnable
next-token distribution (loss should drop well below uniform entropy),
plus deterministic host-side sharding/batching — the minimal-but-real data
substrate for the end-to-end training drivers.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class MarkovTokens:
    """Order-1 Markov chain over a small effective alphabet embedded in the
    arch vocab. Deterministic per seed; infinite stream."""

    def __init__(self, vocab_size: int, effective: int = 256,
                 concentration: float = 0.2, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.eff = min(effective, vocab_size)
        probs = rng.dirichlet(np.full(self.eff, concentration),
                              size=self.eff).astype(np.float64)
        self.cum = np.cumsum(probs, axis=1)
        self.rng = rng

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), np.int32)
        state = self.rng.integers(0, self.eff, size=batch)
        out[:, 0] = state
        for t in range(1, seq_len + 1):
            u = self.rng.random(batch)
            state = np.array([np.searchsorted(self.cum[s], x)
                              for s, x in zip(state, u)])
            state = np.minimum(state, self.eff - 1)
            out[:, t] = state
        return out

    def batches(self, batch: int, seq_len: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            toks = self.sample(batch, seq_len)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def synthetic_batch(cfg, batch: int, seq_len: int, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """One batch matching `input_specs` for any family (smoke tests)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {
            "frames": rng.normal(0, 1, (batch, seq_len, cfg.d_model)
                                 ).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (batch, seq_len)
                                   ).astype(np.int32),
            "mask": np.ones((batch, seq_len), np.int32),
        }
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq_len)
                               ).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq_len)
                               ).astype(np.int32),
    }
    if cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            0, 1, (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out
