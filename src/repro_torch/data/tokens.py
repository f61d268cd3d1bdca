"""Synthetic token streams for the LLM trainer: a copy of
``repro.data.tokens`` (numpy only), so that both packages draw the same
batches from a seed."""
from __future__ import annotations

import numpy as np


def token_batches(vocab: int, batch: int, seq: int, n_batches: int,
                  seed: int = 0):
    """Yields ``n_batches`` dicts of ``tokens`` and ``labels``, each (batch,
    seq) int32 numpy arrays, labels the tokens shifted by one. A row is an
    arithmetic progression mod ``vocab`` (a random start and step in 1-6)
    with 5 % of its positions replaced by random tokens, so that a model
    can learn it."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        start = rng.integers(0, vocab, size=(batch, 1))
        step = rng.integers(1, 7, size=(batch, 1))
        base = (start + step * np.arange(seq + 1)[None, :]) % vocab
        noise = rng.random(size=(batch, seq + 1)) < 0.05
        rnd = rng.integers(0, vocab, size=(batch, seq + 1))
        toks = np.where(noise, rnd, base).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
