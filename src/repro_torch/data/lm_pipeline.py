"""Deterministic synthetic LM token pipeline with per-shard streams, copied
from the JAX package's ``repro.data.lm_pipeline`` (pure numpy; the port
imports nothing of it).

Real corpora are unavailable offline; the training entry points consume a
seeded synthetic stream whose statistics (Zipfian unigram + short-range
structure) exercise the full embedding table and give a non-degenerate
loss curve.
Sharding: each data-parallel rank derives an independent, restart-stable
stream from (seed, shard_index, step), which is exactly the contract a real
tokenized-corpus loader must satisfy for elastic restarts.
"""
from __future__ import annotations

import numpy as np


def synthetic_token_stream(vocab: int, seed: int, shard: int, num_shards: int):
    """Infinite generator of token ids (Zipf + Markov structure)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, shard]))
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    prev = 0
    while True:
        block = rng.choice(vocab, size=8192, p=probs)
        # short-range structure: every 4th token repeats prev (gives the model
        # something learnable in a few hundred steps)
        block[::4] = np.roll(block, 1)[::4]
        yield from block.astype(np.int32)


def host_batches(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
                 shard: int = 0, num_shards: int = 1, start_step: int = 0):
    """Yield (batch, seq_len) int32 arrays; resumable via ``start_step``."""
    streams = [synthetic_token_stream(vocab, seed, shard * batch + i, num_shards * batch)
               for i in range(batch)]
    # fast-forward for restart stability
    for s in streams:
        for _ in range(start_step * seq_len):
            next(s)
    while True:
        yield np.stack([np.fromiter(s, np.int32, seq_len) for s in streams])
