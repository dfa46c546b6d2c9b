"""Procedural LM token streams with learnable structure (the port's own
numpy copy of ``repro.data.synthetic``: same seeds, same arrays).

The stream is a mixture of (a) a first-order Markov chain over a small
state alphabet with low-entropy transitions and (b) repeated motifs (copy
tasks): both give a clear, monotonically decreasing loss signal for the
integration tests ("training on this data reduces loss"), which pure-uniform
tokens cannot.  Everything is seeded + stateless per (shard, step), so the
loader can deterministically skip ahead after restart.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab: int
    seq_len: int
    batch: int  # per-host batch
    motif_len: int = 16
    n_motifs: int = 64
    markov_states: int = 0  # 0 -> min(vocab, 256)
    seed: int = 0


def _motif_table(cfg: SyntheticLMConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1000)
    return rng.integers(0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len))


def _markov(cfg: SyntheticLMConfig):
    k = cfg.markov_states or min(cfg.vocab, 256)
    rng = np.random.default_rng(cfg.seed + 2000)
    # peaky transitions: each state strongly prefers ~4 successors
    trans = np.zeros((k, k))
    for s in range(k):
        nxt = rng.choice(k, size=4, replace=False)
        trans[s, nxt] = rng.dirichlet(np.ones(4) * 0.5)
    trans = trans + 1e-3
    trans /= trans.sum(1, keepdims=True)
    return trans


_CACHE: dict = {}


def lm_batch(cfg: SyntheticLMConfig, step: int, shard: int = 0,
             n_shards: int = 1) -> dict:
    """One (batch, seq_len) token batch for (step, shard).  Pure function of
    its arguments — restart-safe and shard-disjoint by construction."""
    key = ("tbl", cfg.seed, cfg.vocab, cfg.n_motifs, cfg.motif_len)
    if key not in _CACHE:
        _CACHE[key] = (_motif_table(cfg), _markov(cfg))
    motifs, trans = _CACHE[key]
    k = trans.shape[0]

    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 65_537 + shard * 7_919
    )
    b, t = cfg.batch, cfg.seq_len
    out = np.empty((b, t), np.int64)
    state = rng.integers(0, k, size=b)
    i = 0
    # vectorized block generation: alternate markov runs and motif copies
    while i < t:
        run = int(rng.integers(8, 32))
        run = min(run, t - i)
        if rng.random() < 0.3:  # motif copy
            m = rng.integers(0, cfg.n_motifs, size=b)
            block = motifs[m][:, :run]
            if block.shape[1] < run:
                reps = -(-run // cfg.motif_len)
                block = np.tile(motifs[m], (1, reps))[:, :run]
            out[:, i : i + run] = block
        else:  # markov steps (vectorized via per-step categorical)
            for j in range(run):
                u = rng.random(b)
                cdf = np.cumsum(trans[state], axis=1)
                state = (u[:, None] < cdf).argmax(1)
                out[:, i + j] = state
        i += run
    return {"tokens": out.astype(np.int32), "labels": out.astype(np.int32)}


def lm_batch_stream(cfg: SyntheticLMConfig, start_step: int = 0, shard: int = 0,
                    n_shards: int = 1):
    step = start_step
    while True:
        yield lm_batch(cfg, step, shard, n_shards)
        step += 1
