"""Synthetic data pipeline: deterministic, shardable token streams (a copy
of ``repro.training.data``, numpy only; the same config and step give the
same batch in both packages).

Two generators:
  * ``markov_stream`` — an order-1 Markov chain over a reduced alphabet with a
    skewed transition matrix.  Crucially this makes token streams *partially
    predictable*, so a trained draft model achieves non-trivial acceptance
    l(s) — random-uniform tokens would pin l(s) ~= 0 and void the paper's
    phenomenon on synthetic data.
  * ``uniform_stream`` — i.i.d. uniform tokens (worst-case draftability).

Batches are yielded as {tokens [B, T+1]} (+1 for the shifted labels) and are
deterministic in (seed, step), so multi-host data loading would shard by
taking ``batch[host::n_hosts]`` without coordination.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    kind: str = "markov"      # "markov" | "uniform"
    alphabet: int = 256       # active symbols for the markov stream
    skew: float = 0.85        # prob. mass on each state's favourite successor
    seed: int = 0


def _markov_matrix(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1)
    A = min(cfg.alphabet, cfg.vocab_size)
    fav = rng.integers(0, A, size=A)
    M = np.full((A, A), (1.0 - cfg.skew) / (A - 1))
    M[np.arange(A), fav] = cfg.skew
    return M / M.sum(1, keepdims=True)


def _markov2_fav(cfg: DataConfig) -> np.ndarray:
    """Order-2 favourite-successor table fav[a, b] (kind='markov2').

    The conditional depends on the last TWO tokens, so a model that can only
    capture order-1 structure (e.g. a 1-layer draft) predicts the marginal
    argmax and disagrees with a deeper model on a tunable fraction of steps —
    producing the partial speculative acceptance the paper's l(s) exhibits.
    """
    rng = np.random.default_rng(cfg.seed + 2)
    A = min(cfg.alphabet, cfg.vocab_size)
    return rng.integers(0, A, size=(A, A))


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic batch for a given step (checkpoint-resumable)."""
    rng = np.random.default_rng((cfg.seed << 20) ^ step)
    B, T = cfg.batch, cfg.seq_len + 1
    A = min(cfg.alphabet, cfg.vocab_size)
    if cfg.kind == "uniform":
        toks = rng.integers(0, cfg.vocab_size, size=(B, T))
    elif cfg.kind == "markov2":
        fav = _markov2_fav(cfg)
        toks = np.empty((B, T), np.int64)
        toks[:, :2] = rng.integers(0, A, size=(B, 2))
        u = rng.random((B, T))
        rand = rng.integers(0, A, size=(B, T))
        for t in range(2, T):
            f = fav[toks[:, t - 2], toks[:, t - 1]]
            toks[:, t] = np.where(u[:, t] < cfg.skew, f, rand[:, t])
    else:
        M = _markov_matrix(cfg)
        cdf = np.cumsum(M, axis=1)
        toks = np.empty((B, T), np.int64)
        toks[:, 0] = rng.integers(0, A, size=B)
        u = rng.random((B, T))
        for t in range(1, T):
            toks[:, t] = (cdf[toks[:, t - 1]] > u[:, t, None]).argmax(axis=1)
    return {"tokens": toks.astype(np.int32)}


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
