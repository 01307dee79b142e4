"""Synthetic data pipeline: deterministic, learnable token streams.

A copy of ``repro.training.data`` (numpy only): the same seeds give the
same batches, bit for bit, in both packages.

Two generators:
* ``lm_batches`` — a mixture of structured patterns (arithmetic mod-V
  sequences, copy spans, periodic motifs).  A ~100M model reaches well
  below uniform entropy in a few hundred steps, which is all the §4.2
  lost-expert benchmark needs: a trained model whose quality we can
  measure as experts are masked.
* ``eval_batch`` — held-out split with the same distribution.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0


def _pattern_seq(rng: np.random.Generator, V: int, S: int) -> np.ndarray:
    kind = rng.integers(0, 3)
    if kind == 0:       # arithmetic: x_{t+1} = (x_t + d) % V
        start, d = rng.integers(0, V), rng.integers(1, min(7, V))
        return (start + d * np.arange(S)) % V
    if kind == 1:       # copy: motif of length m repeated
        m = int(rng.integers(2, 9))
        motif = rng.integers(0, V, m)
        return np.tile(motif, S // m + 1)[:S]
    # interleave two arithmetic streams
    a0, a1 = rng.integers(0, V, 2)
    d0, d1 = rng.integers(1, 5, 2)
    out = np.empty(S, np.int64)
    out[0::2] = (a0 + d0 * np.arange((S + 1) // 2)) % V
    out[1::2] = (a1 + d1 * np.arange(S // 2)) % V
    return out


def make_batch(cfg: DataConfig, step: int, split: str = "train"
               ) -> Dict[str, np.ndarray]:
    salt = 0 if split == "train" else 777_777
    rng = np.random.default_rng(cfg.seed * 1_000_003 + step + salt)
    toks = np.stack([_pattern_seq(rng, cfg.vocab_size, cfg.seq_len)
                     for _ in range(cfg.batch_size)])
    return {"tokens": toks.astype(np.int32),
            "loss_mask": np.ones_like(toks, np.int32)}


def lm_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield make_batch(cfg, step)
        step += 1
