"""Deterministic, restartable synthetic LM data pipeline.

Real deployments stream tokenized shards; for a self-contained framework we
generate sequences from a FIXED seeded bigram process (each symbol has
``branching`` allowed successors, plus a little uniform noise).  The
transition table is global, so the task is genuinely learnable - a model
reduces loss from ln(V) toward the bigram entropy ln(branching) within tens
of steps, which the e2e examples assert.  Pure uniform noise would be
unlearnable and useless for validation.

Determinism + fault tolerance: batch t is a pure function of (seed, t), so
restart-from-checkpoint resumes the exact stream by restoring the step
counter alone.  Sharding: each data-parallel host slice can be produced
independently via the batch index (``host_slice``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4       # successors per symbol (bigram entropy ln(b))
    noise: float = 0.02      # uniform-replacement rate
    n_symbols: int = 0       # 0 = vocab


class SyntheticLM:
    """Batch t -> {"tokens", "labels"} (next-token shifted)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._sym = cfg.n_symbols or cfg.vocab
        # global seeded bigram table: symbol -> ``branching`` successors
        trng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 777]))
        self._table = trng.integers(0, self._sym,
                                    size=(self._sym, cfg.branching))

    def batch(self, step: int,
              host_slice: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        lo, hi = host_slice or (0, cfg.global_batch)
        rows = []
        for b in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, b]))
            n = cfg.seq_len + 1
            choices = rng.integers(0, cfg.branching, size=n)
            seq = np.empty(n, dtype=np.int64)
            seq[0] = rng.integers(0, self._sym)
            for t in range(1, n):
                seq[t] = self._table[seq[t - 1], choices[t]]
            noise = rng.random(n) < cfg.noise
            seq = np.where(noise, rng.integers(0, self._sym, n), seq)
            rows.append(seq)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        t = 0
        while True:
            yield self.batch(t)
            t += 1


def make_pipeline(vocab: int, seq_len: int, global_batch: int,
                  seed: int = 0) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab=vocab, seq_len=seq_len,
                                  global_batch=global_batch, seed=seed))
