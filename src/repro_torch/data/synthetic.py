"""Synthetic token pipeline: deterministic, host-sharded, learnable.

The stream mixes (a) a Zipf unigram backbone with (b) induction patterns
(repeated bigram episodes) so a real model's loss demonstrably falls below
the unigram entropy — giving the end-to-end training example a meaningful
learning signal without external data.

``DataPipeline`` yields {tokens, labels} numpy batches; feed through
``repro_torch.rc2f.StreamFIFO`` for host->device overlap.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    batch_size: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    induction_period: int = 16    # every k-th position repeats an episode
    n_hosts: int = 1              # host sharding of the global batch
    host_index: int = 0


class DataPipeline:
    def __init__(self, cfg: DataConfig):
        if cfg.batch_size % cfg.n_hosts:
            raise ValueError("global batch not divisible by n_hosts")
        self.cfg = cfg
        self.local_batch = cfg.batch_size // cfg.n_hosts

    def _rng_for(self, step: int) -> np.random.Generator:
        # independent of host count: seed by (seed, step); host slices rows
        return np.random.default_rng((self.cfg.seed, step))

    def batch_at(self, step: int) -> dict:
        """Deterministic global batch for ``step``, sliced to this host."""
        c = self.cfg
        rng = self._rng_for(step)
        # Zipf backbone, clipped to vocab
        toks = rng.zipf(c.zipf_a, size=(c.batch_size, c.seq_len + 1))
        toks = np.minimum(toks, c.vocab_size - 1).astype(np.int32)
        # induction episodes: copy a window so earlier context predicts later
        ep = c.induction_period
        if c.seq_len + 1 >= 2 * ep:
            starts = rng.integers(0, c.seq_len + 1 - 2 * ep,
                                  size=c.batch_size)
            for b in range(c.batch_size):
                s = starts[b]
                toks[b, s + ep: s + 2 * ep] = toks[b, s: s + ep]
        lo = self.cfg.host_index * self.local_batch
        hi = lo + self.local_batch
        return {"tokens": toks[lo:hi, :-1], "labels": toks[lo:hi, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def unigram_entropy_nats(self, n_samples: int = 200_000) -> float:
        """Empirical entropy of the marginal token distribution (the loss
        floor for a context-free predictor)."""
        c = self.cfg
        rng = np.random.default_rng(c.seed + 1)
        toks = np.minimum(rng.zipf(c.zipf_a, size=n_samples),
                          c.vocab_size - 1)
        counts = np.bincount(toks, minlength=c.vocab_size).astype(np.float64)
        p = counts / counts.sum()
        nz = p > 0
        return float(-(p[nz] * np.log(p[nz])).sum())
