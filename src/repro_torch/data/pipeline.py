"""Deterministic, sharded, resumable token pipeline — the port's own copy
of ``repro/data/pipeline.py`` (numpy only), batch for batch the same.

Each data-parallel rank derives its sample stream from (seed, rank, epoch,
cursor) alone, so any rank can recompute any batch — the property both
checkpoint-resume and straggler work-stealing rely on.  The synthetic
corpus is a seeded Markov-ish token generator (benchmark-stable); swap in
a memmap-backed corpus by passing ``corpus=np.ndarray``.

``BatchAllocator`` is the straggler-mitigation hook: batches are claimed
from a global counter, so a slow rank simply claims fewer — nobody waits.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class PipelineState:
    seed: int
    rank: int
    world: int
    cursor: int = 0        # batches consumed by this rank
    epoch: int = 0

    def to_dict(self) -> dict:
        return self.__dict__.copy()

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(**d)


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, batch_per_rank: int,
                 state: PipelineState, corpus: np.ndarray | None = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_per_rank
        self.state = state
        self.corpus = corpus

    def _batch_rng(self, batch_idx: int) -> np.random.Generator:
        s = self.state
        return np.random.default_rng(
            (s.seed * 1_000_003 + s.epoch) * 7_919
            + batch_idx * s.world + s.rank)

    def make_batch(self, batch_idx: int) -> dict:
        rng = self._batch_rng(batch_idx)
        if self.corpus is not None:
            starts = rng.integers(0, self.corpus.shape[0] - self.seq - 1,
                                  self.batch)
            toks = np.stack([self.corpus[s:s + self.seq + 1] for s in starts])
        else:
            # learnable synthetic stream: next token = (3*tok + noise) % V
            first = rng.integers(0, self.vocab, (self.batch, 1))
            toks = [first]
            for _ in range(self.seq):
                nxt = (3 * toks[-1] + rng.integers(0, 7, (self.batch, 1))) \
                    % self.vocab
                toks.append(nxt)
            toks = np.concatenate(toks, axis=1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def next_batch(self) -> dict:
        b = self.make_batch(self.state.cursor)
        self.state.cursor += 1
        return b


class BatchAllocator:
    """Global work queue for straggler mitigation: ranks claim batch ids."""

    def __init__(self, start: int = 0):
        self._next = start
        self._lock = threading.Lock()
        self.claims: dict[int, list[int]] = {}

    def claim(self, rank: int) -> int:
        with self._lock:
            b = self._next
            self._next += 1
            self.claims.setdefault(rank, []).append(b)
            return b
