"""Deterministic, resumable token pipeline: a copy of
``src/repro/data/pipeline.py`` (numpy only), so that the port imports
nothing of the JAX package; its batches are the JAX module's bit for bit.

Two sources:
  - SyntheticLM: seeded Zipf-ish token stream (benchmarks/smoke);
  - MemmapDataset: flat binary token file (np.memmap), the production path.

Determinism/resume: batch content is a pure function of (seed, step), so
restart-from-checkpoint replays the exact stream without state files.
The batches are numpy arrays (int32 tokens and labels); the trainer moves
them to its device.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Zipf-ish marginal + a deterministic n-gram-ish structure so the
        # loss actually decreases during example training runs
        z = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        toks = (z % self.vocab).astype(np.int32)
        toks[:, 1:] = (toks[:, 1:] + toks[:, :-1] * 7) % self.vocab
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:].copy())


@dataclasses.dataclass
class MemmapDataset:
    path: str
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self.n_tokens = len(self._data)
        self.n_windows = (self.n_tokens - 1) // self.seq_len

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        idx = rng.integers(0, self.n_windows, size=self.global_batch)
        starts = idx * self.seq_len
        toks = np.stack([self._data[s:s + self.seq_len + 1] for s in starts])
        toks = toks.astype(np.int32)
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:].copy())


def write_synthetic_corpus(path: str, n_tokens: int, vocab: int, seed=0):
    rng = np.random.default_rng(seed)
    data = (rng.zipf(1.3, size=n_tokens) % vocab).astype(np.int32)
    data.tofile(path)
    return path
