"""Deterministic synthetic data pipeline (port of
``repro/data/pipeline.py``; numpy only, so its tokens are byte-identical to
the reference's for every seed, step and host).

A seeded Zipfian n-gram generator with enough structure for a ~100M LM to
make real progress (next-token entropy well below uniform): a fixed random
bigram transition table + topic drift. Deterministic per (seed, step,
host) so multi-host shards never overlap and restarts resume exactly.

``HostDataLoader`` yields per-host batch shards (numpy); the trainer moves
them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "HostDataLoader", "make_calibration_tokens"]


@dataclasses.dataclass
class SyntheticLM:
    """Markov-with-topics corpus over ``vocab`` symbols."""

    vocab: int
    seed: int = 0
    branching: int = 24  # candidate next-tokens per state
    topics: int = 16

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        self.next_tokens = rng.integers(0, v, size=(v, self.branching))
        # Zipf over the branch choices, tilted per topic
        base = 1.0 / np.arange(1, self.branching + 1)
        tilt = rng.dirichlet(np.ones(self.branching) * 2.0, size=self.topics)
        probs = base[None] * (0.5 + tilt)
        self.branch_probs = probs / probs.sum(axis=1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int64)
        state = rng.integers(0, self.vocab, size=batch)
        topic = rng.integers(0, self.topics, size=batch)
        out[:, 0] = state
        for t in range(1, seq + 1):
            drift = rng.random(batch) < 0.01
            topic = np.where(drift, rng.integers(0, self.topics, batch), topic)
            p = self.branch_probs[topic]  # [B, branching]
            cum = np.cumsum(p, axis=1)
            u = rng.random((batch, 1))
            choice = (u > cum).sum(axis=1)
            state = self.next_tokens[state, choice]
            out[:, t] = state
        return out


@dataclasses.dataclass
class HostDataLoader:
    """Per-host deterministic shard of the global batch."""

    vocab: int
    global_batch: int
    seq_len: int
    host_id: int = 0
    num_hosts: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not split over "
                             f"{self.num_hosts} hosts")
        self.local_batch = self.global_batch // self.num_hosts
        self.corpus = SyntheticLM(self.vocab, seed=self.seed)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a given step (restart-safe: pure function of step)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id
        )
        toks = self.corpus.sample(rng, self.local_batch, self.seq_len)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_calibration_tokens(
    vocab: int, n: int, seq: int, seed: int = 1234, corpus_seed: int = 0
) -> np.ndarray:
    """Calibration samples for PMQ/OTP (paper: 128×2048 C4 / 4096 samples).

    ``corpus_seed`` fixes the *language* (transition tables) — it must
    match the training corpus; ``seed`` only varies the sampling, so
    held-out eval measures the same distribution the model learned.
    """
    corpus = SyntheticLM(vocab, seed=corpus_seed)
    rng = np.random.default_rng(seed)
    return corpus.sample(rng, n, seq)[:, :-1].astype(np.int32)
