"""Deterministic data pipeline: synthetic LM token streams (and optional
memmapped corpora) with per-host sharding, background prefetch, and
restart-exact skipping (fault tolerance: a resumed job sees the byte-exact
stream it would have seen uninterrupted).

numpy only, the JAX package's ``data/pipeline.py`` as it is: a batch of
either source is the same array, bit for bit, in both packages.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    """Markov-ish synthetic token stream. Deterministic in (seed, step,
    host): resume-safe without storing cursor state."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id

    def batch_at(self, step: int) -> dict:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + self.host_id) % (2**31 - 1)
        )
        B, S = self.local_batch, self.seq_len
        # zipfian unigram + local repetition → learnable structure
        base = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        toks = np.clip(base, 1, self.vocab - 1)
        rep = rng.rand(B, S) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        return {
            "tokens": toks.astype(np.int32),
            "labels": labels.astype(np.int32),
            "mask": mask,
        }


class MemmapLM:
    """File-backed corpus of int32 tokens; step-indexed slicing."""

    def __init__(self, path: str, seq_len: int, global_batch: int, *,
                 host_id: int = 0, num_hosts: int = 1):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.tokens_per_step = global_batch * (seq_len + 1)

    def batch_at(self, step: int) -> dict:
        S = self.seq_len
        start = (step * self.tokens_per_step) % max(
            len(self.data) - self.tokens_per_step, 1
        )
        start += self.host_id * self.local_batch * (S + 1)
        flat = np.asarray(
            self.data[start : start + self.local_batch * (S + 1)]
        ).reshape(self.local_batch, S + 1)
        return {
            "tokens": flat[:, :-1].copy(),
            "labels": flat[:, 1:].copy(),
            "mask": np.ones((self.local_batch, S), np.float32),
        }


class Prefetcher:
    """Background-thread prefetch of ``source.batch_at(step)``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.source.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
