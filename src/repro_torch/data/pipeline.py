"""Deterministic, shard-aware synthetic data pipeline (port of
``repro.data.pipeline``, numpy only: a batch equals the reference's array
for array; the train step moves it to the device).

Real pretraining data loaders are keyed by (step, shard) so any worker can
reproduce any batch — that property is what makes checkpoint/restart and
elastic rescaling deterministic. This pipeline keeps exactly that contract
with synthetic data:

    batch = f(seed, step)            # pure, no state
    shard i of the batch = f(...)[i-th slice]   # worker-local generation

A background-thread prefetcher overlaps host-side generation with device
compute (double buffering — the host-side analogue of the paper's v2
pipelining).

Synthetic token stream: a mixture of Zipf-distributed unigrams and
repeated n-grams, so language-model loss actually *decreases* during the
example runs (pure uniform noise would sit at log V forever and hide
integration bugs like label misalignment).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, InputShape


class SyntheticLMData:
    """Deterministic step-indexed batch source for one (cfg, shape)."""

    def __init__(self, cfg: ArchConfig, shape: InputShape, *,
                 seed: int = 0, n_shards: int = 1, shard: int = 0):
        if shape.global_batch % n_shards:
            raise ValueError(f"batch {shape.global_batch} must shard evenly "
                             f"over {n_shards} shards")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        self.local_batch = shape.global_batch // n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The shard-local batch for a given step — pure function."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        b, t = self.local_batch, self.shape.seq_len
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {}
        if cfg.frontend == "audio":
            frames = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
            out["frames"] = frames
            out["labels"] = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
            return out
        toks = self._token_stream(rng, b, t + 1)
        out["tokens"] = toks[:, :-1].astype(np.int32)
        out["labels"] = toks[:, 1:].astype(np.int32)
        if cfg.frontend == "vision":
            out["patches"] = rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
        return out

    def _token_stream(self, rng, b, t) -> np.ndarray:
        v = self.cfg.vocab
        # Zipf-ish unigram distribution over a 4k-head vocabulary slice.
        head = min(v, 4096)
        ranks = np.arange(1, head + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(head, size=(b, t), p=probs)
        # Inject learnable structure: every token at even position repeats
        # with offset +1 (a deterministic bigram) with prob 1/2.
        rep = rng.random((b, t)) < 0.5
        shifted = np.roll(toks, 1, axis=1)
        toks = np.where(rep, (shifted + 1) % head, toks)
        return toks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_for_shape(cfg: ArchConfig, shape: InputShape, *, step: int = 0,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """One full global batch (convenience for tests/examples)."""
    return SyntheticLMData(cfg, shape, seed=seed).batch_at(step)


def make_prefetcher(source: Callable[[int], Dict[str, np.ndarray]],
                    start_step: int, *, depth: int = 2
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Double-buffered background prefetch: generation of batch t+1
    overlaps the device step on batch t."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(source(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    th = threading.Thread(target=worker, daemon=True)
    th.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
