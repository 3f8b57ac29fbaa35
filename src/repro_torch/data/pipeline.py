"""Host-side training-data pipeline: synthetic corpus → LSH dedup → packed
batches, with checkpointable iterator state and prefetch.

The counterpart of ``repro.data.pipeline``. The corpus is host numpy made
with the reference's generator seeding, so the batches are the
reference's bit for bit; the dedup stage is the port's
``data.dedup.find_duplicates`` (the ``minmax_hash`` and
``jaccard_popcount`` kernels on the card), which keeps the reference's
sequences. Batches come out as numpy arrays; the caller places them.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.data.dedup import find_duplicates


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 1024
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    dup_frac: float = 0.3          # injected near-duplicate fraction
    dedup: bool = True
    dedup_buffer: int = 64         # sequences per dedup window
    prefetch: int = 2


@dataclasses.dataclass
class IteratorState:
    epoch_seed: int
    position: int

    def to_dict(self) -> dict:
        return {"epoch_seed": self.epoch_seed, "position": self.position}

    @classmethod
    def from_dict(cls, d: dict) -> "IteratorState":
        return cls(epoch_seed=int(d["epoch_seed"]),
                   position=int(d["position"]))


def _make_docs(rng: np.random.Generator, n: int, cfg: DataConfig
               ) -> np.ndarray:
    """Documents with uniform tokens; ~dup_frac are near-duplicates (a
    source document with ~2% of its tokens redrawn)."""
    base = rng.integers(1, cfg.vocab_size,
                        size=(n, cfg.seq_len)).astype(np.int32)
    n_dup = int(n * cfg.dup_frac)
    if n_dup:
        srcs = rng.integers(0, n - n_dup, size=n_dup)
        for j, s in enumerate(srcs):
            doc = base[s].copy()
            flips = rng.integers(0, cfg.seq_len,
                                 size=max(1, cfg.seq_len // 50))
            doc[flips] = rng.integers(1, cfg.vocab_size, size=flips.size)
            base[n - n_dup + j] = doc
    return base


class TokenPipeline:
    """Checkpointable batch iterator with optional LSH dedup + prefetch.
    ``device``: where dedup runs (cuda unless named)."""

    def __init__(self, cfg: DataConfig, state: IteratorState | None = None,
                 device=None):
        self.cfg = cfg
        self.state = state or IteratorState(epoch_seed=cfg.seed, position=0)
        self.device = device
        self.dedup_stats: dict = {"dropped": 0, "seen": 0}

    def _buffer(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.state.epoch_seed * 1_000_003 + index) & 0x7FFFFFFF)
        docs = _make_docs(rng, self.cfg.dedup_buffer, self.cfg)
        if self.cfg.dedup:
            keep, stats = find_duplicates(docs, device=self.device)
            self.dedup_stats["dropped"] += stats["dropped"]
            self.dedup_stats["seen"] += len(docs)
            docs = docs[keep]
        return docs

    def batches(self) -> Iterator[dict]:
        """Yields {"tokens", "labels", "loss_mask"} of (B, S) arrays.

        Leftover sequences beyond the batch are discarded at each batch
        boundary, so the iterator state (the next buffer index) makes a
        resume bit-exact after checkpoint / restart."""
        cfg = self.cfg
        while True:
            idx = self.state.position
            pending: list[np.ndarray] = []
            while sum(len(p) for p in pending) < cfg.global_batch:
                pending.append(self._buffer(idx))
                idx += 1
            tokens = np.concatenate(pending)[: cfg.global_batch]
            self.state.position = idx
            labels = np.concatenate(
                [tokens[:, 1:], np.zeros((tokens.shape[0], 1), np.int32)],
                axis=1)
            mask = np.ones_like(labels, np.float32)
            mask[:, -1] = 0.0
            yield {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def prefetched(self) -> Iterator[dict]:
        """``batches()`` produced on a daemon thread, ``cfg.prefetch``
        ahead."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)

        def worker():
            for b in self.batches():
                q.put(b)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            yield q.get()
