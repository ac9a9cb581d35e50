"""Token data pipeline: synthetic + file-backed streams with prefetch
(the port's own numpy copy of ``repro.train.data``: one seed and start
step draw the reference's streams).

``SyntheticLM`` produces a deterministic, seeded, *resumable* token stream
(state = step index, restored from checkpoints); ``BinTokens`` memory-maps
a flat uint16/uint32 token file (the standard packed-corpus format).
``Prefetcher`` double-buffers batches on a daemon thread — host-side input
overlap, the data-plane analogue of the paper's "front-load the expensive
op, then poll cheap state" (the training loop polls a queue instead of
blocking on generation).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    """Deterministic Zipf-ish token stream. Resumable via ``state``."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, start_step: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.step = start_step

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ self.step)
        # Zipf-like marginal so the loss curve is non-trivial.
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        self.step += 1
        return {"tokens": tokens[:, :-1],
                "labels": tokens[:, 1:].astype(np.int32)}


class BinTokens:
    """Flat binary token corpus (np.memmap), sequential epochs, resumable."""

    def __init__(self, path: str, vocab_size: int, batch: int, seq_len: int,
                 dtype=np.uint16, start_offset: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.offset = start_offset
        self.chunk = batch * (seq_len + 1)
        if len(self.tokens) < self.chunk:
            raise ValueError("corpus smaller than one batch")

    def state(self) -> Dict[str, int]:
        return {"offset": self.offset}

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.offset + self.chunk > len(self.tokens):
            self.offset = 0  # wrap = next epoch
        flat = np.asarray(
            self.tokens[self.offset: self.offset + self.chunk],
            dtype=np.int32)
        self.offset += self.chunk
        arr = flat.reshape(self.batch, self.seq + 1) % self.vocab
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


class Prefetcher:
    """Background double-buffering over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        except StopIteration:
            pass
        self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
