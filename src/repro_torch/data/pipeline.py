"""Deterministic token pipeline with host-side prefetch.

Two sources, numpy-identical to the reference's (``repro/data/pipeline.py``):
  * SyntheticSource — seeded Zipf-ish token stream, fully deterministic per
    (seed, step) so restarts resume exactly;
  * ByteCorpusSource — byte-level LM over any file (the paper's llm.c
    tinystories/shakespeare workload shape).

``DataPipeline`` yields {tokens, labels} of (global_batch, seq) torch tensors
(int32) on ``device``, a background thread keeping ``prefetch`` batches
ready; ``batch_at`` returns the reference's numpy arrays for a step.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class SyntheticSource:
    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        # Zipf-ish marginal — more realistic logits than uniform
        ranks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        return (ranks % self.vocab).astype(np.int32)


class ByteCorpusSource:
    def __init__(self, path: str, seed: int = 0):
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        if self.data.size < 2:
            raise ValueError(f"corpus {path} too small")
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 7_777_777 + step)
        starts = rng.integers(0, max(1, self.data.size - seq - 1), size=batch)
        rows = [self.data[s:s + seq + 1].astype(np.int32) for s in starts]
        return np.stack(rows)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors on ``device`` (pinned staging on CUDA)."""
    out = {}
    for name, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[name] = t
    return out


@dataclass
class DataPipeline:
    source: object
    global_batch: int
    seq_len: int
    device: Optional[torch.device] = None
    prefetch: int = 2
    start_step: int = 0

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            step = self.start_step
            while not stop.is_set():
                arr = self.source.batch(step, self.global_batch, self.seq_len)
                while not stop.is_set():
                    try:
                        q.put((step, arr), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                _, arr = q.get()
                batch = {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
                yield to_device(batch, self.device or "cpu")
        finally:
            stop.set()
            t.join(timeout=5)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic random access — exact restart after failure."""
        arr = self.source.batch(step, self.global_batch, self.seq_len)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
