"""Deterministic, resumable synthetic data pipeline: a copy of
``repro.train.data`` (numpy only), so the port imports nothing of
``repro``. Batches are bit-identical to the reference's.

Counter-based RNG (numpy Philox keyed on (seed, step)) makes every batch
a pure function of the step index: checkpoint-restart resumes the stream
exactly (no state files), and any worker can regenerate any shard —
the property a 1000-node data pipeline needs for fault tolerance.

A background prefetch thread overlaps host batch synthesis with device
compute (the CPU-scale stand-in for a real input pipeline).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["DataCfg", "SyntheticDataset", "PrefetchIterator"]


@dataclass(frozen=True)
class DataCfg:
    seq_len: int
    global_batch: int
    num_microbatches: int = 1
    seed: int = 0


class SyntheticDataset:
    """Markov-ish token stream with a learnable structure (so tiny models
    show decreasing loss): token_{t+1} = (a * token_t + noise) % vocab."""

    def __init__(self, arch: ArchConfig, cfg: DataCfg):
        self.arch = arch
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
        G = cfg.num_microbatches
        B = cfg.global_batch // G
        S = cfg.seq_len
        if self.arch.embeds_input:
            embeds = rng.normal(size=(G, B, S, self.arch.d_model)).astype(np.float32)
            labels = rng.integers(0, self.arch.vocab, size=(G, B, S)).astype(np.int32)
            return {"embeds": embeds, "labels": labels}
        V = self.arch.vocab
        start = rng.integers(0, V, size=(G, B, 1))
        mult = 31
        noise = (rng.random(size=(G, B, S)) < 0.1).astype(np.int64)
        toks = np.zeros((G, B, S), dtype=np.int64)
        toks[..., 0] = start[..., 0]
        for t in range(1, S):
            toks[..., t] = (toks[..., t - 1] * mult + 7 + noise[..., t]) % V
        tokens = toks[..., :].astype(np.int32)
        labels = np.roll(toks, -1, axis=-1).astype(np.int32)
        labels[..., -1] = 0
        return {"tokens": tokens, "labels": labels}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Background-thread prefetch with bounded queue; ``close()`` joins."""

    def __init__(self, dataset: SyntheticDataset, start_step: int = 0, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def worker():
            s = start_step
            while not self._stop.is_set():
                batch = dataset.batch_at(s)
                while not self._stop.is_set():
                    try:
                        self._q.put((s, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __next__(self):
        step, batch = self._q.get()
        self._step = step
        return batch

    def __iter__(self):
        return self

    @property
    def step(self) -> int:
        return self._step

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
