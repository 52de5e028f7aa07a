"""Deterministic synthetic LM data with packing and prefetch (the port's
copy of ``repro.data.pipeline``; the batches are numpy, equal to the
reference's for the same config, shard and step).

A seeded per-shard token stream (Zipfian unigrams plus short-range
copies, so the loss has structure to learn) is packed into fixed-length
sequences; :class:`Prefetcher` moves batches to the model's device on a
background thread, a few batches ahead.  Each data-parallel host builds
only its shard (``shard_id / n_shards``); (seed, shard, step) make the
batch, so a restart reproduces it.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_s: float = 1.2
    markov_p: float = 0.35  # P(copy a recent token): learnable structure
    mean_doc_len: int = 512


class SyntheticLM:
    """Deterministic stream of packed ``{"tokens", "labels"}`` batches."""

    def __init__(self, cfg: DataConfig, shard_id: int = 0, n_shards: int = 1):
        if cfg.global_batch % n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split over {n_shards} shards")
        self.cfg = cfg
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.batch_per_shard = cfg.global_batch // n_shards
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_s)
        self._p = p / p.sum()

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.cfg.seed, self.shard_id, step]))

    def _sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        toks = rng.choice(self.cfg.vocab_size, size=length, p=self._p)
        # short-range structure: with prob markov_p, copy a token 1-8 back
        copy = rng.random(length) < self.cfg.markov_p
        offs = rng.integers(1, 9, size=length)
        for i in np.nonzero(copy)[0]:
            if i >= offs[i]:
                toks[i] = toks[i - offs[i]]
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The packed batch of ``step``: ``tokens`` and ``labels`` (the
        tokens shifted by one), int32 (batch_per_shard, seq_len)."""
        cfg = self.cfg
        rng = self._rng_for(step)
        need = self.batch_per_shard * (cfg.seq_len + 1)
        stream = np.empty(need, dtype=np.int32)
        filled = 0
        while filled < need:  # pack documents back to back
            ln = int(rng.geometric(1.0 / cfg.mean_doc_len))
            # at least 8 tokens, cut to the room left; the reference clamps
            # in the other order and fails when fewer than 8 are left
            ln = min(max(8, ln), need - filled)
            stream[filled:filled + ln] = self._sample_doc(rng, ln)
            filled += ln
        arr = stream.reshape(self.batch_per_shard, cfg.seq_len + 1)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class Prefetcher:
    """Prefetch on a background thread, ``depth`` batches ahead, in order.
    ``put_fn`` moves a batch to the model's device (e.g. ``functools.
    partial(to_device, device=lm.device)``); a failure of the source or of
    ``put_fn`` is raised by the next ``next()``."""

    def __init__(self, source: Iterator, put_fn: Optional[Callable] = None, depth: int = 2):
        self.source = source
        self.put_fn = put_fn or (lambda b: b)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                self.q.put(self.put_fn(item))
        except Exception as e:  # noqa: BLE001  handed to the consumer
            self.q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
