"""Continuous batching over a fixed pool of KV slots (port's copy of
``repro.serving.batching``; the paged block allocator ``PagedKVCache``
joins with the paged decode kernel)."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional

from .request import Request


@dataclass
class BatchingConfig:
    n_slots: int = 8
    max_seq: int = 512
    colocated_pd: bool = False
    max_prefills_per_step: int = 2
    # paged KV cache: not ported yet, the engine refuses paged=True
    paged: bool = False


class SlotScheduler:
    def __init__(self, cfg: BatchingConfig):
        self.cfg = cfg
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * cfg.n_slots
        self.finished: List[Request] = []
        self._sub_seq = 0  # submission order, the EDF admit tie-break

    def submit(self, req: Request) -> None:
        req._sub_seq = self._sub_seq
        self._sub_seq += 1
        self.queue.append(req)

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def expire_queue(self, now: float) -> List[Request]:
        """Remove queued requests whose service-start deadline has passed."""
        expired = [
            r for r in self.queue if r.deadline is not None and r.deadline <= now
        ]
        for r in expired:
            self.queue.remove(r)
            r.expired = True
        return expired

    def admit(self) -> List[Request]:
        """Move queued requests into free slots: interactive before batch,
        earliest deadline first, submission order as the tie-break."""
        admitted = []
        for i, r in enumerate(self.slots):
            if r is None and self.queue:
                req = min(
                    self.queue,
                    key=lambda q: (
                        0 if q.priority == "interactive" else 1,
                        q.deadline if q.deadline is not None else float("inf"),
                        getattr(q, "_sub_seq", q.req_id),
                    ),
                )
                self.queue.remove(req)
                req.slot = i
                self.slots[i] = req
                admitted.append(req)
        return admitted

    def prefill_work(self) -> List[Request]:
        pending = [r for r in self.active if r.prefill_done < len(r.prompt)]
        if not self.cfg.colocated_pd:
            return pending
        return pending[: self.cfg.max_prefills_per_step]

    def decode_batch(self) -> List[Request]:
        return [
            r for r in self.active
            if r.prefill_done >= len(r.prompt) and not r.done
        ]

    def retire(self, now: float) -> List[Request]:
        out = []
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                r.finish_time = now
                self.finished.append(r)
                self.slots[i] = None
                out.append(r)
        return out
