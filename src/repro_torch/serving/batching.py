"""Continuous batching over a fixed pool of KV slots, and the block
allocator of the paged KV cache (port's copy of
``repro.serving.batching``)."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from .request import Request


@dataclass
class BatchingConfig:
    n_slots: int = 8
    max_seq: int = 512
    colocated_pd: bool = False
    max_prefills_per_step: int = 2
    # paged KV cache: slots index a shared block pool through a
    # (n_slots, max_blocks) block table instead of owning a dense
    # (max_seq, ...) buffer.  Physical block 0 is reserved as the trash
    # block every unused table cell points at.
    paged: bool = False
    page_size: int = 16
    pool_blocks: Optional[int] = None  # default: no-evict worst case + trash

    @property
    def blocks_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)

    def resolved_pool_blocks(self) -> int:
        if self.pool_blocks is not None:
            return int(self.pool_blocks)
        return self.n_slots * self.blocks_per_slot + 1


class PagedKVCache:
    """Host-side block-table allocator for the shared KV block pool.

    The device side is a pair of ``(n_layers, n_pool, page, Kv, dh)``
    pools (``LM.init_paged_cache``); this class owns the int32 indexing
    state sent with each decode batch:

    * ``block_table`` (n_slots, max_blocks) — logical → physical block per
      slot; unused cells hold ``TRASH`` (physical block 0, owner -1,
      never allocated) so the batch-wide KV write of an idle slot lands
      harmlessly.
    * ``owner`` (n_pool,) — slot owning each physical block, -1 if free.
    * ``block_pos`` (n_pool,) — the block's logical index within its
      owner (drives the position arithmetic of the pool-major twin).

    Invariant: free blocks + allocated blocks == n_pool - 1, with every
    allocated block owned by exactly one (slot, logical) cell.
    """

    TRASH = 0

    def __init__(self, cfg: BatchingConfig):
        self.page = cfg.page_size
        self.n_slots = cfg.n_slots
        self.max_blocks = cfg.blocks_per_slot
        self.n_pool = cfg.resolved_pool_blocks()
        if self.n_pool < 2:
            raise ValueError("pool_blocks must be >= 2 (trash block + 1)")
        self.block_table = np.full((self.n_slots, self.max_blocks), self.TRASH, np.int32)
        self.owner = np.full((self.n_pool,), -1, np.int32)
        self.block_pos = np.zeros((self.n_pool,), np.int32)
        # LIFO free stack, low blocks handed out first
        self.free_blocks: List[int] = list(range(self.n_pool - 1, 0, -1))
        self.slot_blocks = np.zeros((self.n_slots,), np.int32)

    @property
    def n_free(self) -> int:
        return len(self.free_blocks)

    def _alloc_block(self, slot: int, logical: int) -> int:
        if not self.free_blocks:
            raise RuntimeError(
                f"paged KV pool exhausted (pool_blocks={self.n_pool}, "
                f"slot {slot} needs logical block {logical}); size "
                "BatchingConfig.pool_blocks for the live working set"
            )
        b = self.free_blocks.pop()
        self.block_table[slot, logical] = b
        self.owner[b] = slot
        self.block_pos[b] = logical
        return b

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot``'s block list to cover ``n_tokens`` KV entries."""
        need = min(-(-max(int(n_tokens), 0) // self.page), self.max_blocks)
        while int(self.slot_blocks[slot]) < need:
            self._alloc_block(slot, int(self.slot_blocks[slot]))
            self.slot_blocks[slot] += 1

    def free_slot(self, slot: int) -> None:
        """Return all of ``slot``'s blocks to the pool (request retired).
        The device pool keeps the stale K/V bytes: positions past a new
        owner's length are masked by the kernels, never read."""
        for j in range(int(self.slot_blocks[slot])):
            b = int(self.block_table[slot, j])
            self.owner[b] = -1
            self.block_pos[b] = 0
            self.free_blocks.append(b)
            self.block_table[slot, j] = self.TRASH
        self.slot_blocks[slot] = 0

    # ---- snapshot (de)serialization ----------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "page": self.page,
            "n_pool": self.n_pool,
            "block_table": self.block_table.tolist(),
            "owner": self.owner.tolist(),
            "block_pos": self.block_pos.tolist(),
            "free_blocks": list(self.free_blocks),
            "slot_blocks": self.slot_blocks.tolist(),
        }

    def check_state(self, d: Dict[str, Any]) -> None:
        """Raise unless ``d`` was saved from a pool of this geometry."""
        if int(d["page"]) != self.page or int(d["n_pool"]) != self.n_pool:
            raise ValueError(
                "paged KV geometry mismatch: snapshot "
                f"(page={d['page']}, n_pool={d['n_pool']}) vs engine "
                f"(page={self.page}, n_pool={self.n_pool})"
            )

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.check_state(d)
        self.block_table = np.asarray(d["block_table"], np.int32)
        self.owner = np.asarray(d["owner"], np.int32)
        self.block_pos = np.asarray(d["block_pos"], np.int32)
        self.free_blocks = [int(b) for b in d["free_blocks"]]
        self.slot_blocks = np.asarray(d["slot_blocks"], np.int32)


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
