"""Request structure for the serving engine (port's copy of
``repro.serving.request``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Monotone process-wide id allocator, a plain counter so a snapshot
# restore can advance it past every restored request's id: a new request
# never gets an id that is already in flight.
_next_id = 0


def _alloc_id() -> int:
    global _next_id
    i = _next_id
    _next_id += 1
    return i


def advance_request_ids(min_next: int) -> None:
    """Ensure future ids start at >= ``min_next`` (snapshot restore)."""
    global _next_id
    _next_id = max(_next_id, int(min_next))


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    req_id: int = field(default_factory=_alloc_id)
    # service class ("interactive"/"batch") and latest acceptable
    # service-start time on the engine clock; None = no deadline
    priority: str = "interactive"
    deadline: Optional[float] = None

    # runtime state
    generated: List[int] = field(default_factory=list)
    prefill_done: int = 0
    slot: Optional[int] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    truncated: bool = False  # hit the KV capacity (max_seq) before eos
    expired: bool = False  # deadline passed while still queued

    @property
    def done(self) -> bool:
        if self.truncated or self.expired:
            return True
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(
            self.eos_id is not None
            and self.generated
            and self.generated[-1] == self.eos_id
        )

    @property
    def position(self) -> int:
        """Next position to write in the KV timeline."""
        return self.prefill_done + len(self.generated)

    # ---- snapshot (de)serialization ----------------------------------
    def to_state(self) -> Dict[str, Any]:
        """Plain-data form for engine snapshots.  The wall-clock fields
        (``first_token_time``/``finish_time``) are ``perf_counter``
        readings, process-relative: they round-trip, but only latency
        within one process is meaningful."""
        return {
            "prompt": [int(t) for t in self.prompt],
            "max_new_tokens": self.max_new_tokens,
            "eos_id": self.eos_id,
            "arrival_time": self.arrival_time,
            "req_id": self.req_id,
            "generated": [int(t) for t in self.generated],
            "prefill_done": self.prefill_done,
            "slot": self.slot,
            "first_token_time": self.first_token_time,
            "finish_time": self.finish_time,
            "truncated": self.truncated,
            "priority": self.priority,
            "deadline": self.deadline,
            "expired": self.expired,
        }

    @classmethod
    def from_state(cls, d: Dict[str, Any]) -> "Request":
        req = cls(
            prompt=[int(t) for t in d["prompt"]],
            max_new_tokens=int(d["max_new_tokens"]),
            eos_id=None if d["eos_id"] is None else int(d["eos_id"]),
            arrival_time=float(d["arrival_time"]),
            req_id=int(d["req_id"]),
        )
        req.generated = [int(t) for t in d["generated"]]
        req.prefill_done = int(d["prefill_done"])
        req.slot = None if d["slot"] is None else int(d["slot"])
        req.first_token_time = d["first_token_time"]
        req.finish_time = d["finish_time"]
        req.truncated = bool(d["truncated"])
        req.priority = str(d["priority"])
        req.deadline = d["deadline"]
        req.expired = bool(d["expired"])
        advance_request_ids(req.req_id + 1)
        return req
