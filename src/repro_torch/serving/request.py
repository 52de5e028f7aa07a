"""Request structure for the serving engine (port's copy of
``repro.serving.request``; snapshot (de)serialisation joins with the
snapshot port)."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

_ids = itertools.count()


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    arrival_time: float = 0.0
    req_id: int = field(default_factory=lambda: next(_ids))
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
