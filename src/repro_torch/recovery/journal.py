"""RecoveryJournal: a deterministic record of recovery decisions (port's
copy of ``repro.recovery.journal``, saved through the port's JSON codec).

The cluster event loop makes a handful of non-local decisions when a
replica dies: when the crash was detected, which surviving replica each
orphan's KV pages migrate to, what backoff delay each cold re-dispatch
drew, and which requests were finally dropped.  The journal records every
one of them as a ``(t, kind, data)`` entry, giving three things:

* **audit** — the JAX package's ``cluster_bench --chaos`` writes the
  journal next to the report, so a failed recovery gate can be traced
  decision by decision;
* **determinism pinning** — two same-seed chaos runs must produce
  byte-identical journals (pinned in tests);
* **replay** — a journal switched into replay mode *drives* a second run:
  at each decision point the simulator consumes the recorded entry
  (asserting the kind and time line up) instead of recomputing it, so a
  captured production incident can be re-stepped bit-identically under a
  debugger even if the surrounding code's tie-breaking has changed.

Entries are plain JSON-serializable dicts; the module imports neither
torch nor a cluster layer at import time, so it stays importable from
anywhere.  :meth:`RecoveryJournal.save` writes them with
:func:`repro_torch.recovery.codec.pack_state` (integers outside 64 bits
kept exact), and :meth:`RecoveryJournal.load` reads them back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# decision kinds recorded by the cluster simulator's recovery path
CRASH_DETECTED = "crash_detected"
MIGRATE = "migrate"  # warm KV handoff scheduled to a surviving replica
COLD_REDISPATCH = "cold_redispatch"  # progress reset + backoff re-dispatch
BACKOFF = "backoff"  # jittered exponential delay drawn for a retry
DROP = "drop"  # retry budget exhausted
EXPIRED = "expired"  # deadline passed while awaiting re-dispatch

JOURNAL_VERSION = 1


class ReplayMismatch(AssertionError):
    """A replayed run diverged from the journal it was replaying."""


class RecoveryJournal:
    """Append-only decision log with an optional replay cursor."""

    def __init__(self, entries: Optional[List[Dict[str, Any]]] = None):
        self.entries: List[Dict[str, Any]] = list(entries or [])
        self.replaying = False
        self._cursor = 0

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RecoveryJournal) and self.entries == other.entries
        )

    # ---- recording -------------------------------------------------------
    def record(self, t: float, kind: str, **data) -> Dict[str, Any]:
        """Append one decision (no-op passthrough of recorded data while
        replaying — replay consumes, never re-records)."""
        if self.replaying:
            return self.expect(t, kind, **data)
        entry = {"t": float(t), "kind": kind, **data}
        self.entries.append(entry)
        return entry

    # ---- replay ----------------------------------------------------------
    def start_replay(self) -> "RecoveryJournal":
        self.replaying = True
        self._cursor = 0
        return self

    def peek_kind(self) -> Optional[str]:
        """Kind of the next entry to be consumed during replay (None when
        exhausted).  Lets the replaying event loop branch on the *recorded*
        decision instead of recomputing it."""
        if self._cursor >= len(self.entries):
            return None
        return self.entries[self._cursor]["kind"]

    def expect(self, t: float, kind: str, **data) -> Dict[str, Any]:
        """Consume the next entry; it must match ``kind`` (and ``t`` within
        float tolerance).  Returns the recorded entry — the caller adopts
        any recorded decision fields (e.g. the migration target) instead of
        recomputing them."""
        if self._cursor >= len(self.entries):
            raise ReplayMismatch(
                f"journal exhausted at decision ({t:.6g}, {kind})"
            )
        entry = self.entries[self._cursor]
        self._cursor += 1
        if entry["kind"] != kind or abs(entry["t"] - t) > 1e-9:
            raise ReplayMismatch(
                f"journal diverged: recorded ({entry['t']:.6g}, "
                f"{entry['kind']}), replay reached ({t:.6g}, {kind})"
            )
        return entry

    def finish_replay(self) -> None:
        """Assert the replayed run consumed the whole journal."""
        if self._cursor != len(self.entries):
            raise ReplayMismatch(
                f"replay ended with {len(self.entries) - self._cursor} "
                f"unconsumed journal entries"
            )

    # ---- (de)serialization ----------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"version": JOURNAL_VERSION, "entries": self.entries}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RecoveryJournal":
        if d.get("version") != JOURNAL_VERSION:
            raise ValueError(
                f"unsupported journal version {d.get('version')!r}"
            )
        return cls(entries=d["entries"])

    def save(self, path: str) -> str:
        from .codec import pack_state

        with open(path, "wb") as f:
            f.write(pack_state(self.to_dict()))
        return path

    @classmethod
    def load(cls, path: str) -> "RecoveryJournal":
        from .codec import unpack_state

        with open(path, "rb") as f:
            return cls.from_dict(unpack_state(f.read()))
