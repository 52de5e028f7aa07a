"""Crash recovery for the serving engine (counterpart of
``repro.recovery``): a JSON/npy codec with per-leaf sha256 and atomic
commits, engine snapshot/restore on torch tensors, and the recovery
journal's deterministic record and replay of recovery decisions."""

from .journal import RecoveryJournal, ReplayMismatch  # noqa: F401
from .snapshot import (  # noqa: F401
    SNAPSHOT_VERSION,
    latest_snapshot,
    list_snapshots,
    restore_engine_snapshot,
    save_engine_snapshot,
)
