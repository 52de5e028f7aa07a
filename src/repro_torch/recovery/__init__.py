"""Crash recovery for the serving engine (counterpart of the snapshot part
of ``repro.recovery``): a JSON/npy codec with per-leaf sha256 and atomic
commits, and engine snapshot/restore on torch tensors."""

from .snapshot import list_snapshots, restore_engine_snapshot, save_engine_snapshot  # noqa: F401
