"""Engine snapshot/restore on torch tensors (counterpart of
``repro.recovery.snapshot``).

Format (a directory per snapshot):
    snap_<n>/
      manifest.json   snapshot version, leaf manifest (shape / logical dtype
                      / sha256 per leaf), state-blob sha256
      state.json      host-side runtime state (RNG, requests, cost table,
                      sieve flags, feed and health monitors, stats)
      leaf_<i>.npy    KV cache leaves, then the SieveState tensors, then
                      the decode step's fixed-address input buffers
      COMMITTED       written last (atomic commit marker)

What makes a restore bit-identical:

* the KV cache (or block pool) and the batch slots round-trip exactly
  (sha256 per leaf), so the next decode step reads the same attention
  state;
* the device ``SieveState`` tensors are snapshotted directly rather than
  re-exported from the restored cost table: mid-cadence table updates
  would otherwise make the re-export differ from what the uninterrupted
  run's step is reading;
* numpy's PCG64 RNG state round-trips exactly (its 128-bit words ride
  the codec's tagged integers);
* ``CostTable.version`` is restored verbatim (``load_state_dict`` alone
  bumps it), so the refresh cadence's version skip fires at the same
  steps;
* the TimingFeed's telemetry cursor and the engine's CUDA graph capture
  count are *not* restored: a restored engine has a fresh ring, and keeps
  its own graph.

On the card the engine's decode step may already be captured as a CUDA
graph, which holds the addresses of the KV cache, the ``SieveState`` and
the decode inputs.  A restore therefore copies into those tensors
(``copy_``) and never rebinds them, so the captured graph replays the
restored state and no new capture is made.

Every leaf and the state blob are verified against the manifest, and the
snapshot's layout against the engine's, before any engine field changes;
:func:`restore_engine_snapshot` walks back to the previous committed
snapshot (warning, ``n_fallbacks``) when the newest fails.
"""

from __future__ import annotations

import os
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.recovery.codec import (
    commit_dir,
    committed_dirs,
    is_committed,
    pack_state,
    read_leaf,
    sha256_bytes,
    to_storable,
    unpack_state,
    write_leaves,
)

SNAPSHOT_VERSION = 1
_SNAP_PREFIX = "snap_"

# times restore walked past a corrupt snapshot
n_fallbacks = 0


def _snap_path(snap_dir: str, snap_id: int) -> str:
    return os.path.join(snap_dir, f"{_SNAP_PREFIX}{snap_id:08d}")


def list_snapshots(snap_dir: str) -> List[Tuple[int, str]]:
    """Committed snapshots as ascending ``(snap_id, path)`` pairs."""
    return committed_dirs(snap_dir, _SNAP_PREFIX)


def latest_snapshot(snap_dir: str) -> Optional[int]:
    snaps = list_snapshots(snap_dir)
    return snaps[-1][0] if snaps else None


def _tree_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of nested dicts (by sorted key), lists and tuples."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_leaves(v)]
    raise TypeError(f"unexpected leaf type {type(tree)!r} in the engine's device state")


def _device_leaves(engine) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """The engine's device state: cache leaves, SieveState tensors and the
    decode step's input buffers, in snapshot order."""
    sieve = engine._sieve_state
    sieve_leaves = [] if sieve is None else [sieve.pim_time_by_count, sieve.params]
    inputs = [engine._decode_in[k] for k in sorted(engine._decode_in)]
    return _tree_leaves(engine.cache), sieve_leaves, inputs


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

_STATS = ("steps", "decode_tokens", "prefill_tokens", "wall_time", "dropped_tokens",
          "routed_tokens", "truncated_requests", "expired_requests", "shed_requests", "partitions")


def _gather_state(engine) -> Dict[str, Any]:
    """Host-side runtime state blob (everything except tensor leaves)."""
    sched = engine.sched
    state: Dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "rng": engine.rng.bit_generator.state,
        "requests": {
            "queue": [r.to_state() for r in sched.queue],
            "slots": [None if r is None else r.to_state() for r in sched.slots],
            "finished": [r.to_state() for r in sched.finished],
        },
        "sieve": {
            "version": engine._sieve_version,
            "gpu_only": engine._sieve_gpu_only,
            "refreshes": list(engine.sieve_refreshes),
        },
        "pim_healthy": engine.pim_healthy,
        "pending_tail_counts": sorted(engine._pending_tail_counts),
        "last_head_counts": list(engine._last_head_counts),
        "last_decode_batch": engine._last_decode_batch,
        "last_kv_depth": engine._last_kv_depth,
        "stats": {k: getattr(engine.stats, k) for k in _STATS},
    }
    if engine.paged is not None:
        # host-side block tables; the device pools ride along as cache leaves
        state["paged"] = engine.paged.state_dict()
    if engine.is_moe:
        ct = engine.cost_table
        state["cost_table"] = {
            "state": ct.state_dict(),
            "version": ct.version,
            "n_updates": ct.n_updates,
            "n_fallback_lookups": ct.n_fallback_lookups,
            "n_rejected": ct.n_rejected,
        }
    if engine._timing_feed is not None:
        state["timing_feed"] = engine._timing_feed.state_dict()
    if engine.health is not None:
        state["health"] = engine.health.state_dict()
    return state


def save_engine_snapshot(engine, snap_dir: str, snap_id: Optional[int] = None,
                         keep: Optional[int] = None) -> str:
    """Atomically snapshot ``engine``'s runtime state.

    ``snap_id`` defaults to the engine's step count.  ``keep`` prunes to
    the newest N committed snapshots after the write (the new one is
    committed first, so pruning never leaves only a torn write)."""
    if snap_id is None:
        snap_id = engine.stats.steps
    os.makedirs(snap_dir, exist_ok=True)
    cache, sieve, inputs = _device_leaves(engine)
    stored = [to_storable(t) for t in cache + sieve + inputs]
    state = _gather_state(engine)
    state["n_cache_leaves"] = len(cache)
    state["n_sieve_leaves"] = len(sieve)
    state["n_input_leaves"] = len(inputs)
    state_blob = pack_state(state)

    def _write(tmp: str) -> None:
        entries = write_leaves(tmp, stored)
        with open(os.path.join(tmp, "state.json"), "wb") as f:
            f.write(state_blob)
        manifest = {
            "snapshot_version": SNAPSHOT_VERSION,
            "snap_id": snap_id,
            "n_leaves": len(entries),
            "leaves": entries,
            "state_sha256": sha256_bytes(state_blob),
        }
        with open(os.path.join(tmp, "manifest.json"), "wb") as f:
            f.write(pack_state(manifest))

    final = commit_dir(_snap_path(snap_dir, snap_id), _write)
    if keep is not None and keep >= 1:
        for _, path in list_snapshots(snap_dir)[:-keep]:
            shutil.rmtree(path)
    return final


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _load_snapshot(path: str) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
    """Read and fully verify one snapshot: ``IOError`` on a checksum
    mismatch, ``FileNotFoundError`` on truncation, ``ValueError`` or
    ``KeyError`` on a malformed blob."""
    with open(os.path.join(path, "manifest.json"), "rb") as f:
        manifest = unpack_state(f.read())
    if manifest.get("snapshot_version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version {manifest.get('snapshot_version')!r}")
    with open(os.path.join(path, "state.json"), "rb") as f:
        state_blob = f.read()
    if sha256_bytes(state_blob) != manifest["state_sha256"]:
        raise IOError(f"state blob checksum mismatch in {path}")
    state = unpack_state(state_blob)
    leaves = [read_leaf(path, i, meta) for i, meta in enumerate(manifest["leaves"])]
    if len(leaves) != state["n_cache_leaves"] + state["n_sieve_leaves"] + state["n_input_leaves"]:
        raise ValueError(f"leaf count mismatch in {path}")
    return state, leaves


def _check_layout(engine, state: Dict[str, Any], leaves: List[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless the snapshot fits the engine: the same
    device leaves (count, shape, dtype), paged or not alike, the same pool
    geometry.  Runs before any engine field changes."""
    groups = _device_leaves(engine)
    counts = (state["n_cache_leaves"], state["n_sieve_leaves"], state["n_input_leaves"])
    for what, dsts, n in zip(("cache", "SieveState", "decode input"), groups, counts):
        if len(dsts) != n:
            raise ValueError(f"snapshot has {n} {what} leaves, the engine has {len(dsts)}")
    for dst, src in zip([t for g in groups for t in g], leaves):
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(
                f"snapshot leaf {tuple(src.shape)} {src.dtype} does not fit the engine's "
                f"{tuple(dst.shape)} {dst.dtype} (snapshot from another model or batching config?)"
            )
    paged_state = state.get("paged")
    if (paged_state is None) != (engine.paged is None):
        raise ValueError(
            "paged KV layout mismatch: snapshot "
            f"{'has' if paged_state is not None else 'lacks'} block-table state but the engine "
            f"{'lacks' if engine.paged is None else 'has'} a paged cache"
        )
    if paged_state is not None:
        engine.paged.check_state(paged_state)


def _apply(engine, state: Dict[str, Any], leaves: List[torch.Tensor]) -> None:
    """Move ``engine`` to the verified snapshot state, copying device state
    into the engine's own tensors."""
    from repro_torch.serving.request import Request

    # ---- device state: KV cache, SieveState (verbatim), decode inputs ----
    with torch.no_grad():
        for dst, src in zip([t for g in _device_leaves(engine) for t in g], leaves):
            dst.copy_(src)
    if engine.paged is not None:
        engine.paged.load_state_dict(state["paged"])
    sv = state["sieve"]
    engine._sieve_version = int(sv["version"])
    engine._sieve_gpu_only = bool(sv["gpu_only"])
    engine.sieve_refreshes = [int(s) for s in sv["refreshes"]]

    # ---- RNG (PCG64 words round-trip through tagged integers) ----
    engine.rng = np.random.default_rng()
    engine.rng.bit_generator.state = state["rng"]

    # ---- requests (queue / slots / finished) ----
    reqs = state["requests"]
    sched = engine.sched
    sched.queue.clear()
    sched.queue.extend(Request.from_state(d) for d in reqs["queue"])
    sched.slots = [None if d is None else Request.from_state(d) for d in reqs["slots"]]
    sched.finished = [Request.from_state(d) for d in reqs["finished"]]

    # ---- cost table (version verbatim: load_state_dict alone bumps it) ----
    ct = state.get("cost_table")
    if ct is not None:
        engine.cost_table.load_state_dict(ct["state"])
        engine.cost_table.version = int(ct["version"])
        engine.cost_table.n_updates = int(ct["n_updates"])
        engine.cost_table.n_fallback_lookups = int(ct["n_fallback_lookups"])
        engine.cost_table.n_rejected = int(ct["n_rejected"])

    # ---- measured loop + health ----
    if engine._timing_feed is not None and "timing_feed" in state:
        engine._timing_feed.load_state_dict(state["timing_feed"])
    if engine.health is not None and "health" in state:
        engine.health.load_state_dict(state["health"])
    engine.pim_healthy = bool(state["pim_healthy"])
    engine._pending_tail_counts = {int(n) for n in state["pending_tail_counts"]}
    engine._last_head_counts = [int(n) for n in state["last_head_counts"]]
    engine._last_decode_batch = int(state["last_decode_batch"])
    engine._last_kv_depth = int(state["last_kv_depth"])

    # ---- stats ----
    for k, v in state["stats"].items():
        setattr(engine.stats, k, list(v) if k == "partitions" else type(getattr(engine.stats, k))(v))


def restore_engine_snapshot(engine, snap_dir: str, snap_id: Optional[int] = None,
                            fallback: bool = True) -> int:
    """Restore ``engine`` from a snapshot; returns the snap id restored.

    With ``snap_id=None`` the newest committed snapshot is used, walking
    back past corrupt or truncated ones when ``fallback`` (warning and
    ``n_fallbacks``).  An explicit ``snap_id`` restores exactly that
    snapshot or raises.  A candidate that fails verification never leaves
    the engine half-restored."""
    global n_fallbacks
    if snap_id is not None:
        path = _snap_path(snap_dir, snap_id)
        if not is_committed(path):
            raise FileNotFoundError(f"snapshot at {path} is missing or uncommitted")
        candidates = [(snap_id, path)]
    else:
        candidates = list_snapshots(snap_dir)
        if not candidates:
            raise FileNotFoundError(f"no committed snapshots in {snap_dir}")
    last_err: Optional[Exception] = None
    for sid, path in reversed(candidates):
        try:
            state, leaves = _load_snapshot(path)
        except (IOError, ValueError, KeyError) as e:
            last_err = e
            if snap_id is not None or not fallback:
                raise
            n_fallbacks += 1
            warnings.warn(f"snapshot {path} failed verification ({e}); "
                          "falling back to the previous committed snapshot")
            continue
        _check_layout(engine, state, leaves)
        _apply(engine, state, leaves)
        return sid
    raise IOError(f"no snapshot in {snap_dir} restored cleanly") from last_err
