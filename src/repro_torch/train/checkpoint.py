"""Training checkpoints: save and restore with per-leaf integrity hashes
and atomic commits (counterpart of ``repro.train.checkpoint``), on the
port's snapshot codec (:mod:`repro_torch.recovery.codec`).

Format (one directory per step):

    step_<n>/
      manifest.json   step, tree structure, per-leaf shape, dtype, sha256
      leaf_<i>.npy    one array per leaf (bfloat16 as its uint16 bits)
      COMMITTED       written last (the atomic commit marker)

* atomic commit: a writer fills ``step_<n>.tmp`` and renames it into
  place; a killed writer never leaves a torn checkpoint that readers take;
* integrity: sha256 of every leaf, verified on load;
* restore onto any device: leaves are read on the host and moved to the
  target device (and dtype) of the ``like`` tree or the given device;
* async save: the host copy is taken before the call returns (the train
  step updates its tensors in place afterwards); the writing and hashing
  run on a background thread;
* corruption fallback: :func:`restore_latest` walks back past a newest
  step that fails its checks, with a warning.

The port reads its own checkpoints, not the JAX package's (msgpack).
"""

from __future__ import annotations

import os
import shutil
import threading
import warnings
from typing import Any, Optional, Tuple

import torch

from repro_torch.recovery.codec import (
    COMMIT_MARKER,
    committed_dirs,
    pack_state,
    read_leaves,
    to_storable,
    unpack_state,
    write_leaves,
)
from . import tree as tr

_STEP_PREFIX = "step_"
_MANIFEST = "manifest.json"
_ASYNC_TAG = "_repro_torch_ckpt"


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{_STEP_PREFIX}{step:08d}")


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    async_write: bool = False,
    _fault_injection: Optional[int] = None,
) -> str:
    """Write ``tree`` (parameters, optimizer state, anything) for ``step``.

    ``_fault_injection``: test hook, stop after writing that many leaves,
    as a writer killed mid-write would (no commit marker)."""
    final = step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tr.leaves(tree)
    # a copy on the host now: the caller may update the tensors in place
    host = [to_storable(t.detach().to("cpu", copy=True)) for t in leaves]
    shape = tr.structure(tree)

    def _write():
        stored = host if _fault_injection is None else host[:_fault_injection]
        entries = write_leaves(tmp, stored)
        if _fault_injection is not None:
            return  # the simulated crash: no manifest, no commit
        with open(os.path.join(tmp, _MANIFEST), "wb") as f:
            f.write(pack_state({"step": step, "structure": shape, "n_leaves": len(host),
                                "leaves": entries}))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(final, COMMIT_MARKER), "w") as f:
            f.write("ok\n")

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        setattr(t, _ASYNC_TAG, True)
        t.start()
    else:
        _write()
    return final


def wait_for_async_saves() -> None:
    for t in threading.enumerate():
        if getattr(t, _ASYNC_TAG, False):
            t.join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The latest committed step (torn writes are ignored), or None."""
    steps = committed_dirs(ckpt_dir, _STEP_PREFIX)
    return steps[-1][0] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any, device=None) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``, each leaf
    of its ``like`` leaf's dtype, on ``device`` (default: the ``like``
    leaf's device; ``like`` may be on the ``"meta"`` device when
    ``device`` is given), requiring grad where the ``like`` leaf does.

    Raises ``FileNotFoundError`` for a missing or uncommitted step,
    ``IOError`` for a leaf whose sha256 does not match, ``ValueError`` for
    another tree or other shapes."""
    d = step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(d, COMMIT_MARKER)):
        raise FileNotFoundError(f"checkpoint at {d} is missing or uncommitted")
    with open(os.path.join(d, _MANIFEST), "rb") as f:
        manifest = unpack_state(f.read())
    refs = tr.leaves(like)
    if manifest["n_leaves"] != len(refs) or manifest["structure"] != tr.structure(like):
        raise ValueError(f"checkpoint at {d} holds another tree ({manifest['n_leaves']} leaves, "
                         f"target {len(refs)})")
    out = []
    for i, (ref, t) in enumerate(zip(refs, read_leaves(d, manifest["leaves"]))):
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)} != target {tuple(ref.shape)}")
        t = t.to(device=ref.device if device is None else device, dtype=ref.dtype)
        out.append(t.requires_grad_(True) if ref.requires_grad else t)
    return tr.unflatten(like, out)


def restore_latest(ckpt_dir: str, like: Any, device=None) -> Optional[Tuple[int, Any]]:
    """``(step, tree)`` of the newest committed checkpoint that restores
    cleanly, walking back past corrupt or truncated ones with a warning
    (one bad checkpoint costs a few replayed steps, not the run); None if
    none does."""
    for step, path in reversed(committed_dirs(ckpt_dir, _STEP_PREFIX)):
        try:
            return step, restore_checkpoint(ckpt_dir, step, like, device)
        except (IOError, ValueError) as e:  # FileNotFoundError is an IOError
            warnings.warn(f"checkpoint {path} failed to restore ({e}); falling back to the "
                          "previous committed step")
    return None
