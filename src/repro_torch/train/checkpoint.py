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

A run on a mesh (:class:`MeshCheckpoints`) writes the same format: global
rank 0 writes the whole tree, each split leaf gathered over its model
group (``sharding.rank_join``), and every rank restores its part of a
whole tree (``sharding.rank_part``), so a checkpoint written on one mesh
restores on one process or on another mesh.

The port reads its own checkpoints, not the JAX package's (msgpack).
"""

from __future__ import annotations

import os
import shutil
import threading
import warnings
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import collectives as coll
from repro_torch.models.sharding import rank_join, rank_part, tp_axis
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


class LocalCheckpoints:
    """One process's checkpoints as the fault-tolerant driver calls them
    (:class:`MeshCheckpoints` is a mesh's): the functions above, the saves
    asynchronous with ``async_write``."""

    # any failure of a step restarts from the latest checkpoint
    restarts_any_failure = True

    def __init__(self, async_write: bool = False):
        self.async_write = async_write

    def latest(self, ckpt_dir: str) -> Optional[int]:
        return latest_step(ckpt_dir)

    def save(self, ckpt_dir: str, step: int, state: Any) -> None:
        save_checkpoint(ckpt_dir, step, state, async_write=self.async_write)

    def restore_latest(self, ckpt_dir: str, like: Any) -> Optional[Tuple[int, Any]]:
        # an asynchronous save still being written would be passed over for
        # an older step
        wait_for_async_saves()
        return restore_latest(ckpt_dir, like)


def _map_state(state: Any, whole: Any, fn, structure: str) -> Any:
    """``state`` with each leaf ``x`` replaced by ``fn(path, w, x)``: in a
    subtree of the parameter tree's ``structure`` (the parameters, the
    moments, the compression residual) ``path`` is the leaf's path in that
    tree and ``w`` the whole leaf of ``whole`` there, elsewhere (the step
    counter, a scalar residual) both are None."""
    if tr.structure(state) == structure:
        return tr.unflatten(state, [fn(path, w, x) for (path, x), w in
                                    zip(tr.leaves_with_paths(state), tr.leaves(whole))])
    children = tr.children(state)
    if not children:
        return fn(None, None, state)
    return tr.rebuild(state, [_map_state(c, whole, fn, structure) for _, c in children])


class MeshCheckpoints:
    """Checkpoints of a run on a mesh, in the one-process format.  ``lm`` is
    the rank's mesh ``LM``: its arch, its ``MeshInfo`` and the whole
    parameter tree's shapes (``LM.shapes()``).

    Every rank calls every method, in the same order.  :meth:`save`: the
    ranks of global rank 0's model group gather each split leaf of every
    parameter-shaped subtree, global rank 0 writes the whole tree, and all
    ranks wait for the commit.  :meth:`restore_latest`: global rank 0 finds
    the newest step that restores cleanly and every rank restores that
    step, cutting its part from the whole tree."""

    # a failure that is not injected on every rank is one rank's, which its
    # peers, waiting in a collective, cannot follow: it fails the run
    restarts_any_failure = False

    def __init__(self, lm):
        self.arch, self.mi = lm.arch, lm.mi
        self.whole = lm.shapes()
        self.structure = tr.structure(self.whole)

    def _first(self) -> bool:
        return dist.get_rank() == 0

    def _gathered(self, path, w, x):
        x = x.detach()
        m = self.mi.ep_size
        if path is None or tp_axis(path, w.shape, self.arch, m) is None:
            return x.cpu()
        parts = coll.all_gather(x, self.mi.model_group).cpu()
        return rank_join(list(parts), path, w.shape, self.arch, m)

    def save(self, ckpt_dir: str, step: int, state: Any) -> None:
        """Write the whole ``state`` (this rank's parts joined) for ``step``."""
        if self.mi.data_index == 0:
            whole = _map_state(state, self.whole, self._gathered, self.structure)
            if self._first():
                save_checkpoint(ckpt_dir, step, whole)
        dist.barrier()

    def latest(self, ckpt_dir: str) -> Optional[int]:
        """Global rank 0's :func:`latest_step`, on every rank."""
        box = [latest_step(ckpt_dir) if self._first() else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _whole_like(self, like: Any) -> Any:
        def meta(path, w, x):
            return torch.empty(x.shape if path is None else w.shape, dtype=x.dtype, device="meta")

        return _map_state(like, self.whole, meta, self.structure)

    def part(self, whole: Any, like: Any) -> Any:
        """This rank's part of a whole state (as :func:`restore_checkpoint`
        gives it), in the dtypes and on the devices of ``like`` (this
        rank's state), requiring grad where ``like`` does."""

        def part(path, w, x):
            return x if path is None else rank_part(x, path, self.arch, self.mi).clone()

        cut = _map_state(whole, self.whole, part, self.structure)
        return tr.tree_map(lambda t, ref: t.to(ref.device).requires_grad_(ref.requires_grad), cut, like)

    def restore(self, ckpt_dir: str, step: int, like: Any) -> Any:
        """This rank's part of the checkpoint of ``step``, in the structure,
        dtypes and devices of ``like`` (this rank's state)."""
        return self.part(restore_checkpoint(ckpt_dir, step, self._whole_like(like), device="cpu"), like)

    def restore_latest(self, ckpt_dir: str, like: Any) -> Optional[Tuple[int, Any]]:
        """``(step, this rank's part)`` of the newest checkpoint that global
        rank 0 restores cleanly (walking back as :func:`restore_latest`),
        the same step on every rank; None where there is none."""
        found = restore_latest(ckpt_dir, self._whole_like(like), device="cpu") if self._first() else None
        box = [None if found is None else found[0]]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return None
        return box[0], (self.part(found[1], like) if found else self.restore(ckpt_dir, box[0], like))
