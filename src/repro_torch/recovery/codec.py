"""Snapshot codec: per-leaf sha256 integrity + atomic commits (port's copy
of ``repro.recovery.codec``, on the standard library, numpy and torch
only).

* **leaf storage**: one numpy ``.npy`` per tensor leaf; bfloat16, which
  numpy cannot hold, is stored as its ``uint16`` bit pattern with the
  logical dtype recorded in the manifest;
* **integrity**: sha256 over the *stored* bytes of every leaf, verified
  on load; leaves are written, read and hashed on a few threads at once
  (file I/O and hashing release the interpreter lock);
* **atomic commit**: writers fill a ``<dir>.tmp`` staging directory,
  rename it into place, and write a ``COMMITTED`` marker last.  A killed
  writer leaves either the previous committed state or an uncommitted
  ``.tmp`` / marker-less directory that readers skip, never a torn mix;
* **state blobs**: JSON.  Integers outside the 64-bit range (the 128-bit
  words of numpy's PCG64 state) are written as ``{"__int__": "<decimal>"}``
  so any JSON reader keeps them exact; numpy scalars decay to Python
  numbers and tuples to lists.

The port does not read the JAX package's snapshots (msgpack blobs).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

COMMIT_MARKER = "COMMITTED"
_IO_THREADS = 8

# torch dtypes numpy cannot hold, stored as same-width integers
_VIEW_AS = {torch.bfloat16: (torch.int16, np.uint16)}
_LOGICAL = {str(dt).removeprefix("torch."): dt for dt in _VIEW_AS}


def to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host numpy array to store, logical dtype name) for one tensor."""
    t = t.detach().contiguous().cpu()
    name = str(t.dtype).removeprefix("torch.")
    view = _VIEW_AS.get(t.dtype)
    if view is not None:
        return t.view(view[0]).numpy().view(view[1]), name
    return t.numpy(), name


def from_storable(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    """CPU tensor of the logical dtype from a stored array."""
    dt = _LOGICAL.get(logical_dtype)
    if dt is not None:
        return torch.from_numpy(arr.view(np.int16)).view(dt)
    if str(arr.dtype) != logical_dtype:
        raise ValueError(f"stored dtype {arr.dtype} does not hold logical dtype {logical_dtype}")
    return torch.from_numpy(arr)


def sha256_array(arr: np.ndarray) -> str:
    """sha256 of the array's bytes in C order (hashed in place, no copy)."""
    return hashlib.sha256(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# Atomic directory commit (temp dir + rename + marker)
# ---------------------------------------------------------------------------


def commit_dir(final: str, write_fn: Callable[[str], Any]) -> str:
    """Atomically materialize a directory at ``final``: ``write_fn`` fills
    ``<final>.tmp``, which is renamed over ``final``; the ``COMMITTED``
    marker is written last.  If ``write_fn`` raises (or the process dies),
    readers that require the marker never see a partial write."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    write_fn(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(final, COMMIT_MARKER), "w") as f:
        f.write("ok\n")
    return final


def is_committed(path: str) -> bool:
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def committed_dirs(root: str, prefix: str) -> List[Tuple[int, str]]:
    """Committed ``<prefix><n>`` directories under ``root`` as ascending
    ``(n, path)`` pairs; torn writes are skipped."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if not name.startswith(prefix) or name.endswith(".tmp"):
            continue
        tail = name[len(prefix):]
        if not tail.isdigit():
            continue
        path = os.path.join(root, name)
        if is_committed(path):
            out.append((int(tail), path))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# Leaf I/O with manifest entries
# ---------------------------------------------------------------------------


def leaf_path(dirname: str, i: int) -> str:
    return os.path.join(dirname, f"leaf_{i:05d}.npy")


def _threaded(fn, items: list) -> list:
    """``[fn(x) for x in items]`` on up to ``_IO_THREADS`` threads, in order."""
    with ThreadPoolExecutor(max_workers=max(1, min(_IO_THREADS, len(items)))) as pool:
        return list(pool.map(fn, items))


def write_leaves(dirname: str, arrays: List[Tuple[np.ndarray, str]]) -> List[dict]:
    """Write ``leaf_<i>.npy`` per stored array; returns the manifest
    entries (shape, logical dtype, sha256 over the stored bytes)."""

    def one(i: int) -> dict:
        arr, logical = arrays[i]
        np.save(leaf_path(dirname, i), arr)
        return {"shape": list(arr.shape), "dtype": logical, "sha256": sha256_array(arr)}

    return _threaded(one, list(range(len(arrays))))


def read_leaf(dirname: str, i: int, meta: dict) -> torch.Tensor:
    """Load and verify one leaf against its manifest entry: ``IOError`` on
    a checksum mismatch, ``FileNotFoundError`` on a missing leaf file."""
    arr = np.load(leaf_path(dirname, i))
    if sha256_array(arr) != meta["sha256"]:
        raise IOError(f"checksum mismatch for leaf {i} in {dirname}")
    if list(arr.shape) != list(meta["shape"]):
        raise ValueError(f"leaf {i} in {dirname} has shape {arr.shape}, manifest {meta['shape']}")
    return from_storable(arr, meta["dtype"])


def read_leaves(dirname: str, metas: List[dict]) -> List[torch.Tensor]:
    """``read_leaf`` of every manifest entry, in order; the first failure
    raises."""
    return _threaded(lambda i: read_leaf(dirname, i, metas[i]), list(range(len(metas))))


# ---------------------------------------------------------------------------
# JSON state blobs
# ---------------------------------------------------------------------------

_INT_TAG = "__int__"
_I64 = 1 << 63


def _key(k) -> str:
    """JSON object keys are strings: integer keys (token counts) are
    written as decimals, which readers convert back."""
    return str(int(k)) if isinstance(k, (int, np.integer)) else str(k)


def _plain(obj):
    """Runtime state -> JSON-encodable structure (big ints tagged)."""
    if isinstance(obj, dict):
        return {_key(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        n = int(obj)
        return n if -_I64 <= n < _I64 else {_INT_TAG: str(n)}
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return _plain(obj.tolist())
    return obj


def _tagged(d: dict):
    if len(d) == 1 and _INT_TAG in d:
        return int(d[_INT_TAG])
    return d


def pack_state(state: Any) -> bytes:
    """JSON-encode a nested runtime-state structure.  Dict keys become
    strings (readers convert them back); floats round-trip exactly."""
    return json.dumps(_plain(state), sort_keys=True).encode()


def unpack_state(data: bytes) -> Any:
    try:
        return json.loads(data.decode(), object_hook=_tagged)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"malformed state blob: {e}") from e
