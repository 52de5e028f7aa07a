"""Rank grids over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A :class:`Mesh` lays the ranks of the initialised default process group on
a grid of named axes, row-major, so with axes ``("data", "model")`` global
rank ``data_index * model_size + model_index``: the device order of
``jax.make_mesh((d, m), ("data", "model"))``.  :func:`mesh_info_for` turns
it into the :class:`~repro_torch.models.moe.MeshInfo` the model code reads,
and :func:`run_on_mesh` spawns the ranks of a mesh and runs a function on
each.

The backend and the device are the caller's to name: ``"gloo"`` for ranks
on the CPU or ranks that share one card, ``"nccl"`` for one card per rank.
Nothing here picks either on the caller's behalf.  ``make_production_mesh``
and ``use_mesh`` have no counterpart: there is no pod and no mesh context.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models.moe import MeshInfo

# the axes of a mesh by its rank, as the JAX tests name them
DEFAULT_AXES = {1: ("model",), 2: ("data", "model"), 3: ("pod", "data", "model")}


@dataclass
class Mesh:
    """This rank's place on a grid of ranks: its coordinate on each axis and
    the process group of every set of axes (the ranks that differ from it
    only on those axes).  A group of one rank is ``None``."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    backend: str
    device: torch.device
    rank: int
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[self.axes.index(a)] for a in axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *, backend: str,
              device) -> Mesh:
    """The grid ``shape`` over named ``axes`` on the default process group,
    which must be initialised with ``backend`` and hold ``prod(shape)``
    ranks.

    Every rank creates every group, in the same order (gloo hangs when a
    group is created by its members only), one per set of axes and index
    of the other axes: with ``("data", "model")`` one model group per data
    row and one data group per model column."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the group has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    device = resolve_device(device)
    rank = dist.get_rank()
    grid = list(itertools.product(*(range(n) for n in shape)))  # row-major: grid[r] is rank r
    coords = dict(zip(axes, grid[rank]))
    groups: Dict[Tuple[str, ...], Any] = {}
    for n_axes in range(1, len(axes) + 1):
        for over in itertools.combinations(range(len(axes)), n_axes):
            others = [i for i in range(len(axes)) if i not in over]
            for fixed in itertools.product(*(range(shape[i]) for i in others)):
                members = [r for r, c in enumerate(grid)
                           if all(c[i] == v for i, v in zip(others, fixed))]
                if len(members) == 1:
                    group = None
                elif len(members) == world:
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(members)
                if rank in members:
                    groups[tuple(axes[i] for i in over)] = group
    return Mesh(shape, axes, backend, device, rank, coords, groups)


def mesh_info_for(mesh: Mesh, global_batch: Optional[int] = None) -> MeshInfo:
    """The :class:`MeshInfo` of this rank, with the JAX rule for the batch:
    data axes are dropped (the pod axis first) until the global batch
    divides over the ones left; the batch is replicated over the rest."""
    model_axis = "model" if "model" in mesh.axes else None
    cand = tuple(a for a in ("pod", "data") if a in mesh.axes)
    if global_batch is not None:
        while cand and global_batch % mesh.size(cand):
            cand = cand[1:]
    data_index = 0
    for a in cand:
        data_index = data_index * mesh.size((a,)) + mesh.coords[a]
    model = (model_axis,) if model_axis else ()
    return MeshInfo(
        model_group=mesh.groups.get(model) if model else None,
        data_group=mesh.groups.get(cand) if cand else None,
        token_group=mesh.groups.get(cand + model) if cand + model else None,
        model_index=mesh.coords[model_axis] if model_axis else 0,
        data_index=data_index,
        ep_size=mesh.size(model) if model else 1,
        dp_size=mesh.size(cand) if cand else 1,
        backend=mesh.backend,
        device=mesh.device,
    )


def _rank_main(rank: int, world: int, fn: Callable, shape, axes, backend: str, devices,
               args: tuple, tmp: str, timeout_s: Optional[float]) -> None:
    device = torch.device(devices[rank] if isinstance(devices, (list, tuple)) else devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank, **kw)
    try:
        mesh = make_mesh(shape, axes, backend=backend, device=device)
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn: Callable, shape: Tuple[int, ...], backend: str,
                device: Union[str, Sequence[str]], *, axes: Optional[Tuple[str, ...]] = None,
                args: tuple = (), timeout_s: Optional[float] = None) -> list:
    """Spawn ``prod(shape)`` ranks with ``torch.multiprocessing``, join them in
    a ``backend`` process group (a ``file://`` rendezvous in a temporary
    directory), build the mesh and return each rank's ``fn(mesh, *args)``
    in rank order.  ``device`` is every rank's device, or a list with one
    per rank.  ``fn`` must be importable by name (a module-level function).
    A rank that raises makes the whole run raise with that rank's
    traceback, and the other ranks are stopped; ``timeout_s`` bounds each
    collective's wait (the backend's default otherwise), so a rank left
    waiting on a peer that will not come raises too."""
    axes = tuple(axes) if axes is not None else DEFAULT_AXES[len(shape)]
    world = math.prod(shape)
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(world, fn, tuple(shape), axes, backend, device, args, tmp, timeout_s),
            nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
