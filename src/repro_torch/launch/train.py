"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(counterpart of ``repro.launch.train``).

Runs the fault-tolerant training driver on the requested arch, reduced by
default (``--full`` for the published widths), on the card unless
``--device cpu`` is given: every family whose batches are tokens (the
decoder-only families, zamba2's hybrid and rwkv6's ssm).  An audio arch
raises: ``SyntheticLM`` makes no encoder frames.  It takes the reference
launcher's flags.

``--mesh DxM`` trains on a (data, model) mesh of ``D * M`` ranks spawned by
``launch.mesh.run_on_mesh``: on ``gloo`` (``--backend``, the default) the
ranks run on the CPU with ``--device cpu`` or share the cards round-robin,
on ``nccl`` each rank has a card of its own.  Every rank builds the global
batch of ``SyntheticLM`` at each step, and ``LM.loss`` takes its rows of it;
the checkpoints are the one-process format, written by global rank 0, and
rank 0 prints the reference's lines.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.launch.mesh import mesh_info_for, run_on_mesh
from repro_torch.models import LM
from repro_torch.models.moe import LOCAL_MESH
from repro_torch.train import (
    DriverConfig,
    FaultTolerantDriver,
    StragglerMonitor,
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.train.checkpoint import MeshCheckpoints
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.tree import leaves

# how long a rank of ``--mesh`` waits on a collective before the run fails
RANK_TIMEOUT_S = 600.0


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 => data=4, model=2")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the mesh's process group: gloo (CPU ranks, or ranks sharing cards) or nccl "
                         "(a card a rank)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _train(args, mesh=None):
    """The driver's run on one process, or on this rank of ``mesh``:
    returns the driver's history."""
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    mi = LOCAL_MESH if mesh is None else mesh_info_for(mesh, args.global_batch)
    device = args.device if mesh is None else mesh.device
    lm = LM(arch, dtype=torch.float32 if args.reduced else torch.bfloat16, device=device,
            remat=not args.reduced, mesh_info=mi)
    tc = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2), total_steps=args.steps),
        n_microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    params, opt, res = init_train_state(lm, 0, tc)
    first = mesh is None or mesh.rank == 0
    n_params = sum(p.numel() for p in leaves(lm.shapes()))
    where = f"device={lm.device}" if mesh is None else f"mesh={dict(zip(mesh.axes, mesh.shape))} device={lm.device}"
    if first:
        print(f"arch={arch.name} params={n_params / 1e6:.1f}M {where}", flush=True)

    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    step = make_train_step(lm, tc)

    def step_fn(state, i):
        p, o, r, m = step(state["params"], state["opt"], to_device(data.batch(i), lm.device), state["res"])
        metrics = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        if first and i % args.log_every == 0:
            print(f"step {i:5d} loss={metrics['loss']:.4f} gnorm={metrics['grad_norm']:.3f}", flush=True)
        return {"params": p, "opt": o, "res": r}, metrics

    driver = FaultTolerantDriver(step_fn, DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
                                 monitor=StragglerMonitor(),
                                 checkpoints=None if mesh is None else MeshCheckpoints(lm))
    t0 = time.time()
    _, hist = driver.run({"params": params, "opt": opt, "res": res}, args.steps)
    dt = time.time() - t0
    losses = [h["loss"] for h in hist if "loss" in h]
    trend = f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else "no step left to run"
    if first:
        print(f"done: {args.steps} steps in {dt:.1f}s; {trend}; "
              f"stragglers={len(driver.monitor.flagged)} restarts={driver.restarts}", flush=True)
    return hist


def _mesh_rank(mesh, args, threads: int):
    """One rank of ``--mesh``: its run of the driver, on ``threads`` of the
    launching process's threads."""
    torch.set_num_threads(threads)
    return _train(args, mesh)


def main(argv=None):
    """Parse ``argv`` and train; returns the driver's history (on a mesh,
    global rank 0's)."""
    args = _parse(argv)
    if get_arch(args.arch).family == "audio":
        raise ValueError(
            f"--arch {args.arch}: the audio family trains on encoder frames (batch['embeds'], "
            "(batch, frames, d_model)) beside its tokens and labels, and the synthetic data pipeline "
            "makes tokens only; the reference's launcher has no frame source either")
    if not args.mesh:
        return _train(args)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    world = shape[0] * shape[1]
    if args.device == "cpu":
        if args.backend != "gloo":
            raise ValueError("--device cpu runs the mesh on gloo")
        devices = "cpu"
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("--mesh on the card needs CUDA; pass --device cpu to run the ranks on the CPU")
        if args.backend == "nccl" and n < world:
            raise ValueError(f"--backend nccl needs a card a rank: {world} ranks, {n} cards")
        devices = [f"cuda:{r % n}" for r in range(world)]
    threads = max(1, torch.get_num_threads() // world)
    return run_on_mesh(_mesh_rank, shape, args.backend, devices, axes=("data", "model"),
                       args=(args, threads), timeout_s=RANK_TIMEOUT_S)[0]


if __name__ == "__main__":
    main()
