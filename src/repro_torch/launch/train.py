"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(counterpart of ``repro.launch.train``).

Runs the fault-tolerant training driver on the requested arch, reduced by
default (``--full`` for the published widths), on the card unless
``--device cpu`` is given: every family whose batches are tokens (the
decoder-only families, zamba2's hybrid and rwkv6's ssm).  An audio arch
raises: ``SyntheticLM`` makes no encoder frames.  It takes the reference
launcher's flags; ``--mesh`` (data- and tensor-parallel training) is not
ported and raises.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.models import LM
from repro_torch.train import (
    DriverConfig,
    FaultTolerantDriver,
    StragglerMonitor,
    TrainConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.tree import leaves


def main(argv=None):
    """Parse ``argv`` and train; returns the driver's history."""
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
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 => data=4, model=2 (not ported)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh: data- and tensor-parallel training are not ported (ROADMAP Queue 1); the "
            "port trains on one device")
    arch = get_arch(args.arch)
    if arch.family == "audio":
        raise ValueError(
            f"--arch {args.arch}: the audio family trains on encoder frames (batch['embeds'], "
            "(batch, frames, d_model)) beside its tokens and labels, and the synthetic data pipeline "
            "makes tokens only; the reference's launcher has no frame source either")
    if args.reduced:
        arch = arch.reduced()
    lm = LM(arch, dtype=torch.float32 if args.reduced else torch.bfloat16, device=args.device,
            remat=not args.reduced)
    tc = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2), total_steps=args.steps),
        n_microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    )
    params, opt, res = init_train_state(lm, 0, tc)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={arch.name} params={n_params / 1e6:.1f}M device={lm.device}")

    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                                  global_batch=args.global_batch))
    step = make_train_step(lm, tc)

    def step_fn(state, i):
        p, o, r, m = step(state["params"], state["opt"], to_device(data.batch(i), lm.device), state["res"])
        metrics = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        if i % args.log_every == 0:
            print(f"step {i:5d} loss={metrics['loss']:.4f} gnorm={metrics['grad_norm']:.3f}", flush=True)
        return {"params": p, "opt": o, "res": r}, metrics

    driver = FaultTolerantDriver(step_fn, DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
                                 monitor=StragglerMonitor())
    t0 = time.time()
    _, hist = driver.run({"params": params, "opt": opt, "res": res}, args.steps)
    dt = time.time() - t0
    losses = [h["loss"] for h in hist if "loss" in h]
    trend = f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else "no step left to run"
    print(f"done: {args.steps} steps in {dt:.1f}s; {trend}; "
          f"stragglers={len(driver.monitor.flagged)} restarts={driver.restarts}")
    return hist


if __name__ == "__main__":
    main()
