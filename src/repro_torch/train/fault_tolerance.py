"""Fault tolerance of the training driver (counterpart of
``repro.train.fault_tolerance``).

* :class:`StragglerMonitor`: the step-time EMA spike detector, shared
  with the serving health monitor (:mod:`repro_torch.faults.health`).
* :class:`FaultTolerantDriver`: runs the train step with periodic atomic
  checkpoints, restart from the latest good checkpoint on a failure,
  bounded restarts, and failure injection for tests.  On a mesh (given
  ``checkpoints=MeshCheckpoints(lm)``) every rank runs it: they save and
  restore together, from the same step.
* :func:`elastic_plan`: the (pods, data, model) mesh for a changed world
  size; a restore reads leaves on the host and places them anew.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from repro_torch.faults.health import StragglerMonitor  # noqa: F401  (the train-side name)

from .checkpoint import LocalCheckpoints, MeshCheckpoints, wait_for_async_saves


@dataclass
class DriverConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    async_ckpt: bool = False


class TrainingAborted(RuntimeError):
    pass


class FaultTolerantDriver:
    """Runs ``step_fn(state, step) -> (state, metrics)`` for ``n_steps``
    with checkpoint/restart semantics.  A failure raised by ``step_fn``
    (or injected through ``inject_failure_at``) restores the latest
    committed checkpoint that passes its checks and carries on, up to
    ``max_restarts`` times.

    ``step_fn`` may update the state's tensors in place, as the port's
    train step does: when the checkpoint directory holds no checkpoint,
    the initial state is saved as the one of its first step before any
    step runs, so that a restart never resumes from tensors a failed run
    has changed (the reference's functional step needs no such save).

    ``checkpoints`` defaults to one process's (:class:`LocalCheckpoints`,
    asynchronous with ``cfg.async_ckpt``).  With a
    :class:`MeshCheckpoints` every rank of a mesh runs the driver with the
    same arguments: the checkpoints are written in the one-process format,
    synchronously, and every rank restores the step global rank 0 chose.
    A failure injected at a step fires on every rank before the step's
    first collective, and the ranks restart together; any other failure
    is one rank's, which its peers cannot follow, and fails the run."""

    def __init__(self, step_fn: Callable, cfg: DriverConfig,
                 monitor: Optional[StragglerMonitor] = None,
                 checkpoints: Optional[Union[LocalCheckpoints, MeshCheckpoints]] = None):
        self.step_fn = step_fn
        self.cfg = cfg
        self.monitor = monitor or StragglerMonitor()
        self.checkpoints = checkpoints or LocalCheckpoints(cfg.async_ckpt)
        self.restarts = 0
        self.history: List[Dict] = []

    def _restore(self, state_like: Any) -> Tuple[Any, int]:
        restored = self.checkpoints.restore_latest(self.cfg.ckpt_dir, state_like)
        if restored is None:
            return state_like, 0
        step, state = restored
        return state, step

    def run(self, init_state: Any, n_steps: int,
            inject_failure_at: Optional[Dict[int, Exception]] = None) -> Tuple[Any, List[Dict]]:
        inject = dict(inject_failure_at or {})
        if self.checkpoints.latest(self.cfg.ckpt_dir) is None:
            self.checkpoints.save(self.cfg.ckpt_dir, 0, init_state)
            state, step = init_state, 0
        else:
            state, step = self._restore(init_state)
        while step < n_steps:
            injected = step in inject
            try:
                t0 = time.perf_counter()
                if injected:
                    raise inject.pop(step)  # fires once
                state, metrics = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                straggler = self.monitor.observe(step, dt)
                self.history.append({"step": step, "dt": dt, "straggler": straggler, **metrics})
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == n_steps:
                    self.checkpoints.save(self.cfg.ckpt_dir, step, state)
            except TrainingAborted:
                raise
            except Exception as e:  # noqa: BLE001  any failure of a step restarts
                if not (injected or self.checkpoints.restarts_any_failure):
                    raise
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise TrainingAborted(f"exceeded {self.cfg.max_restarts} restarts") from e
                state, step = self._restore(init_state)
                self.history.append({"step": step, "event": "restart", "error": repr(e)})
        wait_for_async_saves()
        return state, self.history


def elastic_plan(n_devices: int, model_parallel: int = 16, prefer_pods: int = 1) -> Dict[str, Any]:
    """The mesh layout for a changed world size: the model axis is kept
    (the weights' layout is unchanged, the cheapest reshard) and the data
    and pod axes scale."""
    if n_devices % model_parallel:
        raise ValueError(f"world size {n_devices} not divisible by model parallel {model_parallel}")
    data = n_devices // model_parallel
    pods = prefer_pods
    while pods > 1 and data % pods:
        pods -= 1
    data //= pods
    return {
        "mesh_shape": (pods, data, model_parallel) if pods > 1 else (data, model_parallel),
        "axes": ("pod", "data", "model") if pods > 1 else ("data", "model"),
        "reshard_params": False,  # model axis unchanged
        "reshard_data": True,
    }
