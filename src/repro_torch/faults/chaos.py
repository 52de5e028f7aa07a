"""Chaos harness, engine scenarios (port's copy of the engine half of
``repro.faults.chaos``).

The engine scenarios (``probe-poison``, ``pim-brownout-engine``) drive a
real measured ``dual_path_cost`` :class:`repro_torch.serving.ServingEngine`
while a :attr:`StageProbes.corrupt` hook inflates or poisons the
stage-probe timings at scripted step indices, and record the health ->
quarantine -> GPU-only-fallback -> recovery trajectory plus the engine's
graph captures (the fallback must not capture the decode step again; the
JAX harness records its jit cache size under the same key).

The cluster scenarios (``pim-brownout``, ``replica-crash``,
``replica-crash-migrate``, ``link-flap``, ``straggler``) and
``windowed_goodput`` run the JAX package's cluster simulator, which the
port does not have yet (ROADMAP Queue 1 item 9): :func:`run_chaos` raises
for them.

Everything is seeded: the plan is a pure function of its arguments, and
with a deterministic probe hook and telemetry clock two runs give the
same summary.

Import discipline: this module is re-exported from ``repro_torch.faults``,
which the serving engine imports, so the engine and the model are
imported lazily inside :func:`run_engine_chaos`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .inject import FaultInjector
from .plan import FaultPlan, PIM_BROWNOUT, make_plan

# run by the JAX package's cluster simulator only (ROADMAP Queue 1 item 9)
_CLUSTER_SCENARIOS = (
    "pim-brownout",
    "replica-crash",
    "replica-crash-migrate",
    "link-flap",
    "straggler",
)
ENGINE_SCENARIOS = ("probe-poison", "pim-brownout-engine")
SCENARIOS = ENGINE_SCENARIOS


class EngineChaos:
    """Steps a measured-cost serving engine under a scripted probe fault.

    The plan's event times are *step indices*.  On a window start the
    harness installs a :attr:`StageProbes.corrupt` hook — ``pim_brownout``
    scales only the tail-GEMV probe durations (a PIM slowdown the health
    loop must detect and clamp to GPU-only); ``probe_poison`` scales every
    probe (a broken timer the feed's outlier gates must reject).  On the
    clear it removes the hook.  Each step appends a trajectory record of
    the health/fallback state and the engine's graph captures
    (``decode_cache``: 1 on the card once the first decode step has run,
    0 on the CPU, where every step is eager).
    """

    def __init__(self, engine, plan: FaultPlan):
        from repro_torch.telemetry.probes import TAIL_SPAN

        if engine._probes is None or engine._timing_feed is None:
            raise ValueError(
                "EngineChaos requires a measured-cost engine "
                "(cost_source='measured' with telemetry probes)"
            )
        self.engine = engine
        self.plan = plan
        self.injector = FaultInjector(plan)
        self.trajectory: List[Dict] = []
        self._tail_span = TAIL_SPAN
        self._mag = 1.0
        self._kind: Optional[str] = None

    # ---- corruption hook -------------------------------------------------
    def _corrupt(self, span_name: str, value: float, dt: float) -> float:
        if self._kind == PIM_BROWNOUT and span_name != self._tail_span:
            return dt
        return dt * self._mag

    def _apply(self, phase: str, ev) -> None:
        if phase == "start":
            self._kind = ev.kind
            self._mag = ev.magnitude
            self.engine._probes.corrupt = self._corrupt
        else:
            self._kind = None
            self._mag = 1.0
            self.engine._probes.corrupt = None

    # ---- stepping --------------------------------------------------------
    def step(self):
        """One engine step with due fault actions applied first."""
        k = self.engine.stats.steps
        for phase, ev in self.injector.pop_due(float(k)):
            self._apply(phase, ev)
        done = self.engine.step()
        eng = self.engine
        self.trajectory.append(
            {
                "step": k,
                "faulted": self._kind is not None,
                "healthy": eng.pim_healthy,
                "quarantined": eng._timing_feed.quarantined,
                "gpu_only": eng._sieve_gpu_only,
                "sieve_version": eng._sieve_version,
                "decode_cache": eng.n_captures,
                "feed_ok": eng._timing_feed.n_ok,
                "feed_rejected": eng._timing_feed.n_rejected,
            }
        )
        return done

    # ---- summary ---------------------------------------------------------
    def summary(self) -> Dict:
        traj = self.trajectory
        fault_t = min((ev.t for ev in self.plan.events), default=None)
        clear_t = max((ev.t_clear for ev in self.plan.events), default=None)

        def first(pred, recs):
            for r in recs:
                if pred(r):
                    return r["step"]
            return None

        detect = first(
            lambda r: not r["healthy"] and r["step"] >= (fault_t or 0), traj
        )
        gpu_only = first(
            lambda r: r["gpu_only"] and r["step"] >= (fault_t or 0), traj
        )
        recover = (
            first(
                lambda r: r["healthy"] and not r["gpu_only"]
                and r["step"] >= clear_t,
                traj,
            )
            if clear_t is not None
            else None
        )
        cache_at_fault = next(
            (r["decode_cache"] for r in traj if r["step"] >= (fault_t or 0)),
            None,
        )
        end = traj[-1] if traj else None
        return {
            "scenario": self.plan.scenario,
            "seed": self.plan.seed,
            "n_steps": len(traj),
            "fault_t": fault_t,
            "clear_t": clear_t,
            "detect_step": detect,
            "gpu_only_step": gpu_only,
            "recover_step": recover,
            "cache_at_fault": cache_at_fault,
            "cache_at_end": end["decode_cache"] if end else None,
            "cache_misses_after_fault": (
                end["decode_cache"] - cache_at_fault
                if end is not None and cache_at_fault is not None
                else None
            ),
            "restored": bool(
                end
                and end["healthy"]
                and not end["gpu_only"]
                and not end["quarantined"]
            ),
            "feed_rejected": end["feed_rejected"] if end else 0,
            "trajectory": traj,
        }


def run_engine_chaos(
    scenario: str,
    n_steps: int = 48,
    seed: int = 0,
    refresh: int = 4,
    n_slots: int = 4,
    magnitude: Optional[float] = None,
    telemetry=None,
    paged: bool = False,
    device="cuda",
) -> Dict:
    """Build a tiny measured ``dual_path_cost`` engine on ``device`` (the
    card unless the caller names the CPU), drive it for ``n_steps`` under
    ``scenario``, and return the recovery summary plus the generated
    tokens (the split is an equivalence-preserving schedule choice, so
    chaos must not change a single token against a fault-free run).

    The model is the reduced qwen3-moe proxy, in float32 on the CPU.  On
    the card it runs in bfloat16, the CUDA kernels' only type, with its
    head dim and expert width raised from 16 and 32 to 64: the smallest
    widths the decode-attention instances and the fused tail kernel take
    (``kernels/ops.py``).  Weights come from ``seed``."""
    import dataclasses as _dc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import LM
    from repro_torch.serving import BatchingConfig, Request, ServingEngine
    from repro_torch.telemetry import Telemetry

    if scenario not in ENGINE_SCENARIOS:
        raise ValueError(
            f"unknown engine scenario {scenario!r}; expected one of "
            f"{ENGINE_SCENARIOS}"
        )
    device = resolve_device(device)
    arch = get_arch("qwen3-moe-30b-a3b").reduced()
    moe = _dc.replace(arch.moe, expert_exec="dual_path_cost")
    dtype = torch.float32
    if device.type == "cuda":
        dtype = torch.bfloat16
        arch = _dc.replace(arch, attn=_dc.replace(arch.attn, d_head=64))
        moe = _dc.replace(moe, d_expert=64)
    arch = _dc.replace(arch, moe=moe)
    lm = LM(arch, dtype=dtype, device=device)
    params = lm.init(seed=seed)
    tel = telemetry or Telemetry(enabled=True, capacity=1 << 16)
    eng = ServingEngine(
        lm,
        params,
        BatchingConfig(n_slots=n_slots, max_seq=64, paged=paged, page_size=8),
        policy="sieve",
        telemetry=tel,
        cost_source="measured",
        sieve_refresh_every=refresh,
    )

    plan = make_plan(scenario, float(n_steps), seed=seed, magnitude=magnitude)
    chaos = EngineChaos(eng, plan)

    # keep the slots saturated: enough short requests to cover the run
    rng = np.random.default_rng(seed + 1)
    max_new = 6
    n_req = n_slots * (n_steps // max_new + 2)
    for _ in range(n_req):
        chaos.engine.submit(
            Request(
                prompt=[int(x) for x in rng.integers(1, 255, size=8)],
                max_new_tokens=max_new,
            )
        )
    tokens: List[List[int]] = []
    for _ in range(n_steps):
        for req in chaos.step():
            tokens.append(list(req.generated))

    out = chaos.summary()
    out["refresh"] = refresh
    out["paged"] = paged
    out["tokens"] = tokens
    return out


def run_chaos(scenario: str, **kwargs) -> Dict:
    """Run a named engine chaos scenario.  The cluster scenarios raise
    ``NotImplementedError``: they need the cluster simulator (ROADMAP
    Queue 1 item 9)."""
    if scenario in ENGINE_SCENARIOS:
        return run_engine_chaos(scenario, **kwargs)
    if scenario in _CLUSTER_SCENARIOS:
        raise NotImplementedError(
            f"cluster chaos scenario {scenario!r} needs the cluster simulator, "
            "which the port does not have yet (ROADMAP Queue 1 item 9)"
        )
    raise ValueError(
        f"unknown chaos scenario {scenario!r}; expected one of "
        f"{SCENARIOS + _CLUSTER_SCENARIOS}"
    )
