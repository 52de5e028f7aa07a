"""The port's fault plans, injector, health helpers, recovery journal and
engine chaos harness against the JAX package's.

No test reads the wall clock.  In both packages a test-side subclass of
``EngineChaos`` installs a pure ``probe_time(span, value)`` as the probes'
``corrupt`` hook from the first step, scales that base (not the measured
duration) inside a fault window and puts it back when the window clears;
both ``Telemetry`` objects get a fixed clock.  Each package's own
``run_engine_chaos`` runs with its module's class replaced by that
subclass, and the port's with the JAX engine's weights (through the
bridge), so the two trajectories must agree step for step.  The JAX
engine runs once per scenario (module fixture)."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import pin_threads

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.faults.chaos as jchaos  # noqa: E402
from repro.configs import get_arch as jget  # noqa: E402
from repro.faults import FaultEvent as JEvent, FaultInjector as JInjector, FaultPlan as JPlan  # noqa: E402
from repro.faults import HealthMonitor as JHealth, make_plan as jmake_plan  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.recovery import RecoveryJournal as JJournal, ReplayMismatch as JMismatch  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402

import repro_torch.faults.chaos as tchaos  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core.cost_model import CostModel, MoELayerSpec, b200_pim_system  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    ENGINE_SCENARIOS, FAILED, FaultEvent, FaultInjector, FaultPlan, HealthMonitor, make_plan, run_chaos,
)
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.recovery import RecoveryJournal, ReplayMismatch  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402
from repro_torch.telemetry.probes import TAIL_SPAN  # noqa: E402

N_STEPS, REFRESH = 28, 4  # tests/test_faults.py's engine chaos runs
CLUSTER_SCENARIOS = ("pim-brownout", "replica-crash", "replica-crash-migrate", "link-flap", "straggler")


def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events]


# ---------------------------------------------------------------------------
# Plans, injector, health helpers, journal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", CLUSTER_SCENARIOS + ENGINE_SCENARIOS)
def test_make_plan_matches_jax(scenario):
    for seed in range(4):
        for kw in ({}, {"magnitude": 3.0}, {"n_replicas": 5}):
            jp, tp = jmake_plan(scenario, 20.0, seed=seed, **kw), make_plan(scenario, 20.0, seed=seed, **kw)
            assert _events(jp) == _events(tp)
            assert (jp.scenario, jp.seed, jp.describe()) == (tp.scenario, tp.seed, tp.describe())
            assert [(t, ph, dataclasses.astuple(e)) for t, ph, e in jp.timeline()] == \
                [(t, ph, dataclasses.astuple(e)) for t, ph, e in tp.timeline()]
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        make_plan("solar-flare", 8.0)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan(events=(FaultEvent(t=0.0, kind="meteor"),))
    with pytest.raises(ValueError, match="duration"):
        FaultPlan(events=(FaultEvent(t=0.0, kind="straggle", duration=-1.0),))


@pytest.mark.parametrize("scenario", ["link-flap", "replica-crash", "probe-poison"])
def test_fault_injector_matches_jax(scenario):
    """The same plan popped at the same ticks gives the same actions,
    active windows and applied log."""
    jinj, tinj = JInjector(jmake_plan(scenario, 10.0, seed=3)), FaultInjector(make_plan(scenario, 10.0, seed=3))
    for now in np.linspace(0.0, 11.0, 45):
        assert jinj.next_time() == tinj.next_time()
        jd, td = jinj.pop_due(float(now)), tinj.pop_due(float(now))
        assert [(ph, dataclasses.astuple(e)) for ph, e in jd] == [(ph, dataclasses.astuple(e)) for ph, e in td]
        assert [dataclasses.astuple(e) for e in jinj.active()] == [dataclasses.astuple(e) for e in tinj.active()]
        assert len(jinj.active("link_degrade")) == len(tinj.active("link_degrade"))
    assert jinj.exhausted and tinj.exhausted and tinj.next_time() is None
    assert jinj.timeline_log() == tinj.timeline_log()
    # a zero-length window: its clear and start share one tick
    jd = JInjector(JPlan(events=(JEvent(t=1.0, kind="straggle"),))).pop_due(1.0)
    td = FaultInjector(FaultPlan(events=(FaultEvent(t=1.0, kind="straggle"),))).pop_due(1.0)
    assert [(ph, dataclasses.astuple(e)) for ph, e in jd] == [(ph, dataclasses.astuple(e)) for ph, e in td]


def test_health_monitor_helpers_match_jax():
    """One observation sequence (drift, staleness, an explicit failure
    and recovery, three targets) through both monitors: the same
    statuses, census, transitions and detect/clear times."""
    kw = dict(threshold=4.0, alpha=0.2, warmup=1, confirm=2, recover=2, stale_after=2, max_transitions=16)
    jm, tm = JHealth(**kw), HealthMonitor(**kw)
    rng = np.random.default_rng(0)
    for step in range(60):
        t = float(step)
        value = 1.0 + 0.1 * rng.random() + (10.0 if 15 <= step < 22 else 0.0)
        counter = float(step // 3 if not 30 <= step < 40 else 10)
        for mon in (jm, tm):
            mon.observe("replica-0", value, t=t)
            mon.observe("replica-1", 1.0, t=t)
            mon.watch("cost_feed", counter, t=t)
            if step == 45:
                mon.mark_failed("replica-1", t=t, reason="crash")
            if step == 50:
                mon.observe("replica-1", 50.0, t=t)  # a failed target ignores drift
            if step == 55:
                mon.mark_recovered("replica-1", t=t)
        for target in ("replica-0", "replica-1", "cost_feed"):
            assert jm.status(target) == tm.status(target)
            assert jm.is_healthy(target) == tm.is_healthy(target)
        assert jm.status_counts() == tm.status_counts() and jm.status_counts("replica") == tm.status_counts("replica")
        if step == 47:
            assert tm.status_counts("replica")[FAILED] == 1
    assert jm.targets() == tm.targets() == ["cost_feed", "replica-0", "replica-1"]
    assert [dataclasses.astuple(x) for x in jm.transitions] == [dataclasses.astuple(x) for x in tm.transitions]
    assert jm.n_transitions_dropped == tm.n_transitions_dropped
    for target in tm.targets():
        for t in (0.0, 14.0, 20.0, 31.0, 44.0, 60.0):
            assert jm.time_to_detect(target, t) == tm.time_to_detect(target, t)
            assert jm.time_to_clear(target, t) == tm.time_to_clear(target, t)
    assert tm.time_to_detect("replica-1", 45.0) == 0.0 and tm.time_to_clear("replica-1", 45.0) == 10.0
    assert jm.state_dict() == tm.state_dict()


def _journal_entries(journal) -> None:
    journal.record(0.5, "crash_detected", replica=1)
    journal.record(0.5, "migrate", req=7, src=1, dst=0, pages=12)
    journal.record(0.75, "backoff", req=9, delay=0.0125)
    journal.record(0.9, "cold_redispatch", req=9, attempt=2)
    journal.record(1.25, "drop", req=11, big=2**70)


def test_recovery_journal_matches_jax(tmp_path):
    """Record, ``to_dict``, replay and its mismatches on the same entries;
    the port's save/load goes through its JSON codec."""
    jj, tj = JJournal(), RecoveryJournal()
    _journal_entries(jj)
    _journal_entries(tj)
    assert jj.to_dict() == tj.to_dict() and len(jj) == len(tj) == 5
    assert tj == RecoveryJournal.from_dict(jj.to_dict())
    loaded = RecoveryJournal.load(tj.save(str(tmp_path / "journal.json")))
    assert loaded == tj and loaded.entries[-1]["big"] == 2**70
    for journal in (jj, tj):
        journal.start_replay()
        assert journal.peek_kind() == "crash_detected"
        assert journal.record(0.5, "crash_detected", replica=1)["replica"] == 1  # replay consumes
        assert journal.expect(0.5, "migrate")["dst"] == 0
    for journal, mismatch in ((jj, JMismatch), (tj, ReplayMismatch)):
        with pytest.raises(mismatch, match="diverged"):
            journal.expect(0.8, "backoff")
        with pytest.raises(mismatch, match="unconsumed"):
            journal.finish_replay()
    replayed = RecoveryJournal.from_dict(tj.to_dict()).start_replay()
    for e in tj.entries:
        replayed.expect(e["t"], e["kind"])
    replayed.finish_replay()
    assert replayed.peek_kind() is None
    with pytest.raises(ReplayMismatch, match="exhausted"):
        replayed.expect(2.0, "drop")
    with pytest.raises(ValueError, match="version"):
        RecoveryJournal.from_dict({"version": 0, "entries": []})


# ---------------------------------------------------------------------------
# Engine chaos
# ---------------------------------------------------------------------------

# the roofline time of one tail token on the reduced proxy's cost model;
# probe times are set relative to it
_ARCH = jget("qwen3-moe-30b-a3b").reduced()
T1 = CostModel(system=b200_pim_system(), layer=MoELayerSpec(
    d_model=_ARCH.d_model, d_ff=_ARCH.moe.d_expert, n_experts=_ARCH.moe.n_experts,
    top_k=_ARCH.moe.top_k)).t_pim_gemv_roofline(1)


def probe_time(name: str, value: float) -> float:
    """The probes' deterministic "measurement": a pure function of span
    name and value."""
    if name == TAIL_SPAN:
        return 3 * T1 * (1 + 0.5 * (value - 1))
    return 1e-5 * (1 + value / 64)


def _deterministic(cls):
    """``cls`` (either package's ``EngineChaos``) on ``probe_time``: the
    base is installed from the first step and between fault windows, and
    a window scales it instead of the measured duration."""

    class Deterministic(cls):
        def __init__(self, engine, plan):
            super().__init__(engine, plan)
            engine._probes.corrupt = self._base

        def _base(self, span_name, value, dt):
            return probe_time(span_name, value)

        def _corrupt(self, span_name, value, dt):
            return super()._corrupt(span_name, value, probe_time(span_name, value))

        def _apply(self, phase, ev):
            super()._apply(phase, ev)
            if phase != "start":
                self.engine._probes.corrupt = self._base

    return Deterministic


def _fixed_clock():
    return 0


def _jax_run(scenario: str, **kw) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jchaos, "EngineChaos", _deterministic(jchaos.EngineChaos))
        return jchaos.run_engine_chaos(scenario, n_steps=N_STEPS, seed=0, refresh=REFRESH,
                                       telemetry=JTelemetry(capacity=1 << 16, clock=_fixed_clock), **kw)


def _torch_run(scenario: str, params, via_dispatch: bool = False, **kw) -> dict:
    run = run_chaos if via_dispatch else tchaos.run_engine_chaos
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchaos, "EngineChaos", _deterministic(tchaos.EngineChaos))
        mp.setattr(TLM, "init", lambda self, seed: params)
        return run(scenario, n_steps=N_STEPS, seed=0, refresh=REFRESH, device="cpu",
                   telemetry=Telemetry(capacity=1 << 16, clock=_fixed_clock), **kw)


@pytest.fixture(scope="module")
def chaos_runs():
    """Per scenario: the JAX and port runs on the dense layout, the port's
    on the paged pool; and one fault-free (x1) paged control."""
    arch = dataclasses.replace(_ARCH, moe=dataclasses.replace(_ARCH.moe, expert_exec="dual_path_cost"))
    jparams = JLM(arch, dtype=jnp.float32).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)
    out = {}
    for i, scenario in enumerate(ENGINE_SCENARIOS):
        out[scenario] = dict(
            jax=_jax_run(scenario),
            dense=_torch_run(scenario, tparams, via_dispatch=i == 0),
            paged=_torch_run(scenario, tparams, paged=True),
        )
    out["paged_control"] = _torch_run("pim-brownout-engine", tparams, paged=True, magnitude=1.0)
    return out


TRAJECTORY_KEYS = ("step", "faulted", "healthy", "quarantined", "gpu_only", "sieve_version", "feed_ok",
                   "feed_rejected")
SUMMARY_KEYS = ("scenario", "seed", "n_steps", "fault_t", "clear_t", "detect_step", "gpu_only_step",
                "recover_step", "restored", "feed_rejected", "refresh", "paged", "tokens")


@pytest.mark.parametrize("scenario", ENGINE_SCENARIOS)
def test_engine_chaos_matches_jax(chaos_runs, scenario):
    """Dense layout: the port's summary, health trajectory and tokens are
    the JAX harness's."""
    j, t = chaos_runs[scenario]["jax"], chaos_runs[scenario]["dense"]
    assert {k: t[k] for k in SUMMARY_KEYS} == {k: j[k] for k in SUMMARY_KEYS}
    assert [tuple(r[k] for k in TRAJECTORY_KEYS) for r in t["trajectory"]] == \
        [tuple(r[k] for k in TRAJECTORY_KEYS) for r in j["trajectory"]]
    # every step is eager on the CPU: no capture, none added by the fault
    assert (t["cache_at_end"], t["cache_misses_after_fault"]) == (0, 0)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("scenario", ENGINE_SCENARIOS)
def test_engine_chaos_detects_clamps_and_restores(chaos_runs, scenario, layout):
    """tests/test_faults.py's assertions on the port's runs; the paged
    run's tokens equal its fault-free control's."""
    r = chaos_runs[scenario][layout]
    assert r["gpu_only_step"] is not None and r["gpu_only_step"] - r["fault_t"] <= REFRESH
    assert r["detect_step"] is not None and r["recover_step"] is not None and r["restored"]
    assert r["cache_misses_after_fault"] == 0
    for rec in r["trajectory"]:
        assert rec["quarantined"] == rec["gpu_only"]
    if scenario == "probe-poison":
        assert r["feed_rejected"] > 0
    if layout == "paged":
        assert r["paged"] and r["tokens"] == chaos_runs["paged_control"]["tokens"]
        assert chaos_runs["paged_control"]["gpu_only_step"] is None


def test_run_chaos_dispatch():
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        run_chaos("replica-crash")
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        run_chaos("solar-flare")
    with pytest.raises(ValueError, match="unknown engine scenario"):
        tchaos.run_engine_chaos("replica-crash", device="cpu")
    with pytest.raises(ValueError, match="measured-cost engine"):
        tchaos.EngineChaos(type("Engine", (), {"_probes": None, "_timing_feed": None})(),
                           make_plan("probe-poison", 8.0))
