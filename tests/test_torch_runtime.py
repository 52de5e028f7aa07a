"""The port's runtime loop against the JAX engine's on the qwen3-moe proxy:
telemetry, the measured cost loop, the PIM health gate, brownout and
admission, seeded sampling, and snapshot/restore.

No test reads the wall clock.  Both packages' ``StageProbes`` get the same
``corrupt`` hook, a pure function of span name and value that replaces
every measured duration, and both ``Telemetry`` objects a fixed clock, so
the measured loop moves the same way in both.  Each scenario's JAX engine
runs once (module-scoped fixtures).  Integers and tokens are held exactly,
the cost table's export bitwise, other floats at rtol = atol = 1e-5
(tests/test_fused_swiglu.py:49).
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from _torch_port import F32_TOL, pin_threads, proxy_arch

pin_threads()
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget  # noqa: E402
from repro.core.cost_table import CostTable as JCostTable  # noqa: E402
from repro.faults.health import HealthMonitor as JHealth  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.serving import BatchingConfig as JBatching, Request as JRequest  # noqa: E402
from repro.serving import PagedKVCache as JPaged, ServingEngine as JEngine  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry, TimingFeed as JFeed  # noqa: E402
from repro.telemetry import trace_events as jtrace_events  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.core.cost_table import CostTable  # noqa: E402
from repro_torch.faults import HealthMonitor  # noqa: E402
from repro_torch.models import LM as TLM  # noqa: E402
from repro_torch.recovery import codec, snapshot  # noqa: E402
from repro_torch.serving import BatchingConfig, PagedKVCache, Request, ServingEngine  # noqa: E402
from repro_torch.serving.request import advance_request_ids  # noqa: E402
from repro_torch.telemetry import Telemetry, TimingFeed, trace_events, write_trace  # noqa: E402
from repro_torch.telemetry.probes import TAIL_SPAN  # noqa: E402

PROMPT_LEN = 12
# the roofline time of one tail token on the proxy's cost model (1.5 ns);
# probe times are set relative to it
T1 = 1.5e-9


def probe_time(name: str, value: float, dt: float = 0.0) -> float:
    """The probes' deterministic "measurement": a pure function of span
    name and value (the measured ``dt`` is dropped)."""
    if name == TAIL_SPAN:
        return 3 * T1 * (1 + 0.5 * (value - 1))
    return 1e-5 * (1 + value / 64)


def slow_tail(name: str, value: float, dt: float = 0.0) -> float:
    """A PIM brownout: every tail probe 16x slower."""
    return probe_time(name, value) * (16 if name == TAIL_SPAN else 1)


def _fixed_clock():
    return 0


# ---------------------------------------------------------------------------
# Scenarios, run the same way on both packages
# ---------------------------------------------------------------------------

_BATCHING = dict(n_slots=2, max_seq=48)
_PAGED = dict(paged=True, page_size=8)


@dataclasses.dataclass
class Scenario:
    """A scripted run: requests submitted before step 0, hook changes and
    brownout stages and batch-tier submits at given steps."""

    greedy: bool = True
    seed: int = 0
    n_requests: int = 5
    max_new: int = 8
    hooks: dict = dataclasses.field(default_factory=lambda: {0: probe_time})
    stages: dict = dataclasses.field(default_factory=dict)
    batch_submits: dict = dataclasses.field(default_factory=dict)  # step -> max_new_tokens
    snap_at: int = 8


# sampled (seed 7); a PIM brownout on the tail probes over steps 6-11
# (quarantine, GPU-only split, recovery); then brownout stage 1 (a batch
# request clamped), 2, 3 (a batch request shed) and back to 0
SCENARIO = Scenario(greedy=False, seed=7, n_requests=5, max_new=10,
                    hooks={0: probe_time, 6: slow_tail, 12: probe_time},
                    stages={16: 1, 18: 2, 20: 3, 22: 0}, batch_submits={16: 10, 20: 10}, snap_at=9)
BROWNOUT_FROM = 16


class _Api:
    """One package's engine pieces under one name."""

    def __init__(self, pkg: str):
        if pkg == "jax":
            self.Engine, self.Request, self.Batching, self.Telemetry = JEngine, JRequest, JBatching, JTelemetry
        else:
            self.Engine, self.Request, self.Batching, self.Telemetry = (
                ServingEngine, Request, BatchingConfig, Telemetry)


def _prompts(n):
    return [np.random.default_rng(100 + s).integers(0, 512, PROMPT_LEN).tolist() for s in range(n)]


@dataclasses.dataclass
class Run:
    engine: object
    reqs: list
    submitted: list
    trajectory: list


def _run(api: _Api, lm, params, sc: Scenario, paged: bool, resume_from=None, snap_dir=None) -> Run:
    """Drive ``sc`` on one package.  ``snap_dir``: snapshot at
    ``sc.snap_at`` and, corrupted, two steps later.  ``resume_from``: a
    snapshot directory restored into a fresh engine before stepping."""
    batching = api.Batching(**_BATCHING, **(_PAGED if paged else {}))
    tel = api.Telemetry(clock=_fixed_clock)
    eng = api.Engine(lm, params, batching, greedy=sc.greedy, seed=sc.seed, sieve_refresh_every=2,
                     telemetry=tel, cost_source="measured", brownout_batch_max_new=3)
    reqs, submitted = [], []
    if resume_from is None:
        for p in _prompts(sc.n_requests):
            reqs.append(api.Request(prompt=list(p), max_new_tokens=sc.max_new))
            submitted.append(eng.submit(reqs[-1]))
    else:
        assert eng.restore(resume_from) == sc.snap_at
    hook = max((k for k in sc.hooks if k <= eng.stats.steps), default=0)
    eng._probes.corrupt = sc.hooks[hook]
    traj = []
    while not eng.sched.idle:
        k = eng.stats.steps
        if k in sc.hooks:
            eng._probes.corrupt = sc.hooks[k]
        if k in sc.stages:
            eng.set_brownout_stage(sc.stages[k])
        if k in sc.batch_submits:
            reqs.append(api.Request(prompt=list(_prompts(1)[0]), max_new_tokens=sc.batch_submits[k],
                                    priority="batch"))
            submitted.append(eng.submit(reqs[-1]))
        eng.step()
        traj.append((k, eng.pim_healthy, eng._sieve_gpu_only, eng._timing_feed.quarantined,
                     eng.brownout_stage, len(eng.sieve_refreshes)))
        if snap_dir is not None and eng.stats.steps in (sc.snap_at, sc.snap_at + 2):
            eng.snapshot(snap_dir)
    return Run(eng, reqs, submitted, traj)


def _tokens(run: Run):
    """Tokens of every request of the scenario, in submission order; a
    restored run's requests are read from its scheduler by id order."""
    if run.reqs:
        return [list(r.generated) for r in run.reqs]
    return [list(r.generated) for r in sorted(run.engine.sched.finished, key=lambda r: r.req_id)]


def _torch_lm(jparams):
    tlm = TLM(proxy_arch(tget), dtype=torch.float32, device="cpu")
    return tlm, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu", torch.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scenario on each layout, on both packages, run once; the torch
    run takes its snapshots on the way."""
    jlm = JLM(proxy_arch(jget), dtype=jnp.float32)
    jparams = jlm.init(jax.random.PRNGKey(0))
    tlm, tparams = _torch_lm(jparams)
    out = {}
    for layout in LAYOUTS:
        # paged: JAX's oracle paged attention, whose idle slot reads the
        # trash-block row as the port's plain version does
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_FLASH_DECODE", "0")
            jrun = _run(_Api("jax"), jlm, jparams, SCENARIO, layout == "paged")
        snap_dir = str(tmp_path_factory.mktemp(f"snap_{layout}"))
        trun = _run(_Api("torch"), tlm, tparams, SCENARIO, layout == "paged", snap_dir=snap_dir)
        out[layout] = (jrun, trun, snap_dir)
    out["torch_lm"] = (tlm, tparams)
    return out


LAYOUTS = ["dense", "paged"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_measured_engine_matches_jax(runs, layout):
    jrun, trun, _ = runs[layout]
    je, te = jrun.engine, trun.engine
    assert _tokens(trun) == _tokens(jrun)
    assert te.stats.steps == je.stats.steps
    assert te.sieve_refreshes == je.sieve_refreshes
    assert len(te.stats.partitions) == len(je.stats.partitions)
    for a, b in zip(te.stats.partitions, je.stats.partitions):
        assert {k: a[k] for k in ("step", "layer", "n_gpu", "n_pim")} == \
            {k: b[k] for k in ("step", "layer", "n_gpu", "n_pim")}
        np.testing.assert_allclose(a["t_total_est"], b["t_total_est"], **F32_TOL)
    np.testing.assert_array_equal(te.cost_table.export(64), je.cost_table.export(64))
    for k in ("version", "n_updates", "n_rejected"):
        assert getattr(te.cost_table, k) == getattr(je.cost_table, k), k
    tf, jf = te._timing_feed, je._timing_feed
    assert (tf.n_fed, tf.n_ok, tf.n_polls, tf.n_rejected) == (jf.n_fed, jf.n_ok, jf.n_polls, jf.n_rejected)
    assert tf.n_fed > 0
    assert te._probes.n_probes == je._probes.n_probes
    assert trun.trajectory == jrun.trajectory
    assert (te.stats.routed_tokens, te.stats.dropped_tokens) == (je.stats.routed_tokens, je.stats.dropped_tokens)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fault_window_matches_jax(runs, layout):
    """The tail brownout over steps 6-11 quarantines both engines at the
    same boundary and clears them at the same one; the split is GPU-only
    exactly while quarantined."""
    jrun, trun, _ = runs[layout]
    fault = [t for t in trun.trajectory if t[0] < BROWNOUT_FROM]
    assert fault == [t for t in jrun.trajectory if t[0] < BROWNOUT_FROM]
    gpu_only = [k for k, _, g, *_ in fault if g]
    assert gpu_only and 6 <= gpu_only[0] <= 6 + 2  # within one refresh cadence
    recovered = [k for k, h, g, *_ in fault if k > gpu_only[0] and h and not g]
    assert recovered and recovered[0] >= 12
    assert all(q == g for _, _, g, q, *_ in fault)
    te, je = trun.engine, jrun.engine
    assert [(t.t, t.target, t.new) for t in te.health.transitions] == \
        [(t.t, t.target, t.new) for t in je.health.transitions]
    assert te.pim_healthy and not te._sieve_gpu_only


@pytest.mark.parametrize("layout", LAYOUTS)
def test_brownout_and_admission_match_jax(runs, layout):
    jrun, trun, _ = runs[layout]
    te, je = trun.engine, jrun.engine
    assert trun.submitted == jrun.submitted == [True] * 6 + [False]
    assert te.stats.shed_requests == je.stats.shed_requests == 1
    clamped = trun.reqs[5]
    assert clamped.priority == "batch" and clamped.max_new_tokens == 3 == jrun.reqs[5].max_new_tokens
    assert len(clamped.generated) == 3 and trun.reqs[6].generated == []
    brownout = {k: (s, g) for k, _, g, _, s, _ in trun.trajectory if BROWNOUT_FROM - 1 <= k <= 22}
    # stage 2 and 3 clamp the export to GPU-only at once; stage 0 lifts it
    assert brownout == {15: (0, False), 16: (1, False), 17: (1, False), 18: (2, True), 19: (2, True),
                        20: (3, True), 21: (3, True), 22: (0, False)}
    assert _tokens(trun) == _tokens(jrun)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_seeded_sampling_matches_jax(runs, layout):
    """``greedy=False, seed=7``: the same tokens as the JAX engine, and the
    RNG, advanced by the draws, at the same state after the run."""
    jrun, trun, _ = runs[layout]
    assert _tokens(trun) == _tokens(jrun)
    state = trun.engine.rng.bit_generator.state
    assert state == jrun.engine.rng.bit_generator.state
    assert state != np.random.default_rng(7).bit_generator.state


@pytest.mark.parametrize("layout", LAYOUTS)
def test_restore_resumes_bit_for_bit(runs, layout):
    """A fresh engine restored from the snapshot taken mid-fault (the newest
    one, two steps later, is corrupted first and walked past) finishes
    with the uninterrupted run's tokens, KV cache bits, SieveState, cost
    table, feed, health and RNG."""
    _, trun, snap_dir = runs[layout]
    sc = SCENARIO
    snaps = snapshot.list_snapshots(snap_dir)
    assert [s for s, _ in snaps] == [sc.snap_at, sc.snap_at + 2]
    with open(codec.leaf_path(snaps[-1][1], 0), "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xff" * 8)
    before = snapshot.n_fallbacks
    with pytest.warns(UserWarning, match="falling back"):
        resumed = _run(_Api("torch"), *runs["torch_lm"], sc, layout == "paged", resume_from=snap_dir)
    assert snapshot.n_fallbacks == before + 1
    with pytest.raises(IOError, match="checksum"):
        trun.engine.restore(snap_dir, snap_id=sc.snap_at + 2)
    a, b = resumed.engine, trun.engine
    # requests submitted after the restore get new ids in both runs, in order
    done = lambda e: [r.generated for r in sorted(e.sched.finished, key=lambda r: r.req_id)]  # noqa: E731
    assert done(a) == done(b)
    assert resumed.submitted == trun.submitted[-len(resumed.submitted):]
    for x, y in zip(a.cache["blocks"], b.cache["blocks"]):
        assert torch.equal(x, y)
    assert torch.equal(a._sieve_state.pim_time_by_count, b._sieve_state.pim_time_by_count)
    assert torch.equal(a._sieve_state.params, b._sieve_state.params)
    np.testing.assert_array_equal(a.cost_table.export(64), b.cost_table.export(64))
    assert a.cost_table.version == b.cost_table.version and a.sieve_refreshes == b.sieve_refreshes
    assert a._timing_feed.state_dict() == b._timing_feed.state_dict()
    assert a.health.state_dict() == b.health.state_dict()
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert resumed.trajectory == trun.trajectory[sc.snap_at:]
    assert a.stats.partitions == b.stats.partitions and a.stats.steps == b.stats.steps
    assert a.stats.shed_requests == b.stats.shed_requests == 1
    if a.paged is not None:
        assert a.paged.state_dict() == b.paged.state_dict()


# ---------------------------------------------------------------------------
# The copied host modules against the reference's
# ---------------------------------------------------------------------------


def _record_calls(tel):
    tel.span_at("stage/tail_gemv", 0.5, 2e-6, value=3.0)
    with tel.span("engine/step", value=1.0):
        tel.counter("engine/shed_requests")
        tel.gauge("engine/kv_occupancy", 0.25, track="replica-1")
    tel.observe("expert_tokens/layer0", np.array([1, 2, 3, 5, 1024, 3e6]))
    tel.point("queue", 4.0, t_s=2.0, track="replica-1")
    tel.counter("engine/shed_requests", 2.0)
    tel.span_at("bad", math.inf, math.nan)
    tel.observe("head_mass", 0.5)


@pytest.mark.parametrize("capacity", [64, 5])
def test_telemetry_copy_matches_jax(capacity):
    """One sequence of calls on a counting clock: the same events (the ring
    wraps at capacity 5), cursors, counters, gauges, Prometheus text and
    trace events."""
    clocks = [iter(range(0, 10**6, 1000)) for _ in range(2)]
    jt = JTelemetry(capacity=capacity, clock=lambda: next(clocks[0]))
    tt = Telemetry(capacity=capacity, clock=lambda: next(clocks[1]))
    _record_calls(jt)
    _record_calls(tt)

    def events(tel, cursor=0):  # NaN values (spans without one) compare by repr
        evs, head = tel.events_since(cursor)
        return [{**e, "value": repr(e["value"])} for e in evs], head

    assert events(tt) == events(jt)
    assert events(tt, 3) == events(jt, 3)
    assert (tt.n_emitted, tt.n_overflowed, tt.tracks) == (jt.n_emitted, jt.n_overflowed, jt.tracks)
    assert tt.counters() == jt.counters() and tt.gauges() == jt.gauges()
    assert tt.snapshot() == jt.snapshot()
    assert trace_events(tt) == jtrace_events(jt)


def test_disabled_telemetry_records_nothing():
    tt = Telemetry(enabled=False)
    _record_calls(tt)
    assert tt.events() == [] and tt.counters() == {} and tt.snapshot() == ""


def _feed_rounds():
    """Polls of tail spans: duplicates, a poisoned repeat among honest ones,
    invalid values and durations, a 20x jump the ratio gate rejects."""
    base = {1: 1e-6, 2: 1.6e-6, 4: 3e-6}
    rounds = [
        [(1, base[1]), (1, base[1] * 1.1), (2, base[2]), (0, 1.0), (math.nan, 1.0)],
        [(1, base[1])] * 4 + [(1, base[1] * 50), (4, base[4]), (2, -1.0)],
        [(1, base[1] * 20), (2, base[2] * 1.2), (4, math.inf)],
        [],
        [(1, base[1] * 20), (4, base[4])],
    ]
    return rounds


@pytest.mark.parametrize("quarantine_at", [None, 2])
def test_timing_feed_matches_jax(quarantine_at):
    jt, tt = JTelemetry(clock=_fixed_clock), Telemetry(clock=_fixed_clock)
    jc, tc = JCostTable(fallback=lambda n: 1e-9 * n), CostTable(fallback=lambda n: 1e-9 * n)
    jf, tf = JFeed(jc, jt), TimingFeed(tc, tt)
    for i, samples in enumerate(_feed_rounds()):
        if i == quarantine_at:
            jf.quarantined = tf.quarantined = True
        if i == 4:
            jf.quarantined = tf.quarantined = False
            jf.rewarm()
            tf.rewarm()
        for value, dur in samples:
            for tel in (jt, tt):
                tel.span_at(TAIL_SPAN, 0.0, dur, value=value)
            jt.span_at("stage/head_gmm", 0.0, 1e-3, value=8.0)
            tt.span_at("stage/head_gmm", 0.0, 1e-3, value=8.0)
        assert tf.poll() == jf.poll()
        assert tf.state_dict() == jf.state_dict()
        np.testing.assert_array_equal(tc.export(8), jc.export(8))
        assert (tc.version, tc.n_updates) == (jc.version, jc.n_updates)
    assert tf.n_fed > 0 and tf.n_rejected > 0
    fresh = TimingFeed(CostTable(fallback=lambda n: 0.0), Telemetry())
    fresh.load_state_dict(codec.unpack_state(codec.pack_state(tf.state_dict())))
    assert fresh.state_dict() == tf.state_dict()
    with pytest.raises(ValueError, match="clip_ratio"):
        TimingFeed(tc, tt, clip_ratio=1.0)


def test_health_monitor_matches_jax():
    """Drift with hysteresis and a staleness watchdog on the same inputs:
    the same statuses, transitions and state, and the state round-trips
    through the snapshot codec."""
    kw = dict(threshold=4.0, alpha=0.2, warmup=1, confirm=2, recover=2, stale_after=2)
    jm, tm = JHealth(**kw), HealthMonitor(**kw)
    drift = [1.0, 1.1, 0.9, 9.0, 1.0, 9.0, 9.5, 9.0, 1.2, 1.0, 0.9, 1.0]
    counter = [0, 1, 2, 2, 2, 2, 3, 4, 4, 5, 6, 7]
    for t, (v, c) in enumerate(zip(drift, counter)):
        assert tm.observe("pim", v, t=t) == jm.observe("pim", v, t=t)
        assert tm.watch("feed", c, t=t) == jm.watch("feed", c, t=t)
        assert (tm.is_healthy("pim"), tm.is_healthy("feed")) == (jm.is_healthy("pim"), jm.is_healthy("feed"))
    assert tm.state_dict() == jm.state_dict()
    assert {t.new for t in tm.transitions} == {"healthy", "degraded"}
    fresh = HealthMonitor(**kw)
    fresh.load_state_dict(codec.unpack_state(codec.pack_state(tm.state_dict())))
    assert fresh.state_dict() == tm.state_dict()
    with pytest.raises(ValueError):
        HealthMonitor(confirm=0)


def test_cost_table_batch_updates_and_state_match_jax():
    fb = lambda n: 2e-9 * n  # noqa: E731
    jc, tc = JCostTable(fallback=fb), CostTable(fallback=fb)
    for c in (jc, tc):
        c.update_batch([1, 2, 5], [1e-6, 2e-6, 4e-6])
        c.update_batch([2, 2, 7, 3], [1e-6, 3e-6, math.nan, 5e-6])  # repeated key: one update each
        c.update_batch([1, 9], [3e-6, 2e-6], assume_unique=True)
        c.update_many([(4, 1e-6), (4, math.inf)])
        c.update(1 << 21, 1e-3)  # a key past the dense array
        c.lookup(11)
    np.testing.assert_array_equal(tc.export(16), jc.export(16))
    for k in ("version", "n_updates", "n_rejected", "n_fallback_lookups"):
        assert getattr(tc, k) == getattr(jc, k), k
    assert tc.observed() == jc.observed() and tc.state_dict() == jc.state_dict()
    assert tc.has(9) and not tc.has(10) and tc.lookup(10) == jc.lookup(10)
    with pytest.raises(ValueError):
        tc.update_batch([1, 2], [1e-6])
    with pytest.raises(ValueError):
        tc.update_batch([1], [-1.0])
    loaded = CostTable(fallback=fb)
    loaded.load_state_dict(codec.unpack_state(codec.pack_state(tc.state_dict())))
    jl = JCostTable(fallback=fb)
    jl.load_state_dict(jc.state_dict())
    np.testing.assert_array_equal(loaded.export(16), tc.export(16))
    assert loaded.observed() == tc.observed() and loaded.version == jl.version == 1


def test_request_and_paged_state_match_jax():
    advance_request_ids(10_000)
    kw = dict(prompt=[3, 1, 4], max_new_tokens=5, eos_id=2, arrival_time=1.5, req_id=10_000,
              priority="batch", deadline=9.0)
    jr, tr = JRequest(**kw), Request(**kw)
    for r in (jr, tr):
        r.generated, r.prefill_done, r.slot, r.first_token_time = [7, 8], 3, 1, 2.5
    assert tr.to_state() == jr.to_state()
    back = Request.from_state(codec.unpack_state(codec.pack_state(tr.to_state())))
    assert back.to_state() == tr.to_state()
    assert Request(prompt=[1]).req_id > 10_000  # ids advanced past the restored one
    kwp = dict(n_slots=3, max_seq=40, page_size=8, pool_blocks=10, paged=True)
    jp, tp = JPaged(JBatching(**kwp)), PagedKVCache(BatchingConfig(**kwp))
    for c in (jp, tp):
        c.ensure(0, 17)
        c.ensure(2, 9)
        c.free_slot(0)
        c.ensure(1, 30)
    assert tp.state_dict() == jp.state_dict()
    fresh = PagedKVCache(BatchingConfig(**kwp))
    fresh.load_state_dict(codec.unpack_state(codec.pack_state(tp.state_dict())))
    assert fresh.state_dict() == tp.state_dict()
    with pytest.raises(ValueError, match="geometry"):
        PagedKVCache(BatchingConfig(**{**kwp, "page_size": 4})).load_state_dict(tp.state_dict())


# ---------------------------------------------------------------------------
# Codec, constructor arguments, engine details
# ---------------------------------------------------------------------------


def test_codec_round_trips_bf16_leaves_and_big_ints(tmp_path):
    x = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ints = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    stored = [codec.to_storable(t) for t in (x, ints)]
    assert stored[0][0].dtype == np.uint16 and stored[0][1] == "bfloat16"

    def write(d):
        entries = codec.write_leaves(d, stored)
        with open(os.path.join(d, "m.json"), "wb") as f:
            f.write(codec.pack_state({"leaves": entries}))

    path = codec.commit_dir(str(tmp_path / "snap_00000001"), write)
    assert codec.committed_dirs(str(tmp_path), "snap_") == [(1, path)]
    os.makedirs(tmp_path / "snap_00000002")  # torn write: no marker
    assert codec.committed_dirs(str(tmp_path), "snap_") == [(1, path)]
    with open(os.path.join(path, "m.json"), "rb") as f:
        entries = codec.unpack_state(f.read())["leaves"]
    back = [codec.read_leaf(path, i, m) for i, m in enumerate(entries)]
    assert back[0].dtype == torch.bfloat16 and torch.equal(back[0].view(torch.int16), x.view(torch.int16))
    assert torch.equal(back[1], ints)
    state = np.random.default_rng(3).bit_generator.state
    assert state["state"]["state"] >= 1 << 64
    blob = {"rng": state, "t": (1, 2), "k": {5: np.float64(0.1), "x": np.int32(-3)}, "b": np.bool_(True)}
    assert codec.unpack_state(codec.pack_state(blob)) == {
        "rng": state, "t": [1, 2], "k": {"5": 0.1, "x": -3}, "b": True}
    with pytest.raises(ValueError, match="malformed"):
        codec.unpack_state(b"{not json")
    np.save(codec.leaf_path(path, 1), np.zeros((2, 3), np.int32))
    with pytest.raises(IOError, match="checksum"):
        codec.read_leaf(path, 1, entries[1])


def _tiny_engine(**kw):
    tlm = TLM(proxy_arch(tget), dtype=torch.float32, device="cpu")
    return ServingEngine(tlm, tlm.init(seed=0), BatchingConfig(**_BATCHING), **kw)


def test_constructor_arguments_as_jax():
    with pytest.raises(ValueError, match="cost_source"):
        _tiny_engine(cost_source="bogus")
    dense = dataclasses.replace(proxy_arch(tget), family="dense", moe=None, d_ff=96)
    lm = TLM(dense, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="measured"):
        ServingEngine(lm, lm.init(seed=0), BatchingConfig(**_BATCHING), cost_source="measured")
    eng = _tiny_engine(cost_source="measured", seed=4, brownout_batch_max_new=0)
    # a disabled default telemetry gets a live private instance
    assert eng.tel.enabled and eng._probes.tel is eng.tel and eng._timing_feed.tel is eng.tel
    assert eng.health is not None and eng.brownout_batch_max_new == 1
    mon = HealthMonitor()
    assert _tiny_engine(cost_source="measured", health=mon).health is mon
    model = _tiny_engine()
    assert model._probes is None and model._timing_feed is None and not model.tel.enabled


def test_brownout_refresh_is_in_place_and_idempotent():
    """Stage 2 writes the blocked times into the same SieveState tensors
    (count 0 stays 0) and stage 0 the table's export again; repeating a
    stage does nothing."""
    eng = _tiny_engine()
    table = eng._sieve_state.pim_time_by_count
    want = table.clone()
    eng.set_brownout_stage(2)
    assert eng._sieve_state.pim_time_by_count is table
    assert float(table[0]) == 0.0 and bool((table[1:] == 1e9).all()) and eng._sieve_gpu_only
    n = len(eng.sieve_refreshes)
    eng.set_brownout_stage(2)
    eng.set_brownout_stage(3)  # still GPU-only: no re-export
    assert len(eng.sieve_refreshes) == n
    eng.set_brownout_stage(0)
    assert torch.equal(table, want) and not eng._sieve_gpu_only and len(eng.sieve_refreshes) == n + 1


def test_engine_telemetry_spans_and_metrics(tmp_path):
    """A measured engine records the step's spans, the probes' stage spans,
    per-layer histograms and gauges, and writes a loadable trace."""
    tel = Telemetry(clock=_fixed_clock)
    eng = _tiny_engine(cost_source="measured", telemetry=tel, sieve_refresh_every=2)
    eng._probes.corrupt = probe_time
    for p in _prompts(2):
        eng.submit(Request(prompt=p, max_new_tokens=4))
    eng.run_until_done()
    names = {e["name"] for e in tel.events()}
    assert {"engine/step", "engine/admit", "engine/prefill", "engine/decode", "engine/sieve_host",
            "engine/probe", "engine/sieve_refresh", TAIL_SPAN, "stage/head_gmm", "stage/dispatch",
            "stage/attention"} <= names
    gauges = tel.gauges()
    assert {"engine/kv_occupancy", "engine/batch_occupancy", "engine/drop_rate",
            "engine/pim_healthy", "head_mass/layer0"} <= set(gauges)
    assert "repro_expert_tokens_layer1_count" in tel.snapshot()
    assert "engine/graph_capture" not in tel.counters()  # the CPU step is never captured
    with open(write_trace(tel, str(tmp_path / "trace.json"))) as f:
        doc = json.load(f)
    assert any(e["ph"] == "X" and e["name"] == TAIL_SPAN for e in doc["traceEvents"])


def test_snapshot_keep_prunes_and_a_mismatched_engine_is_refused(tmp_path):
    """``keep=1`` leaves the newest snapshot only; restoring into an engine
    of another layout (paged, or another max_seq) raises before any field
    changes."""
    eng = _tiny_engine()
    eng.submit(Request(prompt=_prompts(1)[0], max_new_tokens=3))
    eng.step()
    eng.snapshot(str(tmp_path))
    eng.step()
    eng.snapshot(str(tmp_path), keep=1)
    assert [s for s, _ in snapshot.list_snapshots(str(tmp_path))] == [2]
    tlm = eng.lm
    for other in (BatchingConfig(**_BATCHING, **_PAGED), BatchingConfig(n_slots=2, max_seq=40)):
        target = ServingEngine(tlm, eng.params, other)
        before = [t.clone() for t in target.cache["blocks"]]
        with pytest.raises(ValueError, match="leaves, the engine has|does not fit"):
            target.restore(str(tmp_path))
        assert target.stats.steps == 0 and all(torch.equal(a, b) for a, b in zip(before, target.cache["blocks"]))
    with pytest.raises(FileNotFoundError):
        eng.restore(str(tmp_path), snap_id=1)
