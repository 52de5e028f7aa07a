"""Sieve serving engine: continuous batching with the scheduler in the
loop (counterpart of ``repro.serving.engine``).

Per step it admits requests into KV slots and prefills them, runs one
batched decode step whose aux output carries the per-layer expert token
counts, feeds those counts through the host scheduler (``policy=``, any
name of ``core.scheduler.POLICIES``: Sieve's greedy by default, its
argmin refinement, the paper's baselines and the two dual-path rules)
into the EMA cost table, and, under ``expert_exec="dual_path_cost"``,
re-exports the table into the device-resident ``SieveState`` every
``sieve_refresh_every`` steps.  The table's observations come from the
DRAM-timing PIM model (``cost_source="model"``) or, with
``cost_source="measured"``, from stage probes timed on the device at each
refresh boundary (``telemetry.StageProbes`` into ``telemetry.TimingFeed``).
A ``HealthMonitor`` watches the measured loop: while it flags the PIM side
unhealthy, or a cluster brownout is at stage 2 or more, the export clamps
the split to GPU-only.  Brownout also clamps (stage 1) or refuses (stage
3) batch-tier requests at ``submit``.  Sampling is greedy, or seeded
(``greedy=False, seed=``).  ``snapshot``/``restore`` save and resume the
runtime state bit for bit (``recovery.snapshot``).  ``telemetry=`` (or
``REPRO_TELEMETRY=1``) records the step's spans, counters and gauges.

Where the JAX engine relies on buffer donation and a no-recompile state
swap, this one updates the KV cache in place and refreshes the
``SieveState`` by ``copy_`` into the same device tensors.  The decode
step's inputs are device buffers at fixed addresses, filled by ``copy_``
each step.  On the card, the counterpart of the JAX engine's compiled
step (``jax.jit(lm.decode_step, donate_argnums=(2,))``) is one CUDA graph
of ``LM.decode_step``, captured after the first decode step has run
eagerly and replayed by every later one (:meth:`ServingEngine._decode`).
The cache is whatever ``LM.init_cache`` makes: per-head K/V, or MLA's
compressed ``(c_kv, k_rope)`` rows, with a dense prefix's layers under
their own key; prefill copies every leaf into the slot.
For the ``vlm`` family the prompt's text tokens carry M-RoPE positions
equal on the temporal, height and width streams, at prefill and as one
more fixed-address decode input, so each engine still captures one graph.
Prefill runs eagerly: its shape changes with each prompt.  With
``BatchingConfig(paged=True)`` the cache is a shared block pool indexed
through host-side block tables (``PagedKVCache``): blocks are allocated
at prefill and as decode grows a slot, and freed when it retires.

Nothing of the runtime loop adds a capture: a health transition, a
brownout stage and a restore all write new numbers into the tensors the
captured graph reads (``copy_``), and the probes run between steps on the
replay's stream, never inside a capture.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, MoELayerSpec, SystemSpec, b200_pim_system
from repro_torch.core.cost_table import CostTable
from repro_torch.core.scheduler import POLICIES, schedule
from repro_torch.core.scheduler_torch import SieveParams, SieveState, export_cost_table
from repro_torch.faults.health import HealthMonitor
from repro_torch.kernels import ops
from repro_torch.models.model import LM
from repro_torch.sim.dram import PimGemvModel
from repro_torch.telemetry import StageProbes, Telemetry, TimingFeed
from repro_torch.telemetry import default as default_telemetry
from .batching import BatchingConfig, PagedKVCache, SlotScheduler
from .request import Request

# cost-table feeding modes: "model" synthesizes PIM observations from the
# DRAM-timing proxy (PimGemvModel); "measured" drives the table from
# probe-measured tail-stage times (TimingFeed) on the refresh cadence
COST_SOURCES = ("model", "measured")

# cap on tail probes per refresh boundary (distinct tail counts measured)
_MAX_TAIL_PROBES = 8

# fixed sentinel tail cell probed at every refresh boundary: its measured
# time over the roofline is the PIM-health drift signal (a stationary
# ratio: the EMA baseline absorbs the hardware/model scale), and it keeps
# the feed's progress heartbeat alive on idle boundaries
_SENTINEL_TAIL = 1
_SENTINEL_PROBES = 3  # repeats per boundary; the mean damps jitter

# "PIM time" exported while the split is clamped to GPU-only: huge but
# finite float32 seconds, so the on-device argmin picks the minimal
# feasible tail with no change of shape or dtype: the captured step reads
# the new numbers from the same tensor
_PIM_BLOCKED_TIME = 1e9


@dataclass
class EngineStats:
    steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    wall_time: float = 0.0
    dropped_tokens: int = 0
    routed_tokens: int = 0
    truncated_requests: int = 0
    # admission outcomes: deadline passed while queued / batch request
    # refused at submit under brownout stage 3
    expired_requests: int = 0
    shed_requests: int = 0
    partitions: List[Dict] = field(default_factory=list)

    @property
    def throughput(self) -> float:
        return self.decode_tokens / self.wall_time if self.wall_time else 0.0

    @property
    def drop_rate(self) -> float:
        if self.routed_tokens <= 0:
            return 0.0
        return self.dropped_tokens / self.routed_tokens


class ServingEngine:
    def __init__(
        self,
        lm: LM,
        params: Any,
        batching: BatchingConfig,
        policy: str = "sieve",
        system: Optional[SystemSpec] = None,
        greedy: bool = True,
        seed: int = 0,
        sieve_refresh_every: int = 16,
        telemetry: Optional[Telemetry] = None,
        cost_source: str = "model",
        health: Optional[HealthMonitor] = None,
        brownout_batch_max_new: int = 8,
    ):
        if cost_source not in COST_SOURCES:
            raise ValueError(
                f"cost_source must be one of {COST_SOURCES}, got {cost_source!r}"
            )
        if lm.arch.moe is not None and policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")
        self.lm = lm
        self.params = params
        self.cfg = batching
        self.policy = policy
        self.sched = SlotScheduler(batching)
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        self.stats = EngineStats()
        self.cost_source = cost_source
        # an explicit instance wins; otherwise the process default (enabled
        # iff REPRO_TELEMETRY is set, a shared no-op otherwise)
        self.tel = telemetry if telemetry is not None else default_telemetry()
        self.device = lm.device
        # updated in place by every prefill insert and decode step; paged:
        # slots index a shared block pool through a host-side block table
        self.paged: Optional[PagedKVCache] = None
        if batching.paged:
            self.paged = PagedKVCache(batching)
            self.cache = lm.init_paged_cache(self.paged.n_pool, self.paged.page)
        else:
            self.cache = lm.init_cache(batching.n_slots, batching.max_seq)
        self._host_in, self._decode_in = self._decode_buffers()
        # the compiled decode step: on the card, a CUDA graph captured on the
        # first decode step; ``_replay = False`` runs the eager step there
        # instead (for comparisons only)
        self._replay = self.device.type == "cuda"
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_out = None
        self._graph_launches: Dict[str, int] = {}
        # graph captures (one per engine), the counterpart of the JAX
        # engine's jit-cache entries; telemetry counts new ones per step
        self.n_captures = 0
        self._captures_seen = 0

        arch = lm.arch
        self.is_moe = arch.moe is not None
        self.uses_cost_split = self.is_moe and arch.moe.expert_exec == "dual_path_cost"
        self.sieve_refresh_every = max(int(sieve_refresh_every), 1)
        self.sieve_refreshes: List[int] = []
        self._sieve_state: Optional[SieveState] = None
        self._sieve_version = -1
        self._sieve_gpu_only = False
        # PIM health gate: flipped by _update_pim_health at refresh
        # boundaries; while False the export clamps to GPU-only and the
        # measured feed is quarantined (roofline fallback)
        self.pim_healthy = True
        self.health = health
        # cluster-driven brownout stage (0 = healthy .. 3 = shed): stage 1+
        # clamps batch-tier max_new_tokens at submit, stage 2+ forces the
        # GPU-only export, stage 3 refuses new batch requests
        self.brownout_stage = 0
        self.brownout_batch_max_new = max(int(brownout_batch_max_new), 1)
        if cost_source == "measured" and not self.is_moe:
            raise ValueError(
                "cost_source='measured' feeds the MoE cost table; "
                f"arch {arch.name!r} has no MoE layers"
            )
        # measured cost loop (built in the MoE branch below)
        self._probes: Optional[StageProbes] = None
        self._timing_feed: Optional[TimingFeed] = None
        self._pending_tail_counts: set = set()
        self._last_head_counts: List[int] = []
        self._last_decode_batch = 0
        self._last_kv_depth = 1
        # per-layer metric names, built once
        self._layer_metric_names: List[tuple] = []
        if self.is_moe:
            self.system = system or b200_pim_system()
            self.layer_spec = MoELayerSpec(
                d_model=arch.d_model,
                d_ff=arch.moe.d_expert,
                n_experts=arch.moe.n_experts,
                top_k=arch.moe.top_k,
                n_shared=arch.moe.n_shared,
            )
            self.cost_model = CostModel(system=self.system, layer=self.layer_spec)
            self._pim = PimGemvModel(self.system.pim) if self.system.pim is not None else None
            self.cost_table = CostTable(fallback=self.cost_model.t_pim_gemv_roofline)
            if cost_source == "measured":
                self._init_measured_loop(seed)
            if self.uses_cost_split:
                # per-expert counts are bounded by the step's token count;
                # the split clamps larger counts to the last table entry
                self._sieve_max_count = min(
                    4096, max(batching.n_slots, batching.max_seq, 64)
                )
                self._refresh_sieve_state(step=0)

    def _init_measured_loop(self, seed: int) -> None:
        """Stage probes on the model's device and dtype, the feed, and the
        health monitor (the measured loop is the only cost source that can
        silently break): sentinel drift against the roofline plus a
        staleness watchdog on the feed's progress.  The DRAM-timing model
        is never consulted on this path."""
        arch = self.lm.arch
        # the span ring is the measurement record: a disabled default
        # telemetry gets a live private instance
        if not self.tel.enabled:
            self.tel = Telemetry(enabled=True)
        attn = arch.attn
        attn_dims = (attn.n_heads, attn.n_kv_heads, attn.d_head) if attn.kind == "gqa" else None
        self._probes = StageProbes(
            arch.d_model, arch.moe.d_expert, self.tel, attn_dims=attn_dims, seed=seed,
            dtype=self.lm.dtype, device=self.device,
            page_size=self.paged.page if self.paged is not None else None,
        )
        self._timing_feed = TimingFeed(self.cost_table, self.tel)
        if self.health is None:
            self.health = HealthMonitor(threshold=4.0, alpha=0.2, warmup=1, confirm=1,
                                        recover=2, stale_after=2, telemetry=self.tel)
        self._roofline_t1 = self.cost_model.t_pim_gemv_roofline(_SENTINEL_TAIL)

    # ------------------------------------------------------------------
    def _decode_buffers(self):
        """The decode step's inputs on the device, allocated once, and their
        host staging buffers (pinned on the card, so the fill is an
        asynchronous copy): tokens and positions, for the ``vlm`` family the
        M-RoPE positions, and for a paged cache the block tables, pool
        owners and block positions."""
        B = self.cfg.n_slots
        shapes = {"tokens": (B, 1), "position": (B,)}
        if self.lm.arch.family == "vlm":
            shapes["mrope_positions"] = (3, B, 1)
        if self.paged is not None:
            shapes.update(block_tables=self.paged.block_table.shape,
                          pool_owner=(self.paged.n_pool,), pool_pos=(self.paged.n_pool,))
        pin = self.device.type == "cuda"
        host, dev = {}, {}
        for name, shape in shapes.items():
            dtype = torch.int64 if name == "tokens" else torch.int32
            host[name] = torch.zeros(shape, dtype=dtype, pin_memory=pin)
            dev[name] = torch.zeros(shape, dtype=dtype, device=self.device)
        return host, dev

    def _fill_decode_inputs(self, **arrays: np.ndarray) -> Dict[str, torch.Tensor]:
        """Copy this step's host arrays into the fixed-address inputs.  The
        staging buffers are free to overwrite: the previous step's copies
        finished before its logits reached the host."""
        for name, a in arrays.items():
            self._host_in[name].numpy()[...] = a
            self._decode_in[name].copy_(self._host_in[name], non_blocking=True)
        return dict(self._decode_in)

    def _decode(self, batch: Dict[str, Any]):
        """One decode step over the fixed-address inputs -> (logits, aux).

        On the card the first call runs ``LM.decode_step`` eagerly, which
        also creates every kernel wrapper's kept state (library init,
        tickets, scratch) outside any graph, then captures the step as one
        CUDA graph; every later call replays it and counts the captured
        kernel launches in ``ops.LAUNCHES``.  The decode batch is always
        ``n_slots`` rows, so one graph serves the engine.  A capture or
        replay that fails raises: nothing falls back to the eager step.
        On the CPU, where there are no CUDA graphs, every step is eager."""
        if self._graph is None or not self._replay:
            logits, self.cache, aux = self.lm.decode_step(self.params, batch, self.cache)
            if self._replay:
                self._capture(batch)
            return logits, aux
        self._graph.replay()
        ops.add_launches(self._graph_launches)
        return self._graph_out

    def _capture(self, batch: Dict[str, Any]) -> None:
        graph = torch.cuda.CUDAGraph()
        launches: Dict[str, int] = {}
        # torch.cuda.graph captures on a side stream after synchronising
        # the device; the capture runs nothing, and replays launch on the
        # current stream, in order with the eager prefill
        with ops.recording_launches(launches), torch.cuda.graph(graph):
            logits, _, aux = self.lm.decode_step(self.params, batch, self.cache)
        self._graph, self._graph_out, self._graph_launches = graph, (logits, aux), launches
        self.n_captures += 1

    def _refresh_sieve_state(self, step: int, gpu_only: bool = False) -> None:
        """Re-export (CostTable, CostModel) into the device ``SieveState``.

        The first export allocates the two tensors; later ones ``copy_``
        into them, so every prefill and decode step (and the captured
        graph) reads the same tensors and a refresh is one small
        host-to-device copy.  Skipped when neither the table nor the
        GPU-only clamp changed since the last export.

        ``gpu_only=True`` (PIM unhealthy, or brownout stage 2+) exports
        huge-but-finite PIM times instead of the table (count 0 stays 0),
        so the on-device argmin clamps to the minimal feasible tail with
        no new capture."""
        if (
            self._sieve_state is not None
            and self.cost_table.version == self._sieve_version
            and gpu_only == self._sieve_gpu_only
        ):
            return
        # exported even when clamped, as the reference does: the export's
        # fallback lookups are part of the table's counters
        table = export_cost_table(self.cost_table, self.cost_model, self._sieve_max_count)
        if gpu_only:
            table = np.full(table.shape, _PIM_BLOCKED_TIME, np.float32)
            table[0] = 0.0
        table = torch.from_numpy(table)
        params = torch.from_numpy(
            SieveParams.from_cost_model(
                self.cost_model, self.cfg.n_slots * self.lm.arch.moe.top_k
            ).to_array()
        )
        if self._sieve_state is None:
            self._sieve_state = SieveState(table.to(self.device), params.to(self.device))
        else:
            self._sieve_state.pim_time_by_count.copy_(table)
            self._sieve_state.params.copy_(params)
        self._sieve_version = self.cost_table.version
        self._sieve_gpu_only = gpu_only
        self.sieve_refreshes.append(step)

    def _insert_prefill(self, slot: int, req_cache) -> None:
        """Copy one request's prompt cache into its slot, for every group
        of layers (``"blocks"``, and ``"prefix"`` for a dense prefix) and
        every leaf: K/V, or MLA's ``(c_kv, k_rope)``.  Paged: the rows are
        padded to whole pages and scattered over the slot's first blocks;
        the padded rows lie at or past the length and are never read."""
        pairs = [(dst, src) for key in self.cache
                 for dst, src in zip(self.cache[key], req_cache[key])]
        if self.paged is None:
            for dst, src in pairs:
                P = src.shape[2]
                dst[:, slot, :P].copy_(src[:, 0])
            return
        page = self.paged.page
        for dst, src in pairs:
            L, _, P = src.shape[:3]
            nbp = -(-P // page)
            ids = torch.as_tensor(self.paged.block_table[slot, :nbp], device=dst.device).long()
            rows = torch.nn.functional.pad(src[:, 0], (0, 0, 0, 0, 0, nbp * page - P))
            dst[:, ids] = rows.reshape((L, nbp, page) + rows.shape[2:]).to(dst.dtype)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; returns False when admission refused it
        (brownout stage 3 sheds the batch tier at the door)."""
        if len(req.prompt) > self.cfg.max_seq:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the KV capacity "
                f"max_seq={self.cfg.max_seq}; raise BatchingConfig.max_seq "
                "or truncate the prompt"
            )
        if req.priority == "batch":
            if self.brownout_stage >= 3:
                self.stats.shed_requests += 1
                if self.tel.enabled:
                    self.tel.counter("engine/shed_requests")
                return False
            if self.brownout_stage >= 1:
                # degrade, don't refuse: the batch tier keeps flowing with
                # each request's decode budget clamped
                req.max_new_tokens = min(req.max_new_tokens, self.brownout_batch_max_new)
        self.sched.submit(req)
        return True

    def set_brownout_stage(self, stage: int) -> None:
        """Adopt a cluster-level brownout stage (idempotent).  Stage 2+
        re-exports the ``SieveState`` GPU-only at once (the same tensors,
        no new capture); dropping below 2 restores the table-driven split
        the same way."""
        stage = max(int(stage), 0)
        if stage == self.brownout_stage:
            return
        self.brownout_stage = stage
        if self.uses_cost_split:
            self._refresh_sieve_state(
                step=self.stats.steps, gpu_only=(stage >= 2) or not self.pim_healthy
            )
        if self.tel.enabled:
            self.tel.gauge("engine/brownout_stage", float(stage))

    def _run_sieve(self, counts_per_layer: np.ndarray) -> None:
        """Host-side scheduler pass over this step's per-layer counts.  The
        chosen PIM set's counts feed the cost table: as DRAM-timing model
        times (``cost_source="model"``), or queued for the next boundary's
        probes (``"measured"``; under quarantine the table takes the
        roofline instead)."""
        kw = {}
        if self.policy in ("dual_threshold", "dual_cost"):
            # the host decision trail evaluates the same feasibility
            # window as the decode step's on-device split
            moe = self.lm.arch.moe
            kw = {"tail_tokens": moe.dual_tail_tokens, "max_head": moe.dual_max_head}
        measured = self.cost_source == "measured"
        quarantined = measured and self._timing_feed.quarantined
        tel = self.tel
        for li, counts in enumerate(counts_per_layer):
            part = schedule(self.policy, counts, self.cost_model, self.cost_table, **kw)
            if measured:
                # probing continues under quarantine: the raw measurements
                # are what the health monitor needs to see the fault clear
                for e in part.pim_experts:
                    n = int(counts[e])
                    if n > 0:
                        self._pending_tail_counts.add(n)
                self._last_head_counts = [int(counts[e]) for e in part.gpu_experts if counts[e] > 0]
                if quarantined:
                    for e in part.pim_experts:
                        n = int(counts[e])
                        if n > 0:
                            self.cost_table.update(n, self.cost_model.t_pim_gemv_roofline(n))
            elif self._pim is not None:
                for e in part.pim_experts:
                    n = int(counts[e])
                    if n > 0:
                        self.cost_table.update(n, self._pim.expert_time(self.layer_spec, n))
            if tel.enabled:
                while len(self._layer_metric_names) <= li:
                    j = len(self._layer_metric_names)
                    self._layer_metric_names.append((f"expert_tokens/layer{j}", f"head_mass/layer{j}"))
                hist_name, mass_name = self._layer_metric_names[li]
                routed = counts[counts > 0]
                total = int(routed.sum())
                tel.observe(hist_name, routed)
                if total > 0:
                    # bimodality gauge: share of the routed mass on the
                    # chosen head set at this step's split
                    gpu = np.asarray(part.gpu_experts, dtype=np.int64)
                    tel.gauge(mass_name, float(counts[gpu].sum()) / total if gpu.size else 0.0)
            self.stats.partitions.append(
                {
                    "step": self.stats.steps,
                    "layer": li,
                    "n_gpu": len(part.gpu_experts),
                    "n_pim": len(part.pim_experts),
                    "t_total_est": part.t_total,
                }
            )

    def _run_probes(self) -> None:
        """Refresh-boundary stage probes: the queued tail counts (the cost
        table cells the split decides on), the sentinel tail cell, and one
        head, dispatch and attention cell shaped like the last decode
        batch."""
        moe = self.lm.arch.moe
        tails = sorted(self._pending_tail_counts)
        self._pending_tail_counts.clear()
        if len(tails) > _MAX_TAIL_PROBES:
            # sample evenly across the sorted counts so the probe budget
            # still covers the whole observed range
            idx = np.unique(np.linspace(0, len(tails) - 1, _MAX_TAIL_PROBES).round().astype(int))
            tails = [tails[i] for i in idx]
        for n in tails:
            self._probes.tail(n)
        for _ in range(_SENTINEL_PROBES - tails.count(_SENTINEL_TAIL)):
            self._probes.tail(_SENTINEL_TAIL)
        if self._last_head_counts:
            self._probes.head(self._last_head_counts)
            self._last_head_counts = []
        if self._last_decode_batch:
            self._probes.dispatch(self._last_decode_batch, moe.n_experts, moe.top_k)
            self._probes.attention(self._last_decode_batch, self._last_kv_depth)

    def _update_pim_health(self, step: int) -> None:
        """Boundary health pass over the measured cost loop.  Two detectors
        feed one gate: drift (the sentinel tail cell's measured time over
        the roofline, a stationary ratio while healthy) and staleness (the
        feed's accepted-poll counter stops advancing when every sample
        fails its filters).  Either quarantines the feed and clamps the
        next export to GPU-only; clearance, with the monitor's hysteresis,
        re-warms the measured path."""
        mon, feed = self.health, self._timing_feed
        if mon is None or feed is None:
            return
        t = float(step)
        raw = feed.last_raw.get(_SENTINEL_TAIL)
        if raw is not None and self._roofline_t1 > 0:
            mon.observe("pim", raw / self._roofline_t1, t=t)
        mon.watch("cost_feed", float(feed.n_ok), t=t)
        healthy = mon.is_healthy("pim") and mon.is_healthy("cost_feed")
        if healthy != self.pim_healthy:
            self.pim_healthy = healthy
            feed.quarantined = not healthy
            if healthy:
                # accept the first measured window ungated: quarantine may
                # have re-seeded the table at the roofline's scale
                feed.rewarm()
        if self.tel.enabled:
            self.tel.gauge("engine/pim_healthy", 1.0 if self.pim_healthy else 0.0)

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        out = logits.float().cpu().numpy()
        if not np.isfinite(out).all():
            raise FloatingPointError("non-finite logits from the model step")
        return out

    def step(self) -> List[Request]:
        """One engine step: admit -> prefill -> decode -> boundary work
        (probes, health, refresh) -> retire."""
        t0 = time.perf_counter()
        tel = self.tel
        step_span = tel.span("engine/step", value=float(self.stats.steps))
        step_span.__enter__()
        with tel.span("engine/admit"):
            # queued requests past their service-start deadline leave
            # before slot assignment: they never held KV
            expired = self.sched.expire_queue(t0)
            for r in expired:
                r.finish_time = t0
                self.sched.finished.append(r)
                self.stats.expired_requests += 1
            if expired and tel.enabled:
                tel.counter("engine/expired_requests", len(expired))
            self.sched.admit()

        # ---- prefill ----
        for req in self.sched.prefill_work():
            batch = {
                "tokens": torch.as_tensor(
                    np.asarray(req.prompt, np.int64)[None, :], device=self.device
                )
            }
            if self.paged is not None:
                # the prompt's blocks up front; _insert_prefill scatters
                # through this block-table row
                self.paged.ensure(req.slot, len(req.prompt))
            if self.uses_cost_split:
                batch["sieve"] = self._sieve_state
            if self.lm.arch.family == "vlm":
                # text tokens: the same position on the t, h and w streams
                pos = torch.arange(len(req.prompt), dtype=torch.int32, device=self.device)
                batch["mrope_positions"] = pos.expand(3, 1, -1)
            with tel.span("engine/prefill", value=float(len(req.prompt))):
                logits, req_cache, p_aux = self.lm.prefill(self.params, batch)
                self._insert_prefill(req.slot, req_cache)
                logits = self._host_logits(logits)
            if self.is_moe:
                self.stats.dropped_tokens += int(p_aux.dropped)
                self.stats.routed_tokens += int(p_aux.counts.sum())
            req.prefill_done = len(req.prompt)
            self.stats.prefill_tokens += len(req.prompt)
            tok = self._sample(logits[:, -1])
            req.generated.append(int(tok[0]))
            if req.first_token_time is None:
                req.first_token_time = time.perf_counter()

        # ---- decode ----
        batch_reqs = self.sched.decode_batch()
        if batch_reqs:
            B = self.cfg.n_slots
            tokens = np.zeros((B, 1), np.int64)
            position = np.zeros((B,), np.int32)
            for r in batch_reqs:
                tokens[r.slot, 0] = r.generated[-1] if r.generated else r.prompt[-1]
                # generated[-1] was sampled but not yet written: it lands
                # one before the request's next-write cursor
                position[r.slot] = r.position - 1 if r.generated else r.position
            inputs = {"tokens": tokens, "position": position}
            if self.lm.arch.family == "vlm":
                inputs["mrope_positions"] = np.broadcast_to(position[None, :, None], (3, B, 1))
            if self.paged is not None:
                # grow block lists to cover this step's KV write, then send
                # the fixed-shape indexing state with the batch
                for r in batch_reqs:
                    self.paged.ensure(r.slot, int(position[r.slot]) + 1)
                inputs.update(block_tables=self.paged.block_table, pool_owner=self.paged.owner,
                              pool_pos=self.paged.block_pos)
            with tel.span("engine/decode", value=float(len(batch_reqs))):
                db = self._fill_decode_inputs(**inputs)
                if self.uses_cost_split:
                    db["sieve"] = self._sieve_state
                logits, aux = self._decode(db)
                logits = self._host_logits(logits)
            toks = self._sample(logits[:, 0])
            for r in batch_reqs:
                r.generated.append(int(toks[r.slot]))
                self.stats.decode_tokens += 1
            self._last_decode_batch = len(batch_reqs)
            self._last_kv_depth = int(position.max()) + 1
            if self.is_moe:
                counts = aux.counts.cpu().numpy()
                self.stats.dropped_tokens += int(aux.dropped)
                self.stats.routed_tokens += int(counts.sum())
                if counts.shape[0] > 0:
                    with tel.span("engine/sieve_host"):
                        self._run_sieve(counts)

        # measured cost loop + cost-table refresh cadence: the on-device
        # split only changes at these boundaries (stale-table semantics
        # between them)
        boundary = (self.stats.steps + 1) % self.sieve_refresh_every == 0
        if boundary and self._probes is not None:
            with tel.span("engine/probe"):
                self._run_probes()
                self._timing_feed.poll()
            self._update_pim_health(self.stats.steps + 1)
        if boundary and self.uses_cost_split:
            with tel.span("engine/sieve_refresh"):
                self._refresh_sieve_state(
                    step=self.stats.steps + 1,
                    gpu_only=not self.pim_healthy or self.brownout_stage >= 2,
                )

        # KV-capacity cap: the next decode writes KV at r.position - 1;
        # finish the request loudly once that reaches max_seq
        for r in self.sched.active:
            if r.generated and not r.done and r.position - 1 >= self.cfg.max_seq:
                r.truncated = True
                self.stats.truncated_requests += 1

        done = self.sched.retire(time.perf_counter())
        if self.paged is not None:
            for r in done:
                self.paged.free_slot(r.slot)
        # deadline-expired queue entries never held a slot
        done = expired + done
        self.stats.steps += 1
        self.stats.wall_time += time.perf_counter() - t0
        if tel.enabled:
            # KV occupancy: share of the slot pool's cells holding live KV
            occ = sum(r.position for r in self.sched.active) / float(
                self.cfg.n_slots * self.cfg.max_seq
            )
            tel.gauge("engine/kv_occupancy", occ)
            if self.paged is not None:
                tel.gauge("engine/kv_pool_used",
                          1.0 - self.paged.n_free / max(self.paged.n_pool - 1, 1))
            tel.gauge("engine/batch_occupancy", len(batch_reqs) / max(self.cfg.n_slots, 1))
            tel.gauge("engine/drop_rate", self.stats.drop_rate)
            # new CUDA graph captures this step (the counterpart of the JAX
            # engine's jit-cache misses): one per engine, none later
            if self.n_captures > self._captures_seen:
                tel.counter("engine/graph_capture", self.n_captures - self._captures_seen)
                self._captures_seen = self.n_captures
        step_span.__exit__(None, None, None)
        return done

    # ------------------------------------------------------------------
    def snapshot(self, snap_dir: str, snap_id: Optional[int] = None,
                 keep: Optional[int] = None) -> str:
        """Atomic, checksummed snapshot of the engine's runtime state (KV
        cache and slots, ``SieveState``, cost table, RNG, requests, feed and
        health monitors).  See :mod:`repro_torch.recovery.snapshot`."""
        from repro_torch.recovery.snapshot import save_engine_snapshot

        return save_engine_snapshot(self, snap_dir, snap_id=snap_id, keep=keep)

    def restore(self, snap_dir: str, snap_id: Optional[int] = None) -> int:
        """Restore from a snapshot (the newest committed one by default,
        walking back past corrupt ones), copying into the tensors a
        captured graph reads: the engine continues bit for bit with no new
        capture.  Returns the snap id restored."""
        from repro_torch.recovery.snapshot import restore_engine_snapshot

        return restore_engine_snapshot(self, snap_dir, snap_id=snap_id)

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.sched.idle:
                break
            self.step()
        return self.sched.finished

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.greedy:
            return logits.argmax(-1)
        z = logits - logits.max(-1, keepdims=True)
        p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
        return np.array([self.rng.choice(p.shape[-1], p=p[i]) for i in range(p.shape[0])])
