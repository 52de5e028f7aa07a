"""Sieve serving engine: continuous batching with the scheduler in the
loop (counterpart of ``repro.serving.engine``).

Per step it admits requests into KV slots and prefills them, runs one
batched decode step whose aux output carries the per-layer expert token
counts, feeds those counts through the host Sieve scheduler into the EMA
cost table (observations from the DRAM-timing PIM model), and, under
``expert_exec="dual_path_cost"``, re-exports the table into the
device-resident ``SieveState`` every ``sieve_refresh_every`` steps.

Where the JAX engine relies on buffer donation and a no-recompile state
swap, this one updates the KV cache in place and refreshes the
``SieveState`` by ``copy_`` into the same device tensors.  The decode
step's inputs are device buffers at fixed addresses, filled by ``copy_``
each step.  On the card, the counterpart of the JAX engine's compiled
step (``jax.jit(lm.decode_step, donate_argnums=(2,))``) is one CUDA graph
of ``LM.decode_step``, captured after the first decode step has run
eagerly and replayed by every later one (:meth:`ServingEngine._decode`).
Prefill runs eagerly: its shape changes with each prompt.  With
``BatchingConfig(paged=True)`` the cache is a shared block pool indexed
through host-side block tables (``PagedKVCache``): blocks are allocated
at prefill and as decode grows a slot, and freed when it retires.  The
measured cost loop, health gating, brownout, telemetry and snapshots are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel, MoELayerSpec, SystemSpec, b200_pim_system
from repro_torch.core.cost_table import CostTable
from repro_torch.core.scheduler import schedule
from repro_torch.core.scheduler_torch import SieveParams, SieveState, export_cost_table
from repro_torch.kernels import ops
from repro_torch.models.model import LM
from repro_torch.sim.dram import PimGemvModel
from .batching import BatchingConfig, PagedKVCache, SlotScheduler
from .request import Request


@dataclass
class EngineStats:
    steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0
    wall_time: float = 0.0
    dropped_tokens: int = 0
    routed_tokens: int = 0
    truncated_requests: int = 0
    expired_requests: int = 0
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
        sieve_refresh_every: int = 16,
        cost_source: str = "model",
        telemetry: Any = None,
        health: Any = None,
    ):
        if cost_source != "model":
            raise NotImplementedError(
                f"cost_source={cost_source!r}: only the model-fed cost table is ported"
            )
        if telemetry is not None or health is not None:
            raise NotImplementedError("engine telemetry and health gating are not ported yet")
        self.lm = lm
        self.params = params
        self.cfg = batching
        self.policy = policy
        self.sched = SlotScheduler(batching)
        self.stats = EngineStats()
        self.cost_source = cost_source
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

        arch = lm.arch
        self.is_moe = arch.moe is not None
        self.uses_cost_split = self.is_moe and arch.moe.expert_exec == "dual_path_cost"
        self.sieve_refresh_every = max(int(sieve_refresh_every), 1)
        self.sieve_refreshes: List[int] = []
        self._sieve_state: Optional[SieveState] = None
        self._sieve_version = -1
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
            if self.uses_cost_split:
                # per-expert counts are bounded by the step's token count;
                # the split clamps larger counts to the last table entry
                self._sieve_max_count = min(
                    4096, max(batching.n_slots, batching.max_seq, 64)
                )
                self._refresh_sieve_state(step=0)

    # ------------------------------------------------------------------
    def _decode_buffers(self):
        """The decode step's inputs on the device, allocated once, and their
        host staging buffers (pinned on the card, so the fill is an
        asynchronous copy): tokens and positions, and for a paged cache the
        block tables, pool owners and block positions."""
        B = self.cfg.n_slots
        shapes = {"tokens": (B, 1), "position": (B,)}
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

    def _refresh_sieve_state(self, step: int) -> None:
        """Re-export (CostTable, CostModel) into the device ``SieveState``.

        The first export allocates the two tensors; later ones ``copy_``
        into them, so every prefill and decode step reads the same tensors
        and a refresh is one small host-to-device copy.  Skipped when the
        table has not changed since the last export."""
        if self._sieve_state is not None and self.cost_table.version == self._sieve_version:
            return
        table = torch.from_numpy(
            export_cost_table(self.cost_table, self.cost_model, self._sieve_max_count)
        )
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
        self.sieve_refreshes.append(step)

    def _insert_prefill(self, slot: int, req_cache) -> None:
        """Copy one request's prompt K/V into its slot of the cache.  Paged:
        the rows are padded to whole pages and scattered over the slot's
        first blocks; the padded rows lie at or past the length and are
        never read."""
        if self.paged is None:
            for dst, src in zip(self.cache["blocks"], req_cache["blocks"]):
                P = src.shape[2]
                dst[:, slot, :P].copy_(src[:, 0])
            return
        page = self.paged.page
        for dst, src in zip(self.cache["blocks"], req_cache["blocks"]):
            L, _, P = src.shape[:3]
            nbp = -(-P // page)
            ids = torch.as_tensor(self.paged.block_table[slot, :nbp], device=dst.device).long()
            rows = torch.nn.functional.pad(src[:, 0], (0, 0, 0, 0, 0, nbp * page - P))
            dst[:, ids] = rows.reshape((L, nbp, page) + rows.shape[2:]).to(dst.dtype)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        if len(req.prompt) > self.cfg.max_seq:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds the KV capacity "
                f"max_seq={self.cfg.max_seq}; raise BatchingConfig.max_seq "
                "or truncate the prompt"
            )
        self.sched.submit(req)
        return True

    def set_brownout_stage(self, stage: int) -> None:
        raise NotImplementedError("brownout stages are not ported yet")

    def snapshot(self, *args, **kwargs):
        raise NotImplementedError("engine snapshots are not ported yet")

    def restore(self, *args, **kwargs):
        raise NotImplementedError("engine snapshots are not ported yet")

    def _run_sieve(self, counts_per_layer: np.ndarray) -> None:
        """Host-side scheduler pass over this step's per-layer counts: the
        chosen PIM set's times (from the DRAM-timing model) feed the EMA
        cost table."""
        kw = {}
        if self.policy == "dual_cost":
            moe = self.lm.arch.moe
            kw = {"tail_tokens": moe.dual_tail_tokens, "max_head": moe.dual_max_head}
        for li, counts in enumerate(counts_per_layer):
            part = schedule(self.policy, counts, self.cost_model, self.cost_table, **kw)
            if self._pim is not None:
                for e in part.pim_experts:
                    n = int(counts[e])
                    if n > 0:
                        self.cost_table.update(n, self._pim.expert_time(self.layer_spec, n))
            self.stats.partitions.append(
                {
                    "step": self.stats.steps,
                    "layer": li,
                    "n_gpu": len(part.gpu_experts),
                    "n_pim": len(part.pim_experts),
                    "t_total_est": part.t_total,
                }
            )

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        out = logits.float().cpu().numpy()
        if not np.isfinite(out).all():
            raise FloatingPointError("non-finite logits from the model step")
        return out

    def step(self) -> List[Request]:
        """One engine step: admit -> prefill -> decode -> retire."""
        t0 = time.perf_counter()
        expired = self.sched.expire_queue(t0)
        for r in expired:
            r.finish_time = t0
            self.sched.finished.append(r)
            self.stats.expired_requests += 1
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
            if self.paged is not None:
                # grow block lists to cover this step's KV write, then send
                # the fixed-shape indexing state with the batch
                for r in batch_reqs:
                    self.paged.ensure(r.slot, int(position[r.slot]) + 1)
                inputs.update(block_tables=self.paged.block_table, pool_owner=self.paged.owner,
                              pool_pos=self.paged.block_pos)
            db = self._fill_decode_inputs(**inputs)
            if self.uses_cost_split:
                db["sieve"] = self._sieve_state
            logits, aux = self._decode(db)
            logits = self._host_logits(logits)
            toks = self._sample(logits[:, 0])
            for r in batch_reqs:
                r.generated.append(int(toks[r.slot]))
                self.stats.decode_tokens += 1
            if self.is_moe:
                counts = aux.counts.cpu().numpy()
                self.stats.dropped_tokens += int(aux.dropped)
                self.stats.routed_tokens += int(counts.sum())
                if counts.shape[0] > 0:
                    self._run_sieve(counts)

        # cost-table refresh cadence: the on-device split only changes at
        # these boundaries (stale-table semantics between them)
        boundary = (self.stats.steps + 1) % self.sieve_refresh_every == 0
        if boundary and self.uses_cost_split:
            self._refresh_sieve_state(step=self.stats.steps + 1)

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
        return done

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.sched.idle:
                break
            self.step()
        return self.sched.finished

    @staticmethod
    def _sample(logits: np.ndarray) -> np.ndarray:
        """Greedy decoding, the only sampling the port has yet."""
        return logits.argmax(-1)
