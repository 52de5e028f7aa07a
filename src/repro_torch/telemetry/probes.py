"""Measured stage-timing probes for the decode hot path (counterpart of
``repro.telemetry.probes``).

On the card the decode step is one captured CUDA graph, so per-stage times
cannot be read off it.  :class:`StageProbes` runs each stage standalone,
with representative shapes, through the stage code the step executes:
:func:`repro_torch.models.moe.tail_stage` (the fused ``swiglu_gemv``
kernel, or three ``expert_gemv`` calls under ``REPRO_FUSED_SWIGLU=0``),
:func:`~repro_torch.models.moe.head_stage` (``swiglu_gmm_capacity`` or
``gmm_capacity``), :func:`~repro_torch.models.moe.dispatch`, and the
decode-attention kernel the step runs (``ops.decode_attention``, or
``ops.decode_attention_paged`` for an engine with a paged KV cache).  The
JAX probes time their XLA attention reference there; the attention span
feeds only the trace, never the cost table, so the difference cannot move
the split.

Each probe is recorded as a telemetry span whose ``value`` carries the
probed token count, so :class:`repro_torch.telemetry.TimingFeed` can feed
the tail-stage spans into ``CostTable.update_batch``.

Timing: on the card, a pair of CUDA events on the current stream (the
stream that replays the engine's graph) around the stage, and one
synchronize on the end event: the span holds device time.  On the CPU,
``time.perf_counter`` around the call.  The JAX probes take wall time,
dispatch included; the engine's health gate compares the sentinel's time
with the roofline through an EMA baseline, which absorbs a constant scale.

Weights and activations are synthetic (stage times depend on shapes and
kernels, not values), drawn once from a ``torch.Generator`` seeded from
``seed``.  Inputs are memoized per shape and shapes are bucketed (powers
of two); the first call at a new shape runs untimed, so spans only
measure execution.  That first call creates the kernels' kept state for
the shape (scratch, tickets): a probe must never run inside a CUDA graph
capture, and the engine runs probes between steps on the replay's stream.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import moe
from .core import Telemetry

DISPATCH_SPAN = "stage/dispatch"
HEAD_SPAN = "stage/head_gmm"
TAIL_SPAN = "stage/tail_gemv"
ATTN_SPAN = "stage/attention"

_HEAD_GROUPS = 8  # fixed probe group count (counts pad/clip to this)


def _pow2_bucket(n: int, lo: int = 8, hi: int = 4096) -> int:
    b = lo
    while b < min(n, hi):
        b *= 2
    return b


class StageProbes:
    """Runs one decode stage standalone and records its measured duration
    as a telemetry span.

    ``d_model``/``d_expert`` are one MoE layer's dims; ``attn_dims`` is
    ``(n_heads, n_kv_heads, d_head)`` for the attention probe, which runs
    through a block pool of ``page_size``-token pages when that is given.
    ``dtype``/``device`` are the model's.  Requires an *enabled*
    :class:`Telemetry`: the spans are the measurement record.
    """

    def __init__(
        self,
        d_model: int,
        d_expert: int,
        telemetry: Telemetry,
        attn_dims: Optional[Tuple[int, int, int]] = None,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        page_size: Optional[int] = None,
    ):
        self.tel = telemetry
        self.d_model = int(d_model)
        self.d_expert = int(d_expert)
        self.attn_dims = attn_dims
        self.page_size = page_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # single-expert weights for the tail probe; _HEAD_GROUPS experts for
        # the head probe (gathered layouts, exactly what the stages eat)
        d, f, G = self.d_model, self.d_expert, _HEAD_GROUPS
        self._wg1, self._wu1 = self._randn((1, d, f), 0.05), self._randn((1, d, f), 0.05)
        self._wd1 = self._randn((1, f, d), 0.05)
        self._wgh, self._wuh = self._randn((G, d, f), 0.05), self._randn((G, d, f), 0.05)
        self._wdh = self._randn((G, f, d), 0.05)
        self._memo: Dict[tuple, tuple] = {}  # key -> (fn, args)
        self._events = None  # the CUDA event pair, made on first use
        self.n_probes = 0
        # Fault-injection hook: ``corrupt(span_name, value, dt) -> dt'``
        # rewrites a measured duration before it is recorded, so the
        # measurement channel (not the stage code) is what a fault attacks
        # and the TimingFeed/health defenses downstream are what's tested.
        self.corrupt: Optional[Callable[[str, float, float], float]] = None

    def _randn(self, shape, scale: float = 1.0) -> torch.Tensor:
        x = torch.randn(shape, generator=self._gen, device=self.device)
        return x.mul_(scale).to(self.dtype)

    def _i32(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int32).to(self.device)

    # ------------------------------------------------------------------
    def _timed(self, span_name: str, value: float, fn, args) -> float:
        """Run ``fn(*args)`` to completion; records the measured duration
        (through the optional :attr:`corrupt` hook) as a span and returns
        it in seconds."""
        t0_ns = self.tel._clock() if self.tel.enabled else 0
        if self.device.type == "cuda":
            if self._events is None:
                self._events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            start, end = self._events
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            fn(*args)
            dt = time.perf_counter() - t0
        if self.corrupt is not None:
            dt = float(self.corrupt(span_name, value, dt))
        if self.tel.enabled:
            # non-finite corruption cannot be represented in the int64
            # ring; record a zero-duration span (rejected downstream)
            dur = dt if math.isfinite(dt) else 0.0
            self.tel.span_at(span_name, t0_ns * 1e-9, dur, value=value)
        self.n_probes += 1
        return dt

    def _get(self, key, build):
        """Memoized (fn, fixed args); the first build runs once untimed."""
        hit = self._memo.get(key)
        if hit is None:
            fn, args = build()
            fn(*args)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            hit = self._memo[key] = (fn, args)
        return hit

    # ------------------------------------------------------------------
    def tail(self, n_tokens: int) -> float:
        """Measure the tail stage for one expert with ``n_tokens`` rows: the
        per-expert "PIM GEMV" cell the cost table is keyed on (span value
        ``n_tokens``)."""
        n = max(int(n_tokens), 1)

        def build():
            toks = self._randn((n, self.d_model))
            eids = torch.zeros((n,), dtype=torch.int32, device=self.device)
            valid = torch.ones((n,), dtype=torch.int32, device=self.device)

            def fn(t, e, v):
                return moe.tail_stage(t, self._wg1, self._wu1, self._wd1, e, v)

            return fn, (toks, eids, valid)

        fn, args = self._get(("tail", n), build)
        return self._timed(TAIL_SPAN, float(n), fn, args)

    def head(self, counts: Iterable[int]) -> float:
        """Measure the grouped head stage over a hot-expert slab shaped like
        ``counts`` (padded/clipped to the fixed probe group count; capacity
        bucketed to a power of two).  Span value = total rows."""
        cs = sorted((int(c) for c in counts if c > 0), reverse=True)
        cs = (cs + [0] * _HEAD_GROUPS)[:_HEAD_GROUPS]
        cap = _pow2_bucket(max(cs) if cs else 1)
        cs = [min(c, cap) for c in cs]

        def build():
            slab = self._randn((_HEAD_GROUPS, cap, self.d_model))

            def fn(s, sz):
                return moe.head_stage(s, self._wgh, self._wuh, self._wdh, sz)

            return fn, (slab, self._i32([0] * _HEAD_GROUPS))

        fn, (slab, sizes) = self._get(("head", cap), build)
        sizes.copy_(torch.as_tensor(cs, dtype=torch.int32))
        return self._timed(HEAD_SPAN, float(sum(cs)), fn, (slab, sizes))

    def dispatch(self, n_tokens: int, n_experts: int, top_k: int) -> float:
        """Measure the routing-dispatch stage at the decode batch shape."""
        T = max(int(n_tokens), 1)
        cap = _pow2_bucket(max(T * top_k // max(n_experts, 1), 1))

        def build():
            x = self._randn((T, self.d_model))
            eidx = torch.randint(0, n_experts, (T, top_k), generator=self._gen,
                                 device=self.device).to(torch.int32)
            w = torch.full((T, top_k), 1.0 / top_k, dtype=self.dtype, device=self.device)

            def fn(x, eidx, w):
                flat = eidx.reshape(-1).long()
                counts = torch.zeros((n_experts,), dtype=torch.int32, device=x.device).index_add_(
                    0, flat, torch.ones_like(flat, dtype=torch.int32))
                zero = torch.zeros((), dtype=torch.float32, device=x.device)
                return moe.dispatch(x, moe.RouterOut(eidx, w, zero, counts), n_experts, cap).buf

            return fn, (x, eidx, w)

        fn, args = self._get(("dispatch", T, n_experts, top_k, cap), build)
        return self._timed(DISPATCH_SPAN, float(T * top_k), fn, args)

    def attention(self, batch: int, seq: int) -> float:
        """Measure decode attention at (batch, bucketed KV depth)."""
        if self.attn_dims is None:
            return 0.0
        n_heads, n_kv, d_head = self.attn_dims
        B = max(int(batch), 1)
        S = _pow2_bucket(max(int(seq), 1))

        def build():
            q = self._randn((B, n_heads, d_head))
            lens = self._i32([S] * B)
            if self.page_size is None:
                ck, cv = (self._randn((B, S, n_kv, d_head)) for _ in range(2))
                return ops.decode_attention, (q, ck, cv, lens)
            # each row's blocks in order after the trash block 0
            page = self.page_size
            nb = -(-S // page)
            pk, pv = (self._randn((B * nb + 1, page, n_kv, d_head)) for _ in range(2))
            tables = torch.arange(1, B * nb + 1, dtype=torch.int32, device=self.device).reshape(B, nb)
            return ops.decode_attention_paged, (q, pk, pv, tables, lens)

        fn, args = self._get(("attn", B, S), build)
        return self._timed(ATTN_SPAN, float(B * S), fn, args)
