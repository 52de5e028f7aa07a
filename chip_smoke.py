#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the seven CUDA kernel libraries from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, all
   at once) and prints the time;
3. kernels: holds each kernel against its plain PyTorch version on the card
   at the main path's shapes plus edge cases (bf16 tolerance rtol = atol =
   2e-2; exact zeros on dead rows and length-0 rows; empty KV splits; trash
   table cells, an idle slot on the trash block, poisoned free blocks and
   table cells outside the pool).  The five kernels that leave counters
   for the next launch (the fused head, dense, split-KV and paged decode
   attention, the grouped GEMM) run each case three times on the same
   buffers, each launch against the plain version and all three bitwise
   equal.  A ``torch.profiler`` trace of one head call must hold one
   kernel.  It times kernel, plain version and one PyTorch library call
   with CUDA events (median and min-max of 20 launches; the head at its
   prefill shape too), and each wrapper's host time per call.  The split-KV
   kernel has no model caller: its path is its entry point, driven once
   per layer of a decode step with the counts zeroed.  Then the rows
   beyond qwen3-moe's shapes, each held and timed the same way: dense,
   split-KV and paged attention at granite-3-2b's decode shape (the dh-64
   instance), at zamba2-7b's shared-attention shape (the dh-112
   instance) and with a 32-head query group at dh 128 (the last two on
   their entry points),
   ``gmm_ragged`` at the decode gate call's routing, and the four MoE
   kernels (fused head and tail, grouped matmul, expert GEMV) again at
   deepseek-v2-236b's shapes (160 experts top-6, d_model 5120, d_expert
   1536; phase 7's model); the rows without a
   model caller are driven as one decode step would drive them.  The
   attention kernels are also held (not timed) at the decode shape of each
   family that phase 6 serves, on each KV layout it is served on.  With
   ``--parent-csrc DIR`` (the parent commit's
   ``src/repro_torch/kernels/csrc``, unpacked) it also builds the parent's
   dense, split-KV and paged attention, times them in turns beside the new
   ones on the same inputs, and requires the outputs of all three to equal
   the parent's bit for bit at dh 128;
4. serving: builds qwen3-moe-30b-a3b at full width and depth in bf16 with
   seeded random weights and serves the same 12 requests twice through
   ``ServingEngine``: a dense KV cache with the fused SwiGLU kernels, then
   a paged KV cache (page 16) with the three-call MoE path
   (``REPRO_FUSED_SWIGLU=0``).  The engine runs its first decode step
   eagerly, captures the step as a CUDA graph and replays it on every
   later decode step.  Each run zeroes the launch counters just before
   and checks every request and token, that every decode step after the
   first replayed the graph, that its path's kernels launched (counted
   through the replays) and no other did, and (paged) that the pool is all
   free again; it records per phase (prefill, decode) the head's live
   rows, the tail's valid rows and the tokens dropped, and fails unless
   they add up to the routed assignments and both head and tail had
   rows; profiled windows of replayed and of eager decode steps then split
   a step into device time, host sieve time and idle share.  After each
   run a 2-layer slice of the same weights on that path is held against
   the plain path on the CPU, with the router's discrete choices shared
   between the two devices.  Last, full-batch decode steps of the two
   paths, eager and replayed, are timed in turns, and the eager and
   replayed engines must give the same tokens;
5. runtime: on each path, after its serving run, the engine's runtime loop
   at full width and depth.  A measured engine (``cost_source="measured"``,
   telemetry on, the 12 requests of phase 4) probes the path's head, tail
   and attention kernels at every refresh boundary, timed with CUDA events
   on the replay's stream; it must keep one graph capture and launch only
   its path's kernels, and its trace goes to ``chiprun_out/``.  A second
   measured engine has its sentinel tail probe slowed 16x over a window of
   steps: it must be quarantined within one refresh cadence, put no tail
   rows on the PIM side while the split is GPU-only, and be healthy again
   after the window; then brownout stage 2 and back, stage 3 sheds a batch
   request and stage 1 clamps one, all with one capture.  Two engines with
   ``greedy=False, seed=7`` must give the same tokens.  Last, an engine
   snapshotted mid-run and restored into a fresh engine and into its own
   captured graph must continue with the same tokens, last logits and KV
   cache bit for bit, with one capture each;
6. families: qwen3-moe's weights are freed, then the dense and VLM
   families are built at full width with seeded random weights and each
   serves 12 seeded requests as phase 4 does (one capture, every later
   decode step replayed, all tokens, one attention launch per layer and
   decode step and no other kernel): granite-3-2b (40 layers, dh 64) on
   the dense KV cache and on the paged pool, qwen1.5-0.5b (24 layers, dh
   64, MHA, QKV bias), qwen2-vl-7b (28 layers, M-RoPE positions at prefill
   and decode), and two-layer slices of granite-3-8b and
   deepseek-coder-33b; the full-depth runs are profiled as phase 4's
   are.  Each run's 2-layer slice agrees with the CPU plain
   path under the phase-4 rule (qwen2-vl-7b's on the vision-patch stub with
   distinct t/h/w positions), and qwen2-vl-7b prefills 256 stub
   embeddings at full depth;
7. deepseek-v2: after phase 6 frees the families' weights,
   deepseek-v2-236b is built at full width but cut to 5 of its 60 layers (the dense first layer and four MoE layers,
   MLA attention, 2 shared experts; its 236B parameters do not fit one
   card), bf16 seeded random weights, on the Sieve dual path
   (``expert_exec="dual_path_cost"``), and serves the 12 requests of phase
   4 on the dense KV cache twice, fused and three-call, each with phase
   4's checks (one capture, only its path's MoE kernels and no attention
   kernel, head + tail + drops equal to the routed assignments), its
   profile and its 2-layer slice (the dense block and the first MoE
   block) against the CPU plain path; MLA decode's share of a replayed
   step's device time is timed as a captured graph of its own, and eager
   and replayed engines of both paths must give the same tokens;
8. policies and chaos, on qwen3-moe's weights after phase 5's dense
   runtime (before phase 6 frees them) and on deepseek-v2's in phase 7.
   Every policy of ``core.scheduler.POLICIES`` is timed on the host (the
   CPU's model printed beside it) over phase 4's recorded full-batch
   decode steps (48 layers x 128 experts; deepseek-v2's fused run: 4 x
   160), median and min-max per step, each partition covering its
   layer's active experts.  ``sieve_partition_torch`` and
   ``sieve_partition_dynamic``, greedy and argmin, are each captured once
   as a CUDA graph and replayed with every recorded layer's counts
   written in place: the GPU set must equal the host ``sieve_schedule``'s
   exactly; CUDA events time replayed and eager calls.  The
   fixed-threshold dual path (``expert_exec="dual_path"``, policy
   ``dual_threshold``) serves the 12 requests of phase 4 with its checks:
   on every replayed decode step the captured row counters (head groups,
   head rows, tail rows) must equal ``dual_threshold_schedule`` on the
   step's counts, and its 2-layer slice passes the phase-4 rule; its step
   time, tokens/s, TTFT and TPOT print beside the ``dual_path_cost`` run.
   A measured engine built as phase 5's runs each engine chaos scenario
   (``EngineChaos``, ``make_plan(scenario, 48, seed=0)``) and must be
   detected and clamped to GPU-only within one refresh cadence, restored,
   and keep one capture; its tokens are compared with a x1 control (a
   count, not asserted: the clamp moves rows between two bf16 kernels).
   Last, ``run_engine_chaos(device="cuda")`` at proxy size under each
   scenario with tests/test_faults.py's checks.

It prints the kernel table as one JSON line, the ``nvidia-smi`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
TOL = dict(rtol=2e-2, atol=2e-2)  # bf16, as tests/test_fused_swiglu.py:50

SOURCES = {
    "swiglu_gmm_capacity": ("src/repro_torch/kernels/csrc/fused_swiglu_gmm.cu",
                            "src/repro/kernels/fused_swiglu.py:133"),
    "swiglu_gemv": ("src/repro_torch/kernels/csrc/fused_swiglu_gemv.cu",
                    "src/repro/kernels/fused_swiglu.py:289"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:193"),
    "decode_attention_split": ("src/repro_torch/kernels/csrc/decode_attention_split.cu",
                               "src/repro/kernels/decode_attention.py:274"),
    "decode_attention_paged": ("src/repro_torch/kernels/csrc/decode_attention_paged.cu",
                               "src/repro/kernels/decode_attention.py:338"),
    "gmm_capacity": ("src/repro_torch/kernels/csrc/grouped_gemm.cu",
                     "src/repro/kernels/grouped_gemm.py:85"),
    # the same pallas_call through the ragged layout's wrapper
    "gmm_ragged": ("src/repro_torch/kernels/csrc/grouped_gemm.cu", "src/repro/kernels/ops.py:130"),
    "expert_gemv": ("src/repro_torch/kernels/csrc/expert_gemv.cu",
                    "src/repro/kernels/expert_gemv.py:64"),
}
# the kernels each serving path must launch; every other kernel stays at 0
DENSE_FUSED_PATH = ("swiglu_gmm_capacity", "swiglu_gemv", "decode_attention")
PAGED_UNFUSED_PATH = ("gmm_capacity", "expert_gemv", "decode_attention_paged")
SPLIT_KV_SPLITS = 4  # n_splits of the split-KV entry-point drive
RUNTIME_REFRESH = 4  # sieve_refresh_every of the runtime phase's engines


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {card}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build(build.KERNELS)
    for name in build.KERNELS:
        build.load(name)
    seconds = time.perf_counter() - t0
    log(f"build: {len(build.KERNELS)} kernels in {seconds:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return {"seconds": seconds, "ptxas": logs}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_samples(fn, iters: int = 20, warmup: int = 2, flush_by: str = "write") -> list:
    """Device time of each of ``iters`` launches of ``fn`` (ms), by CUDA
    events.  Before each, zeroing a 1 GiB buffer flushes the 50 MB L2 and
    keeps the card busy (about 0.3 ms) while the host runs ``fn``'s Python
    wrapper (20-65 us), so the timed window holds the kernels, not the
    host's launch latency.  The zeros leave the L2 full of dirty lines,
    which a kernel that reads more than the L2 holds writes back to
    memory; ``flush_by="read"`` flushes by reading the buffer instead,
    which leaves the L2 clean."""
    import torch

    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(iters):
        if flush_by == "read":
            flush.amax()
        else:
            flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        samples.append(e0.elapsed_time(e1))
    return samples


def spread(samples) -> dict:
    """Median and min-max of timing samples (ms)."""
    import numpy as np

    return dict(median=float(np.median(samples)), min=float(min(samples)), max=float(max(samples)),
                n=len(samples))


def timings(**fns) -> dict:
    """For each named callable, its median device time over 20 launches
    (``time_samples``) under the name, and the median with its min-max
    under ``<name>_spread``."""
    out = {}
    for name, fn in fns.items():
        sp = spread(time_samples(fn))
        out[name], out[f"{name}_spread"] = sp["median"], sp
    return out


def in_turns(parent_fn, new_fn, flush_by: str = "write") -> dict:
    """The parent commit's kernel and the new one on the same inputs, timed
    in turns (parent, new, new, parent; 20 launches a turn), so drift over
    the call falls on both: each one's median and min-max over its 40."""
    samples = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        samples[who] += time_samples(parent_fn if who == "parent" else new_fn, flush_by=flush_by)
    out = {who: spread(v) for who, v in samples.items()}
    out["new_over_parent"] = out["new"]["median"] / out["parent"]["median"]
    return out


def load_parent(csrc: Path) -> dict:
    """The parent commit's dense, split-KV and paged decode attention,
    built from its ``csrc`` directory (an unpacked ``git archive`` of the
    parent) with the port's nvcc flags into a temporary directory, and
    bound under the parent's C interface (as of commit 91c1063): launch
    functions by kernel name, plus the split count of each."""
    import ctypes
    import tempfile

    from repro_torch.kernels import build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {
        # q, k, v, lengths, part, lse, tickets, out, B, T, Kv, G, dh, scale, stream
        "decode_attention": [P] * 8 + [I] * 5 + [F, P],
        "decode_attention_split": [P] * 8 + [I] * 5 + [F, P],
        # q, pool_k, pool_v, tables, lengths, part, lse, tickets, out, B, n_pool,
        # page, Kv, G, dh, max_blocks, scale, stream
        "decode_attention_paged": [P] * 9 + [I] * 7 + [F, P],
    }
    tmp = tempfile.TemporaryDirectory(prefix="parent_kernels_")
    procs = {
        name: subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", f"{tmp.name}/{name}.so", str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in argtypes
    }
    fns = {"_tmp": tmp}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"parent {name} did not build:\n{out}")
        lib = ctypes.CDLL(f"{tmp.name}/{name}.so")
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes[name], ctypes.c_int
        fns[name] = fn
        lib.decode_attention_splits.argtypes, lib.decode_attention_splits.restype = [I], ctypes.c_int
        fns[f"{name}_splits"] = lib.decode_attention_splits
    log(f"parent kernels built from {csrc}")
    return fns


def _kernels_per_call(call, traces: int = 3) -> list:
    """The device kernels one ``call`` runs, by name, from a
    ``torch.profiler`` trace of that call alone.  A trace that recorded no
    device event at all (the profiler missed the device, as it did once in
    six runs on the card) is taken again, up to ``traces`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()  # built and initialised outside the trace
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if names:
            break
        log("kernels per call: the profiler recorded no device event; tracing again")
    return sorted(n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                  .split("::")[-1] for n in names)


def host_us(fn, calls: int = 50) -> float:
    """Mean host time of one call of ``fn``: the wrapper's checks,
    allocations and launch, not the device work (the queue of 50 launches
    stays far below the CUDA launch queue's depth, so no call waits on
    the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / calls


def _compare(name: str, got, want, zero_rows=None) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, **TOL):
        fail(f"{name}: kernel disagrees with its plain version, max |err| = {err}")
    if zero_rows is not None and bool((g[zero_rows] != 0).any()):
        fail(f"{name}: rows that must be exactly zero are not")
    return err


def _repeat_compare(name: str, call, want, zero_rows=None, times: int = 3) -> float:
    """``times`` back-to-back launches on the same buffers, each held
    against the plain version (a ticket counter that a launch left non-zero
    breaks the next one), and bitwise equal to each other (split partials
    summed in a fixed order)."""
    import torch

    outs = [call() for _ in range(times)]
    err = max(_compare(f"{name} (launch {i + 1} of {times})", o, want, zero_rows)
              for i, o in enumerate(outs))
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        fail(f"{name}: repeated launches on the same inputs differ in bits")
    return err


def _decode_routing(E: int, k: int, n_tok: int, seed: int):
    """Per-expert counts of one decode step's routing: ``n_tok`` tokens
    each choosing ``k`` distinct experts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = np.zeros(E, np.int64)
    for _ in range(n_tok):
        counts[rng.choice(E, size=k, replace=False)] += 1
    return counts


def phase_moe_kernels(arch, gen, suffix: str = "") -> dict:
    """The four MoE kernels (the fused head and tail, the grouped matmul
    and the expert GEMV) against their plain versions at ``arch``'s widths
    and expert count, then timed: a decode step's routing of 8 tokens,
    capacity ``C`` at 8 tokens, and the head and the grouped matmul's down
    call at a 512-token prefill's capacity too.  Rows are named
    ``<kernel><suffix>``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import capacity

    dev = torch.device("cuda")
    bf = torch.bfloat16
    E, K, Fd, N = arch.moe.n_experts, arch.d_model, arch.moe.d_expert, arch.d_model
    n_slots = 8
    C_dec = capacity(n_slots, arch.moe, E)  # 8 tokens: the min_capacity floor
    C_pre = capacity(512, arch.moe, E)  # a 512-token prefill chunk

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    wg = rnd((E, K, Fd), K**-0.5)
    wu = rnd((E, K, Fd), K**-0.5)
    wd = rnd((E, Fd, N), Fd**-0.5)
    counts = _decode_routing(E, arch.moe.top_k, n_slots, seed=1)
    results = {}

    # ---- kernel 1: head grouped SwiGLU ----
    # persistent, one launch: each case three launches on the same buffers
    # (readiness counters back at zero after each) with bitwise-equal outputs
    head = np.where(counts >= 2, counts, 0)
    prefill_sizes = np.random.default_rng(5).integers(0, C_pre + 1, E)  # ragged, 0-C_pre
    rog = torch.as_tensor(np.random.default_rng(4).integers(0, E, E), dtype=torch.int32, device=dev)
    over = head.copy()
    over[np.flatnonzero(head)[:3]] = C_dec + 5  # past the capacity: clamped to C
    errs = []
    for C, sizes, rhs_of_group in (
        (C_dec, head, None),  # the decode step's head split
        (C_pre, prefill_sizes, None),  # prefill, T=512
        (C_dec, np.r_[np.zeros(E // 2, np.int64), np.full(E // 2, C_dec)], None),  # dead groups
        (C_dec, np.zeros(E, np.int64), None),  # every group dead
        (C_dec, over, None),
        (C_dec, head, rog),  # groups sharing experts
    ):
        buf = rnd((E, C, K))
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        want = ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, gs, rhs_of_group)
        dead = torch.arange(C, device=dev)[None, :] >= gs[:, None]
        errs.append(_repeat_compare(
            f"swiglu_gmm_capacity C={C}, {int((sizes > 0).sum())} live groups"
            f"{', rhs_of_group' if rhs_of_group is not None else ''}",
            lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, gs, rhs_of_group), want,
            zero_rows=dead))
    buf = rnd((E, C_dec, K))
    gs = torch.as_tensor(head, dtype=torch.int32, device=dev)
    buf_pre = rnd((E, C_pre, K))
    gs_pre = torch.as_tensor(prefill_sizes, dtype=torch.int32, device=dev)
    live_rows = int(head.sum())
    n_live = int((head > 0).sum())
    kernels_per_call = _kernels_per_call(lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, gs))
    if kernels_per_call != ["fused_swiglu_gmm_kernel"]:
        fail(f"one swiglu_gmm_capacity call ran the kernels {kernels_per_call}, not one fused kernel")

    def library_head():
        h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        return torch.bmm(h, wd) * (torch.arange(C_dec, device=dev)[None, :, None] < gs[:, None, None])

    def head_bytes(n_groups, rows, C):
        return n_groups * 3 * K * Fd * 2 + rows * K * 2 + E * C * N * 2 + E * 4

    byts = head_bytes(n_live, live_rows, C_dec)
    flops = 2 * live_rows * 3 * K * Fd
    pre_rows = int(prefill_sizes.sum())
    pre_bound = max(head_bytes(int((prefill_sizes > 0).sum()), pre_rows, C_pre) / PEAK_HBM_BYTES,
                    2 * pre_rows * 3 * K * Fd / PEAK_BF16_FLOPS) * 1e3
    results["swiglu_gmm_capacity"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, gs)),
        kernels_per_call=kernels_per_call,
        **timings(ms=lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, gs),
                  plain_ms=lambda: ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, gs),
                  library_ms=library_head,
                  prefill_ms=lambda: ops.swiglu_gmm_capacity(buf_pre, wg, wu, wd, gs_pre)),
        # the same, the L2 flushed by a read (no dirty lines to write back)
        clean_l2_ms=spread(time_samples(lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, gs),
                                        flush_by="read")),
        bytes=byts, flops=flops, prefill_bound_ms=pre_bound,
        shape=f"buf ({E},{C_dec},{K}), {n_live} live groups, {live_rows} live rows",
        prefill_shape=f"buf ({E},{C_pre},{K}), {int((prefill_sizes > 0).sum())} live groups, "
                      f"{pre_rows} live rows",
    )

    # ---- kernel 2: tail per-row SwiGLU GEMV ----
    S = E  # E * tau rows, tau = 1
    eids = torch.arange(E, dtype=torch.int32, device=dev)
    valid_np = (counts == 1).astype(np.int32)
    errs = []
    for v in (valid_np, np.zeros(S, np.int32), np.ones(S, np.int32)):
        toks = rnd((S, K))
        valid = torch.as_tensor(v, device=dev)
        got = ops.swiglu_gemv(toks, wg, wu, wd, eids, valid)
        want = ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, eids, valid)
        errs.append(_compare("swiglu_gemv", got, want, zero_rows=valid == 0))
    # strided rows, as the tail path passes buf[:, :1]
    slab = rnd((E, C_dec, K))
    valid = torch.as_tensor(valid_np, device=dev)
    got = ops.swiglu_gemv(slab[:, :1].reshape(E, K), wg, wu, wd, eids, valid)
    want = ref.fused_swiglu_gemv_ref(slab[:, 0].contiguous(), wg, wu, wd, eids, valid)
    errs.append(_compare("swiglu_gemv strided", got, want, zero_rows=valid == 0))
    toks = rnd((S, K))
    n_valid = int(valid_np.sum())

    def library_tail():
        h = F.silu(torch.bmm(toks[:, None], wg)) * torch.bmm(toks[:, None], wu)
        return torch.bmm(h, wd)[:, 0] * valid[:, None]

    results["swiglu_gemv"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid)),
        **timings(ms=lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid),
                  plain_ms=lambda: ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, eids, valid),
                  library_ms=library_tail),
        bytes=n_valid * (3 * K * Fd * 2 + K * 2) + S * N * 2 + S * 8,
        flops=2 * n_valid * 3 * K * Fd,
        shape=f"tokens ({S},{K}), {n_valid} valid rows",
    )

    # ---- kernel 6: grouped matmul, one call of the three-call head ----
    # persistent split-K: each case three launches on the same buffers
    # (tickets back at zero after each) with bitwise-equal outputs
    errs = []
    one_live = np.zeros(E, np.int64)
    one_live[17] = C_dec
    for C, w, sizes, rhs_of_group in (
        (C_dec, wg, head, None),  # decode gate/up call: 13 live groups
        (C_pre, wd, prefill_sizes, None),  # prefill down call, ragged sizes
        (C_dec, wg, np.r_[np.zeros(E // 2, np.int64), np.full(E // 2, C_dec)], None),  # all-dead groups
        (C_dec, wg, head, rog),  # groups sharing weights
        (C_dec, wg, one_live, None),  # one live group: split-K over every SM
        (C_dec, wg, np.random.default_rng(7).integers(1, C_dec + 1, E), None),  # every group live
    ):
        buf = rnd((E, C, w.shape[1]))
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        want = ref.gmm_ref(buf, w, gs, rhs_of_group)
        dead = torch.arange(C, device=dev)[None, :] >= gs[:, None]
        errs.append(_repeat_compare(f"gmm_capacity C={C}, {int((sizes > 0).sum())} live groups",
                                    lambda: ops.gmm_capacity(buf, w, gs, rhs_of_group), want,
                                    zero_rows=dead))
    gs = torch.as_tensor(head, dtype=torch.int32, device=dev)
    # dispatch zero-fills the rows past each group's size, so one bmm over
    # the slab computes the same function
    buf = rnd((E, C_dec, K)) * (torch.arange(C_dec, device=dev)[None, :, None] < gs[:, None, None])
    gs_pre = torch.as_tensor(prefill_sizes, dtype=torch.int32, device=dev)
    buf_pre = rnd((E, C_pre, Fd)) * (torch.arange(C_pre, device=dev)[None, :, None] < gs_pre[:, None, None])
    results["gmm_capacity"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.gmm_capacity(buf, wg, gs)),
        **timings(ms=lambda: ops.gmm_capacity(buf, wg, gs),
                  plain_ms=lambda: ref.gmm_ref(buf, wg, gs),
                  library_ms=lambda: torch.bmm(buf, wg),
                  prefill_down_ms=lambda: ops.gmm_capacity(buf_pre, wd, gs_pre),
                  prefill_down_library_ms=lambda: torch.bmm(buf_pre, wd)),
        bytes=n_live * K * Fd * 2 + live_rows * K * 2 + E * C_dec * Fd * 2 + E * 4,
        flops=2 * live_rows * K * Fd,
        shape=f"gate call: buf ({E},{C_dec},{K}) x ({E},{K},{Fd}), {n_live} live groups, "
              f"{live_rows} live rows",
        prefill_down_shape=f"buf ({E},{C_pre},{Fd}) x ({E},{Fd},{N}), {int((prefill_sizes > 0).sum())} "
                           f"live groups, {int(prefill_sizes.sum())} live rows",
    )

    # ---- kernel 7: expert GEMV, one call of the three-call tail ----
    errs = []
    for w, v in ((wg, valid_np), (wd, valid_np), (wg, np.zeros(S, np.int32)), (wu, np.ones(S, np.int32))):
        toks = rnd((S, w.shape[1]))
        valid = torch.as_tensor(v, device=dev)
        got = ops.expert_gemv(toks, w, eids, valid)
        want = ref.expert_gemv_ref(toks, w, eids, valid)
        errs.append(_compare("expert_gemv", got, want, zero_rows=valid == 0))
    valid = torch.as_tensor(valid_np, device=dev)
    got = ops.expert_gemv(slab[:, :1].reshape(E, K), wg, eids, valid)  # strided rows
    want = ref.expert_gemv_ref(slab[:, 0].contiguous(), wg, eids, valid)
    errs.append(_compare("expert_gemv strided", got, want, zero_rows=valid == 0))
    toks = rnd((S, K))

    def library_gemv():
        return torch.bmm(toks[:, None], wg[eids.long()])[:, 0] * valid[:, None]

    results["expert_gemv"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.expert_gemv(toks, wg, eids, valid)),
        **timings(ms=lambda: ops.expert_gemv(toks, wg, eids, valid),
                  plain_ms=lambda: ref.expert_gemv_ref(toks, wg, eids, valid),
                  library_ms=library_gemv),
        bytes=n_valid * (K * Fd * 2 + K * 2) + S * Fd * 2 + S * 8,
        flops=2 * n_valid * K * Fd,
        shape=f"gate call: tokens ({S},{K}) x ({E},{K},{Fd}), {n_valid} valid rows",
    )
    del wg, wu, wd
    for name, r in results.items():
        _log_row(f"{name}{suffix}", r)
    r = results["swiglu_gmm_capacity"]
    log(f"kernel swiglu_gmm_capacity{suffix} prefill [{r['prefill_shape']}]: {r['prefill_ms']:.4f} ms "
        f"({r['prefill_ms_spread']['min']:.4f}-{r['prefill_ms_spread']['max']:.4f}), "
        f"bound {r['prefill_bound_ms']:.4f} ms; kernels per call {r['kernels_per_call']}; decode with "
        f"the L2 flushed by a read {r['clean_l2_ms']['median']:.4f} ms "
        f"({r['clean_l2_ms']['min']:.4f}-{r['clean_l2_ms']['max']:.4f})")
    r = results["gmm_capacity"]
    log(f"kernel gmm_capacity{suffix} prefill down call [{r['prefill_down_shape']}]: "
        f"{r['prefill_down_ms']:.4f} ms, torch.bmm {r['prefill_down_library_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return {f"{name}{suffix}": dict(r, kernel=name) for name, r in results.items()}


def phase_kernels(arch, parent=None) -> dict:
    """Every kernel against its plain version, then timed.  ``parent``
    (``load_parent``): the parent commit's dense and split-KV attention,
    timed in turns beside the new ones at the same inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    a = arch.attn
    n_slots, max_seq = 8, 1024

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    moe_rows = phase_moe_kernels(arch, gen)
    results = {}

    # ---- kernel 3: decode attention ----
    # split over each live length: each case three launches on the same
    # buffers (tickets back at zero after each) with bitwise-equal outputs
    B, H, Kv, dh = n_slots, a.n_heads, a.n_kv_heads, a.d_head
    G = H // Kv
    stream = torch.cuda.current_stream().cuda_stream
    if parent is not None:
        parent_tickets = {k: torch.zeros((B * Kv,), dtype=torch.int32, device=dev)
                          for k in ("decode_attention", "decode_attention_split", "decode_attention_paged")}

        def parent_scratch(name, T):
            S = parent[f"{name}_splits"](T)
            return (torch.empty((B * Kv, S, G, dh), dtype=torch.float32, device=dev),
                    torch.empty((B * Kv, S, G), dtype=torch.float32, device=dev))

        def parent_attn(q, ck, cv, L, name="decode_attention"):
            T = ck.shape[1]
            part, lse = parent_scratch(name, T)
            out = torch.empty_like(q)
            rc = parent[name](q.data_ptr(), ck.data_ptr(), cv.data_ptr(), L.data_ptr(),
                              part.data_ptr(), lse.data_ptr(), parent_tickets[name].data_ptr(),
                              out.data_ptr(), B, T, Kv, G, dh, 1.0 / dh**0.5, stream)
            if rc != 0:
                fail(f"parent {name} failed to launch ({rc})")
            return out

        def parent_paged(q, pk, pv, tab, L):
            n_pool, pg = pk.shape[:2]
            nb = tab.shape[1]
            part, lse = parent_scratch("decode_attention_paged", nb * pg)
            out = torch.empty_like(q)
            rc = parent["decode_attention_paged"](
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(), tab.data_ptr(), L.data_ptr(), part.data_ptr(),
                lse.data_ptr(), parent_tickets["decode_attention_paged"].data_ptr(), out.data_ptr(), B,
                n_pool, pg, Kv, G, dh, nb, 1.0 / dh**0.5, stream)
            if rc != 0:
                fail(f"parent decode_attention_paged failed to launch ({rc})")
            return out

    rng = np.random.default_rng(3)
    errs = []
    for T, lens in (
        (max_seq, rng.integers(129, 545, B)),  # the serving shape
        (1000, np.r_[0, 1000, 999, 63, 64, 65, 1, 500]),  # ragged tail, length 0, length T
        (1000, np.r_[64, 1, 33, 32, 0, 17, 64, 2]),  # every length <= 64: one split each
        (max_seq, np.r_[max_seq, np.ones(B - 1, np.int64)]),  # one long sequence, seven idle slots
        (4100, np.r_[4100, 1025, 1500, 33, 0, 2049, 4099, 3000]),  # several chunks per split
    ):
        q = rnd((B, H, dh))
        ck, cv = rnd((B, T, Kv, dh)), rnd((B, T, Kv, dh))
        L = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        want = ref.decode_attention_ref(q, ck, cv, L)
        errs.append(_repeat_compare(f"decode_attention T={T} lengths {lens.tolist()}",
                                    lambda: ops.decode_attention(q, ck, cv, L), want,
                                    zero_rows=L == 0))
        # the dh-128 instance of the templated loop: the same bits as the parent's
        if parent is not None and not torch.equal(parent_attn(q, ck, cv, L),
                                                  ops.decode_attention(q, ck, cv, L)):
            fail(f"decode_attention T={T} lengths {lens.tolist()}: not bitwise equal to the parent's")
    lens = rng.integers(129, 545, B)
    q = rnd((B, H, dh))
    ck, cv = rnd((B, max_seq, Kv, dh)), rnd((B, max_seq, Kv, dh))
    L = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(max_seq, device=dev)[None, :] < L[:, None])[:, None, None, :]

    def library_attn():
        # the G query heads of a kv head are G query rows of one SDPA head
        return F.scaled_dot_product_attention(
            q.view(B, Kv, G, dh), ck.transpose(1, 2), cv.transpose(1, 2), attn_mask=mask,
        )

    results["decode_attention"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.decode_attention(q, ck, cv, L)),
        **timings(ms=lambda: ops.decode_attention(q, ck, cv, L),
                  plain_ms=lambda: ref.decode_attention_ref(q, ck, cv, L),
                  library_ms=library_attn),
        bytes=int(lens.sum()) * Kv * dh * 2 * 2 + 2 * B * H * dh * 2 + B * 4,
        flops=4 * int(lens.sum()) * H * dh,
        shape=f"q ({B},{H},{dh}), cache ({B},{max_seq},{Kv},{dh}), lengths {lens.tolist()}",
    )
    attn_bytes = results["decode_attention"]["bytes"]
    attn_flops = results["decode_attention"]["flops"]
    if parent is not None:
        if not torch.equal(parent_attn(q, ck, cv, L), ops.decode_attention(q, ck, cv, L)):
            fail("decode_attention at the serving shape: not bitwise equal to the parent's")
        results["decode_attention"]["parent"] = dict(
            serving=in_turns(lambda: parent_attn(q, ck, cv, L), lambda: ops.decode_attention(q, ck, cv, L)),
            bitwise_equal=True,
        )

    # ---- kernel 4: split-KV decode attention ----
    # the dense kernel's split over each live length: each case three
    # launches on the same buffers (tickets back at zero after each) with
    # bitwise-equal outputs; the plain version keeps the TPU's partition
    edge = np.r_[0, 1, 32, 64, 65, 4099, 1000, 2049]  # whole splits empty in most rows
    errs = []
    for T, lens_e, n_splits in (
        (max_seq, lens, SPLIT_KV_SPLITS),  # the serving shape
        (4100, edge, 2),
        (4100, edge, 3),
        (4100, edge, SPLIT_KV_SPLITS),
        (4100, edge, 8),
        (1000, np.r_[0, 1000, 999, 63, 64, 65, 1, 500], 8),
    ):
        qe = rnd((B, H, dh))
        cke, cve = rnd((B, T, Kv, dh)), rnd((B, T, Kv, dh))
        Le = torch.as_tensor(lens_e, dtype=torch.int32, device=dev)
        want = ref.decode_attention_split_ref(qe, cke, cve, Le, n_splits)
        errs.append(_repeat_compare(f"decode_attention_split T={T} S={n_splits} lengths {lens_e.tolist()}",
                                    lambda: ops.decode_attention(qe, cke, cve, Le, n_splits=n_splits),
                                    want, zero_rows=Le == 0))
        if parent is not None and not torch.equal(
                parent_attn(qe, cke, cve, Le, "decode_attention_split"),
                ops.decode_attention(qe, cke, cve, Le, n_splits=n_splits)):
            fail(f"decode_attention_split T={T} lengths {lens_e.tolist()}: not bitwise equal to the parent's")
    results["decode_attention_split"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.decode_attention(q, ck, cv, L, n_splits=SPLIT_KV_SPLITS)),
        **timings(ms=lambda: ops.decode_attention(q, ck, cv, L, n_splits=SPLIT_KV_SPLITS),
                  plain_ms=lambda: ref.decode_attention_split_ref(q, ck, cv, L, SPLIT_KV_SPLITS),
                  library_ms=library_attn),
        bytes=attn_bytes, flops=attn_flops,
        shape=f"as decode_attention, n_splits={SPLIT_KV_SPLITS}",
    )
    if parent is not None:
        results["decode_attention_split"]["parent"] = dict(
            serving=in_turns(lambda: parent_attn(q, ck, cv, L, "decode_attention_split"),
                             lambda: ops.decode_attention(q, ck, cv, L, n_splits=SPLIT_KV_SPLITS)),
            bitwise_equal=True,
        )
    # its path: the kernel entry point (no model caller), driven once per
    # layer of a decode step at the serving shape
    results["decode_attention_split"]["path_launches"] = _entry_point_launches(
        lambda: ops.decode_attention(q, ck, cv, L, n_splits=SPLIT_KV_SPLITS), arch.n_layers,
    )["decode_attention_split"]

    # ---- kernel 5: paged decode attention ----
    # split over each live length through the block table: each case three
    # launches on the same buffers (tickets back at zero after each) with
    # bitwise-equal outputs
    page = 16
    max_blocks = max_seq // page
    n_pool = n_slots * max_blocks + 1

    def paged_case(pg, lens_e, idle=(), bad=()):
        """Inputs of one paged case and the plain version's output: each
        live slot's blocks drawn from a shuffled pool, cells past its length
        on the trash block 0, ``idle`` slots' rows all trash, the free
        blocks poisoned so that a read of one shows; ``bad`` (slot, cell,
        value) cells point outside the pool, and the plain version reads a
        zero block in their place."""
        nb = max_seq // pg
        pool = n_slots * nb + 1
        pk, pv = rnd((pool, pg, Kv, dh)), rnd((pool, pg, Kv, dh))
        tab = np.zeros((n_slots, nb), np.int32)
        order = np.random.default_rng(6).permutation(np.arange(1, pool))
        nxt = 0
        for b, n in enumerate(lens_e):
            if b not in idle:
                k = min(nb, -(-int(n) // pg))
                tab[b, :k] = order[nxt:nxt + k]
                nxt += k
        free = torch.as_tensor(order[nxt:], device=dev).long()
        pk[free], pv[free] = 1e4, -1e4
        tab_ref = tab.copy()
        for b, c, v in bad:
            tab[b, c], tab_ref[b, c] = v, pool  # the plain version's zero block
        qe = rnd((B, H, dh))
        te = torch.as_tensor(tab, device=dev)
        Le = torch.as_tensor(lens_e, dtype=torch.int32, device=dev)
        if bad:
            zero = torch.zeros((1, pg, Kv, dh), dtype=bf, device=dev)
            want = ref.decode_attention_paged_ref(qe, torch.cat([pk, zero]), torch.cat([pv, zero]),
                                                  torch.as_tensor(tab_ref, device=dev), Le)
        else:
            want = ref.decode_attention_paged_ref(qe, pk, pv, te, Le)
        return (qe, pk, pv, te, Le), want

    errs = []
    for what, pg, lens_e, idle, bad in (
        ("serving", page, lens, (), ()),
        ("length 0, idle slot 2", page, np.r_[0, 1024, 1, 17, 300, 16, 33, 640], (2,), ()),
        ("length 0, idle slot 2", 8, np.r_[0, 1024, 1, 17, 300, 8, 9, 640], (2,), ()),
        ("length 0, idle slot 2", 32, np.r_[0, 1024, 1, 33, 300, 32, 65, 640], (2,), ()),
        ("length 0, idle slot 2", 64, np.r_[0, 1024, 1, 65, 300, 64, 129, 640], (2,), ()),
        ("one long slot, seven idle", page, np.r_[1024, np.ones(B - 1, np.int64)], tuple(range(1, B)), ()),
        ("a length past max_blocks x page", page, np.r_[1500, lens[1:]], (), ()),
        ("cells outside the pool", page, lens, (), ((0, 2, n_pool + 7), (1, 0, -3))),
    ):
        args, want = paged_case(pg, lens_e, idle, bad)
        errs.append(_repeat_compare(f"decode_attention_paged page={pg} ({what})",
                                    lambda: ops.decode_attention_paged(*args), want,
                                    zero_rows=args[4] == 0))
        if parent is not None and not torch.equal(parent_paged(*args), ops.decode_attention_paged(*args)):
            fail(f"decode_attention_paged page={pg} ({what}): not bitwise equal to the parent's")
    pk, pv = rnd((n_pool, page, Kv, dh)), rnd((n_pool, page, Kv, dh))
    perm = torch.randperm(n_pool - 1, generator=gen, device=dev).add(1)
    blocks = [-(-int(n) // page) for n in lens]
    tab = torch.zeros((n_slots, max_blocks), dtype=torch.int32, device=dev)
    nxt = 0
    for b, k in enumerate(blocks):
        tab[b, :k] = perm[nxt:nxt + k].to(torch.int32)
        nxt += k

    def library_paged():
        gk = pk[tab.long()].reshape(B, max_seq, Kv, dh)
        gv = pv[tab.long()].reshape(B, max_seq, Kv, dh)
        return F.scaled_dot_product_attention(
            q.view(B, Kv, G, dh), gk.transpose(1, 2), gv.transpose(1, 2), attn_mask=mask,
        )

    results["decode_attention_paged"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.decode_attention_paged(q, pk, pv, tab, L)),
        **timings(ms=lambda: ops.decode_attention_paged(q, pk, pv, tab, L),
                  plain_ms=lambda: ref.decode_attention_paged_ref(q, pk, pv, tab, L),
                  library_ms=library_paged),
        bytes=attn_bytes + sum(blocks) * 4, flops=attn_flops,
        shape=f"q ({B},{H},{dh}), pool ({n_pool},{page},{Kv},{dh}), tables ({B},{max_blocks}), "
              f"lengths {lens.tolist()}",
    )
    if parent is not None:
        results["decode_attention_paged"]["parent"] = dict(
            serving=in_turns(lambda: parent_paged(q, pk, pv, tab, L),
                             lambda: ops.decode_attention_paged(q, pk, pv, tab, L)),
            bitwise_equal=True,
        )
    small = rnd((B, H * dh))
    log(f"host time of one small PyTorch op (SiLU of a ({B},{H * dh}) tensor): "
        f"{host_us(lambda: F.silu(small)):.1f} us/call")
    for name, r in results.items():
        _log_row(name, r)
    for name, r in results.items():
        for shape, t in r.get("parent", {}).items():
            if isinstance(t, dict) and "parent" in t:
                log(f"in turns, {name} {shape}: parent {t['parent']['median']:.4f} ms "
                    f"({t['parent']['min']:.4f}-{t['parent']['max']:.4f}), new {t['new']['median']:.4f} ms "
                    f"({t['new']['min']:.4f}-{t['new']['max']:.4f}), new/parent {t['new_over_parent']:.3f}")
    torch.cuda.empty_cache()
    return {**moe_rows, **results}


def _log_row(name: str, r: dict) -> None:
    """Set a kernel row's bound from its bytes and flops, and print it."""
    r["bound_ms"] = max(r["bytes"] / PEAK_HBM_BYTES, r["flops"] / PEAK_BF16_FLOPS) * 1e3
    r["bound_by"] = "bytes" if r["bytes"] / PEAK_HBM_BYTES >= r["flops"] / PEAK_BF16_FLOPS else "operations"
    sp = r["ms_spread"]
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    log(f"kernel {name}: max|err| {r['max_abs_err']:.3g}  kernel {r['ms']:.4f} ms "
        f"(median of {sp['n']}, {sp['min']:.4f}-{sp['max']:.4f})  "
        f"plain {r['plain_ms']:.4f} ms  library {lib}  "
        f"host {r['host_us']:.1f} us/call  "
        f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})  [{r['shape']}]")


def _entry_point_launches(call, n: int) -> int:
    """A kernel with no model caller: its path is its entry point, driven
    ``n`` times with the counts zeroed just before; its launches."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return dict(ops.LAUNCHES)


def _attention_instance(tag: str, B: int, H: int, Kv: int, dh: int, kinds, seed: int,
                        timed: bool = True) -> dict:
    """Rows of the attention kernels at one head dim and group size: each
    of ``kinds`` ("dense", "split", "paged") held against its plain version
    at the serving lengths and at edge lengths (three launches on the same
    buffers, bitwise equal, exact zeros on length-0 rows), then timed
    beside the plain version and SDPA (over the gathered pool for paged).
    ``timed=False``: held only, each kernel's row its largest error."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    G, T, page = H // Kv, 1024, 16
    max_blocks, n_pool = T // page, B * (T // page) + 1

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rng = np.random.default_rng(seed)
    serving = rng.integers(129, 545, B)
    edges = np.r_[0, 1, 63, 64, 65, T, T - 1, 500][:B]
    q = rnd((B, H, dh))
    ck, cv = rnd((B, T, Kv, dh)), rnd((B, T, Kv, dh))
    pk, pv = rnd((n_pool, page, Kv, dh)), rnd((n_pool, page, Kv, dh))

    def table(lens):
        tab = torch.zeros((B, max_blocks), dtype=torch.int32, device=dev)
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev).add(1).to(torch.int32)
        nxt = 0
        for b, n in enumerate(lens):
            k = -(-int(n) // page)
            tab[b, :k] = perm[nxt:nxt + k]
            nxt += k
        return tab

    calls = {
        "dense": (lambda L, tab: ops.decode_attention(q, ck, cv, L),
                  lambda L, tab: ref.decode_attention_ref(q, ck, cv, L)),
        "split": (lambda L, tab: ops.decode_attention(q, ck, cv, L, n_splits=SPLIT_KV_SPLITS),
                  lambda L, tab: ref.decode_attention_split_ref(q, ck, cv, L, SPLIT_KV_SPLITS)),
        "paged": (lambda L, tab: ops.decode_attention_paged(q, pk, pv, tab, L),
                  lambda L, tab: ref.decode_attention_paged_ref(q, pk, pv, tab, L)),
    }
    name_of = {"dense": "decode_attention", "split": "decode_attention_split", "paged": "decode_attention_paged"}
    L = torch.as_tensor(serving, dtype=torch.int32, device=dev)
    tab = table(serving)
    mask = (torch.arange(T, device=dev)[None, :] < L[:, None])[:, None, None, :]

    def sdpa(k, v):  # the G query heads of a kv head are G query rows of one SDPA head
        return F.scaled_dot_product_attention(q.view(B, Kv, G, dh), k.transpose(1, 2), v.transpose(1, 2),
                                              attn_mask=mask)

    library = {
        "dense": lambda: sdpa(ck, cv),
        "split": lambda: sdpa(ck, cv),
        "paged": lambda: sdpa(pk[tab.long()].reshape(B, T, Kv, dh), pv[tab.long()].reshape(B, T, Kv, dh)),
    }
    lens_sum = int(serving.sum())
    attn_bytes = lens_sum * Kv * dh * 2 * 2 + 2 * B * H * dh * 2 + B * 4
    out = {}
    for kind in kinds:
        call, plain = calls[kind]
        errs = []
        for what, lens in (("serving", serving), ("edges", edges)):
            Le = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            te = table(lens)
            errs.append(_repeat_compare(f"{name_of[kind]} {tag} ({what} lengths {lens.tolist()})",
                                        lambda: call(Le, te), plain(Le, te), zero_rows=Le == 0))
        if not timed:
            out[f"{name_of[kind]}_{tag}"] = max(errs)
            continue
        blocks = int(sum(-(-int(n) // page) for n in serving)) if kind == "paged" else 0
        out[f"{name_of[kind]}_{tag}"] = dict(
            kernel=name_of[kind],
            max_abs_err=max(errs),
            host_us=host_us(lambda: call(L, tab)),
            **timings(ms=lambda: call(L, tab), plain_ms=lambda: plain(L, tab), library_ms=library[kind]),
            bytes=attn_bytes + blocks * 4, flops=4 * lens_sum * H * dh,
            shape=f"q ({B},{H},{dh}), " + (f"pool ({n_pool},{page},{Kv},{dh})" if kind == "paged"
                                          else f"cache ({B},{T},{Kv},{dh})")
                  + (f", n_splits={SPLIT_KV_SPLITS}" if kind == "split" else "")
                  + f", lengths {serving.tolist()}",
            entry=lambda c=call: c(L, tab),
        )
    return out


def _ragged_row(arch) -> dict:
    """gmm_ragged at the decode gate call's routing (the head split of
    ``_decode_routing``: groups of two or more rows, bm 8), held against
    its plain version (three launches bitwise, exact zeros on padding rows;
    plus a prefill-like case with bm 128 and rows past the spans) and
    timed beside the plain version and ``torch._grouped_mm`` where it runs."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    E, K, N = arch.moe.n_experts, arch.d_model, arch.moe.d_expert
    counts = _decode_routing(E, arch.moe.top_k, 8, seed=1)
    head = np.where(counts >= 2, counts, 0)

    def case(sizes, bm, extra_tiles=0):
        spans = -(-sizes // bm) * bm
        M = int(spans.sum()) + extra_tiles * bm
        live = torch.zeros((M,), dtype=torch.bool, device=dev)
        for s0, n in zip(np.cumsum(spans) - spans, sizes):
            live[int(s0):int(s0) + int(n)] = True
        # dispatch zero-fills the padding rows: one grouped library product
        # over the spans then computes the same function
        lhs = (torch.randn((M, K), generator=gen, device=dev) * live[:, None]).to(torch.bfloat16)
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        return lhs, gs, ~live, spans

    rhs = (torch.randn((E, K, N), generator=gen, device=dev) * K**-0.5).to(torch.bfloat16)
    errs = []
    for what, sizes, bm, extra in (("decode gate call", head, 8, 0),
                                   ("prefill-like", np.random.default_rng(5).integers(0, 41, E) * 3, 128, 2)):
        lhs, gs, dead, _ = case(sizes, bm, extra)
        errs.append(_repeat_compare(f"gmm_ragged {what}, bm {bm}", lambda: ops.gmm_ragged(lhs, rhs, gs, bm),
                                    ref.gmm_ragged_ref(lhs, rhs, gs, bm), zero_rows=dead))
    lhs, gs, _, spans = case(head, 8)
    offs = torch.as_tensor(np.cumsum(spans), dtype=torch.int32, device=dev)
    library, note = None, "torch._grouped_mm over the spans"
    grouped_mm = getattr(torch, "_grouped_mm", None)
    try:
        if grouped_mm is None:
            raise RuntimeError("torch has no _grouped_mm")
        _compare("torch._grouped_mm", grouped_mm(lhs, rhs, offs=offs), ref.gmm_ragged_ref(lhs, rhs, gs, 8))
        library = lambda: grouped_mm(lhs, rhs, offs=offs)  # noqa: E731
    except Exception as e:  # the library call is a yardstick only: null where it does not run
        note = f"no library time: torch._grouped_mm did not run here ({type(e).__name__}: {str(e)[:160]})"
        log(f"gmm_ragged: {note}")
    live_rows, n_live = int(head.sum()), int((head > 0).sum())
    M = lhs.shape[0]
    row = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.gmm_ragged(lhs, rhs, gs, 8)),
        **timings(ms=lambda: ops.gmm_ragged(lhs, rhs, gs, 8), plain_ms=lambda: ref.gmm_ragged_ref(lhs, rhs, gs, 8)),
        library_note=note,
        bytes=n_live * K * N * 2 + live_rows * K * 2 + M * N * 2 + E * 4,
        flops=2 * live_rows * K * N,
        shape=f"lhs ({M},{K}) x ({E},{K},{N}), bm 8, {n_live} live groups, {live_rows} live rows",
        entry=lambda: ops.gmm_ragged(lhs, rhs, gs, 8),
    )
    if library is not None:
        row.update({k.replace("ms", "library_ms", 1): v for k, v in timings(ms=library).items()})
    else:
        row["library_ms"] = None
    return {"gmm_ragged": row}


def phase_kernel_instances(arch) -> dict:
    """Phase 3's rows beyond the qwen3-moe path's kernels: the attention
    kernels (dense, split-KV, paged) at granite-3-2b's decode shape (dh
    64, 4 query heads per kv head), at zamba2-7b's shared-attention shape
    (the dh-112 instance, 32 heads on 32 kv heads) and with a 32-head
    group at dh 128 (two head groups of the grid), the last two on their
    entry points, and gmm_ragged.  The entry-point-only rows are then driven as one decode
    step would drive them, counts zeroed just before."""
    import torch

    rows = {}
    rows.update(_attention_instance("dh64", 8, 32, 8, 64, ("dense", "split", "paged"), seed=64))
    rows.update(_attention_instance("dh112", 8, 32, 32, 112, ("dense", "split", "paged"), seed=112))
    rows.update(_attention_instance("g32", 8, 32, 1, 128, ("dense", "split", "paged"), seed=32))
    rows.update(_ragged_row(arch))
    # (row, launches of one decode step): the split-KV kernel per layer of
    # granite-3-2b (40), zamba2-7b's 13 shared-attention applications, the
    # 32-head group per layer of granite-3-8b (40, its width: 32 heads of
    # 128), gmm_ragged per layer of qwen3-moe (48)
    for name, n, counter in (("decode_attention_split_dh64", 40, "decode_attention_split"),
                             ("decode_attention_dh112", 13, "decode_attention"),
                             ("decode_attention_split_dh112", 13, "decode_attention_split"),
                             ("decode_attention_paged_dh112", 13, "decode_attention_paged"),
                             ("decode_attention_split_g32", 40, "decode_attention_split"),
                             ("decode_attention_paged_g32", 40, "decode_attention_paged"),
                             ("decode_attention_g32", 40, "decode_attention"),
                             ("gmm_ragged", arch.n_layers, "gmm_ragged")):
        launches = _entry_point_launches(rows[name]["entry"], n)
        if launches[counter] != n or sum(launches.values()) != n:
            fail(f"{name}: its entry point launched {launches}, not {n} x {counter}")
        rows[name]["path_launches"] = n
    for name, r in rows.items():
        del r["entry"]
        _log_row(name, r)
    torch.cuda.empty_cache()
    return rows


def phase_family_shapes() -> dict:
    """The attention kernels at the decode shape of each family of
    ``FAMILIES`` (8 slots, 1024 positions, its heads, kv heads and head
    dim), on each KV layout it is served on, held against their plain
    versions as the timed rows are (three launches, bitwise, bf16
    tolerance); no timing."""
    import torch

    from repro_torch.configs import get_arch

    held = {}
    for i, (name, _, layouts) in enumerate(FAMILIES):
        a = get_arch(name).attn
        held.update(_attention_instance(name, 8, a.n_heads, a.n_kv_heads, a.d_head, layouts,
                                        seed=1000 + i, timed=False))
        log(f"held {name}'s decode attention (q (8,{a.n_heads},{a.d_head}), kv heads {a.n_kv_heads}, "
            f"{'/'.join(layouts)}): max |err| "
            + ", ".join(f"{k} {v:.3g}" for k, v in held.items() if k.endswith(f"_{name}")))
    torch.cuda.empty_cache()
    return held


# ---------------------------------------------------------------------------
# phase 4: serve the full-width model
# ---------------------------------------------------------------------------


class RowCounter:
    """Live head rows, valid tail rows and live head groups of the MoE path,
    summed on the card (no sync) into ``rows[slot]`` for the ``slot`` set at
    the call.  It wraps ``moe.head_stage``/``moe.tail_stage`` until
    :meth:`remove`.  The adds made while a decode step is captured are
    captured with it (into the slot set then) and run on every replay."""

    def __init__(self, n_slots: int):
        import torch

        from repro_torch.models import moe

        self.moe, self.orig = moe, (moe.head_stage, moe.tail_stage)
        # [slot, head rows / tail rows / head groups]
        self.rows = torch.zeros((n_slots, 3), dtype=torch.int64, device="cuda")
        self.slot = 0
        head, tail = self.orig
        rows = self.rows

        def head_stage(slab, wg, wu, wd, sizes):
            rows[self.slot, 0] += sizes.sum()
            rows[self.slot, 2] += (sizes > 0).sum()
            return head(slab, wg, wu, wd, sizes)

        def tail_stage(toks, wg, wu, wd, eids, valid):
            rows[self.slot, 1] += valid.sum()
            return tail(toks, wg, wu, wd, eids, valid)

        moe.head_stage, moe.tail_stage = head_stage, tail_stage

    def remove(self) -> None:
        self.moe.head_stage, self.moe.tail_stage = self.orig


class PathProbe:
    """What the serving run's MoE path did, split by phase (0 prefill, 1
    decode): live head rows and valid tail rows (``RowCounter``), tokens
    routed and dropped, and the host time of the sieve pass.

    It wraps the engine's ``lm.prefill``/``_decode``/``_run_sieve``; the
    kernels' launch counters are untouched.  The engine captures its decode
    step as a CUDA graph on the first decode step, in phase 1: the row
    counters' adds are captured with it (into phase 1's row) and run on
    every replay, and the routed and dropped tokens are read from what
    ``_decode`` returns, eager or replayed."""

    def __init__(self, eng):
        self.eng = eng
        self.counter = None
        self.routed, self.dropped = [0, 0], [0, 0]
        self.sieve_s = 0.0
        self.last_counts = None  # the per-layer counts of the last host pass
        self.decode_calls, self.replays = 0, 0
        self._orig = (eng.lm.prefill, eng._decode, eng._run_sieve)

    def install(self) -> None:
        prefill, decode, run_sieve = self._orig
        self.counter = RowCounter(2)

        def counted(phase, fn, aux_at):
            def run(*args):
                self.counter.slot = phase
                self.decode_calls += phase
                self.replays += phase and self.eng._graph is not None
                out = fn(*args)
                aux = out[aux_at]
                self.routed[phase] += int(aux.counts.sum())
                self.dropped[phase] += int(aux.dropped)
                return out
            return run

        def timed_sieve(counts):
            t = time.perf_counter()
            run_sieve(counts)
            self.sieve_s += time.perf_counter() - t
            self.last_counts = counts

        self.eng.lm.prefill, self.eng._decode = counted(0, prefill, 2), counted(1, decode, 1)
        self.eng._run_sieve = timed_sieve

    def remove(self) -> None:
        self.counter.remove()
        del self.eng.lm.prefill, self.eng._decode, self.eng._run_sieve

    def summary(self) -> dict:
        rows = self.counter.rows.tolist()
        out = {}
        for phase, name in enumerate(("prefill", "decode")):
            out[name] = dict(
                head_rows=rows[phase][0], tail_rows=rows[phase][1],
                routed_tokens=self.routed[phase], dropped_tokens=self.dropped[phase],
                drop_share=self.dropped[phase] / max(1, self.routed[phase]),
            )
        return out


def build_model(arch):
    """The full-width model with seeded random weights, shared by all its
    serving runs (qwen3-moe's 61 GB of the card's 80 GB cannot be held
    twice)."""
    import torch

    from repro_torch.models import LM

    t0 = time.perf_counter()
    lm = LM(arch, dtype=torch.bfloat16, device="cuda")
    params = lm.init(seed=0)
    torch.cuda.synchronize()
    log(f"model: {arch.name} {arch.n_layers} layers, weights "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB, init {time.perf_counter() - t0:.1f} s")
    return lm, params


@contextlib.contextmanager
def fused_swiglu(value: str):
    """``REPRO_FUSED_SWIGLU`` set for a block (``"1"`` fused head and tail
    kernels, ``"0"`` the three-call path), then restored."""
    saved = os.environ.get("REPRO_FUSED_SWIGLU")
    os.environ["REPRO_FUSED_SWIGLU"] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ["REPRO_FUSED_SWIGLU"]
        else:
            os.environ["REPRO_FUSED_SWIGLU"] = saved


def phase_serve(lm, params, batching, path_kernels, run=None, policy="sieve", check_step=None,
                keep_counts=False) -> dict:
    """Serve 12 requests through ``ServingEngine`` and check the run: every
    request and token, the kernels of ``path_kernels`` launched (and no
    other), head + tail + drops equal to the routed assignments in each
    phase, and a paged pool back to all blocks free; then profile decode
    steps.  ``run`` names the run in the log (default: its KV layout),
    ``policy`` the host scheduler's.  ``check_step(eng, counts, rows)``
    runs after every replayed decode step with the host pass's per-layer
    counts and the step's head rows, tail rows and head groups from the
    captured row counters.  ``keep_counts``: the per-layer counts of the
    full-batch decode-only steps, the engine's cost model and its cost
    table go under ``_counts``, ``_cost_model`` and ``_cost_table``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import Request, ServingEngine

    arch = lm.arch
    eng = ServingEngine(lm, params, batching, policy=policy)
    run = run or ("paged" if batching.paged else "dense")
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(12):
        r = Request(
            prompt=[int(t) for t in rng.integers(0, arch.vocab_size, int(rng.integers(128, 513)))],
            max_new_tokens=int(rng.integers(16, 33)),
        )
        reqs.append(r)

    probe = PathProbe(eng)
    probe.install()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # counts from here on are the main path's
    t_start = time.perf_counter()
    for r in reqs:
        r.arrival_time = t_start
        eng.submit(r)
    decode_steps = []  # steps that ran no prefill: (decode tokens, ms, host sieve ms)
    full_counts, checked = [], 0
    while not eng.sched.idle:
        p0, d0, s0, r0 = eng.stats.prefill_tokens, eng.stats.decode_tokens, probe.sieve_s, probe.replays
        before = probe.counter.rows[1].tolist() if check_step else None
        probe.last_counts = None
        ts = time.perf_counter()
        eng.step()
        dt = time.perf_counter() - ts
        if eng.stats.prefill_tokens == p0:
            decode_steps.append((eng.stats.decode_tokens - d0, 1e3 * dt, 1e3 * (probe.sieve_s - s0)))
            if keep_counts and decode_steps[-1][0] == eng.cfg.n_slots:
                full_counts.append(probe.last_counts)
        if check_step and probe.replays > r0:
            check_step(eng, probe.last_counts, [a - b for a, b in zip(probe.counter.rows[1].tolist(), before)])
            checked += 1
        if eng.stats.steps > 2000:
            fail("serving did not finish in 2000 steps")
    wall = time.perf_counter() - t_start
    launches = dict(ops.LAUNCHES)
    probe.remove()
    path = probe.summary()

    for r in reqs:
        if len(r.generated) != r.max_new_tokens:
            fail(f"request {r.req_id} finished with {len(r.generated)} of {r.max_new_tokens} tokens")
        if not all(0 <= t < arch.vocab_size for t in r.generated):
            fail(f"request {r.req_id} produced a token outside the vocabulary")
    for name, n in launches.items():
        if name in path_kernels and n <= 0:
            fail(f"{run} run: kernel {name} of its path was not launched")
        if name not in path_kernels and n != 0:
            fail(f"{run} run: kernel {name} is not on its path but was launched {n} times")
    if probe.decode_calls < 2 or probe.replays != probe.decode_calls - 1 or eng.n_captures != 1:
        fail(f"{run} run: {eng.n_captures} captures, {probe.replays} of {probe.decode_calls} decode steps "
             "replayed the captured graph; one capture and every step after the first replayed are required")
    if eng.paged is not None and eng.paged.n_free != eng.paged.n_pool - 1:
        fail(f"paged run: {eng.paged.n_free} of {eng.paged.n_pool - 1} pool blocks free after the run")
    for name, ph in path.items():
        # every routed assignment is computed by the head or the tail, or dropped
        if ph["head_rows"] + ph["tail_rows"] + ph["dropped_tokens"] != ph["routed_tokens"]:
            fail(f"{name}: head + tail rows + drops do not add up to the routed tokens: {ph}")
    if sum(path[p]["head_rows"] for p in path) == 0:
        fail("the head kernel never had a live row on the main path")
    if sum(path[p]["tail_rows"] for p in path) == 0:
        fail("the tail kernel never had a valid row on the main path")
    ttft = sorted(r.first_token_time - r.arrival_time for r in reqs)
    tpot = sorted((r.finish_time - r.first_token_time) / (len(r.generated) - 1) for r in reqs)
    dec_tok = sum(n for n, _, _ in decode_steps)
    dec_ms = sum(ms for _, ms, _ in decode_steps)
    full = [(ms, sv) for n, ms, sv in decode_steps if n == eng.cfg.n_slots]
    out = dict(
        run=run,
        n_layers=arch.n_layers,
        page_size=batching.page_size if batching.paged else None,
        pool_blocks=eng.paged.n_pool if batching.paged else None,
        requests=len(reqs),
        prompt_tokens=eng.stats.prefill_tokens,
        decode_tokens=eng.stats.decode_tokens,
        steps=eng.stats.steps,
        wall_s=wall,
        decode_tok_per_s=1e3 * dec_tok / dec_ms if dec_ms else 0.0,
        decode_step_ms=dec_ms / max(1, len(decode_steps)),
        decode_steps=decode_steps,
        full_batch_decode_steps=len(full),
        full_batch_step_ms=sum(ms for ms, _ in full) / max(1, len(full)),
        full_batch_sieve_ms=sum(sv for _, sv in full) / max(1, len(full)),
        ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
        tpot_p50_s=tpot[len(tpot) // 2], tpot_max_s=tpot[-1],
        dropped_tokens=eng.stats.dropped_tokens, routed_tokens=eng.stats.routed_tokens,
        path=path,
        sieve_refreshes=len(eng.sieve_refreshes),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches,
        decode_calls=probe.decode_calls, replays=probe.replays, captures=eng.n_captures,
        graph_launches=dict(eng._graph_launches), policy=policy,
    )
    if check_step:
        out["checked_steps"] = checked
    if keep_counts:
        out.update(_counts=full_counts, _cost_model=eng.cost_model, _cost_table=eng.cost_table)
    log(f"serve {run}: {len(reqs)} requests, {out['prompt_tokens']} prompt + {out['decode_tokens']} "
        f"decode tokens in {wall:.2f} s ({out['steps']} steps); decode {out['decode_tok_per_s']:.1f} tok/s "
        f"over {len(decode_steps)} decode-only steps of {out['decode_step_ms']:.1f} ms "
        f"({len(full)} at a full batch: {out['full_batch_step_ms']:.1f} ms, host sieve "
        f"{out['full_batch_sieve_ms']:.1f} ms); TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms "
        f"max {out['ttft_max_s'] * 1e3:.1f} ms; TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} ms; "
        f"{probe.replays} of {probe.decode_calls} decode steps replayed; launches {launches}")
    for name, ph in path.items():
        log(f"serve {run} path {name}: head rows {ph['head_rows']}, valid tail rows {ph['tail_rows']}, "
            f"dropped {ph['dropped_tokens']} of {ph['routed_tokens']} routed ({ph['drop_share']:.3f})")

    out["profile"] = phase_profile(eng, arch, rng)

    del eng, probe
    torch.cuda.empty_cache()
    return out


def phase_ab(lm, params, n_steps: int = 4, paths=None) -> dict:
    """Full-batch decode-step time of two serving paths, each eager and
    replayed, in turns (first path eager, replayed, second path eager,
    replayed, then the reverse, twice) on the same weights and prompts, so
    that host drift over the call falls on all four: each turn prefills 8
    requests of 256 tokens, then times ``n_steps`` decode steps on the host
    clock (each step ends in the logits' copy to the host).  The eager
    engines run with the engine's private ``_replay`` off.  Eager and
    replayed engines of a path must give the same tokens.  ``paths``: name
    -> (BatchingConfig, ``REPRO_FUSED_SWIGLU``), by default the dense cache
    fused ("dense") and the paged pool on the three-call path ("paged")."""
    import numpy as np
    import torch

    from repro_torch.serving import BatchingConfig, Request, ServingEngine

    paths = paths or {
        "dense": (BatchingConfig(n_slots=8, max_seq=1024), "1"),
        "paged": (BatchingConfig(n_slots=8, max_seq=1024, paged=True, page_size=16), "0"),
    }
    first, second = paths
    order = [(name, mode) for name in paths for mode in ("eager", "replay")]
    engines = {}
    for name, mode in order:
        engines[(name, mode)] = eng = ServingEngine(lm, params, paths[name][0])
        eng._replay = mode == "replay"
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, lm.arch.vocab_size, 256)] for _ in range(8)]
    steps = {key: [] for key in order}
    tokens = {key: [] for key in order}
    for key in (order + order[::-1]) * 2:
        eng = engines[key]
        with fused_swiglu(paths[key[0]][1]):
            reqs = [Request(prompt=list(prompt), max_new_tokens=n_steps + 2) for prompt in prompts]
            for r in reqs:
                eng.submit(r)
            eng.step()  # prefills every slot and decodes once
            torch.cuda.synchronize()
            for _ in range(n_steps):
                t0 = time.perf_counter()
                eng.step()
                steps[key].append(1e3 * (time.perf_counter() - t0))
            while not eng.sched.idle:
                eng.step()
        tokens[key].append([r.generated for r in reqs])
    for name in paths:
        if tokens[(name, "eager")] != tokens[(name, "replay")]:
            fail(f"{name}: the replayed decode step gives other tokens than the eager step")
    out = {f"{name}_{mode}": dict(step_ms=sorted(v), median_ms=float(np.median(v)))
           for (name, mode), v in steps.items()}
    for name in paths:
        out[f"{name}_replay_over_eager"] = out[f"{name}_replay"]["median_ms"] / out[f"{name}_eager"]["median_ms"]
    for mode in ("replay", "eager"):
        out[f"{second}_over_{first}_{mode}"] = (out[f"{second}_{mode}"]["median_ms"]
                                                / out[f"{first}_{mode}"]["median_ms"])
    out["same_tokens"] = True
    for name in paths:
        e, r = out[f"{name}_eager"], out[f"{name}_replay"]
        log(f"in turns, {name}: full-batch decode step median eager {e['median_ms']:.1f} ms "
            f"({min(e['step_ms']):.1f}-{max(e['step_ms']):.1f}), replayed {r['median_ms']:.1f} ms "
            f"({min(r['step_ms']):.1f}-{max(r['step_ms']):.1f}), replayed/eager "
            f"x{out[f'{name}_replay_over_eager']:.3f} over {len(e['step_ms'])} steps each; same tokens")
    log(f"in turns: {second}/{first} x{out[f'{second}_over_{first}_replay']:.3f} replayed, "
        f"x{out[f'{second}_over_{first}_eager']:.3f} eager")
    del engines
    torch.cuda.empty_cache()
    return out


class RoutingTape:
    """Shares the router's discrete choices between the card and the CPU.

    bf16 rounds at other places on the two devices, so a near-tie in a
    token's top-k (or the capacity drop that follows it) can flip a choice
    and move that token's output far more than any kernel error would.
    The tape records the card's top-k choices, then makes the CPU run take
    them (weights from the CPU's own router probabilities), and counts
    apart the assignments the CPU's own routing would have moved."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe.route
        self.card, self.own = [], []  # (expert_idx, counts) per call, in call order

    def record(self) -> None:
        def route(x, w, cfg):
            r = self.route(x, w, cfg)
            self.card.append((r.expert_idx.cpu(), r.counts.cpu()))
            return r

        self.moe.route = route

    def replay(self) -> None:
        import torch

        calls = iter(self.card)

        def route(x, w, cfg):
            r = self.route(x, w, cfg)
            self.own.append(r.counts)
            idx, counts = next(calls)
            top_p = torch.softmax(x.float() @ w.float(), dim=-1).gather(1, idx.long())
            weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
            return r._replace(expert_idx=idx, weights=weights.to(x.dtype), counts=counts)

        self.moe.route = route

    def remove(self) -> None:
        self.moe.route = self.route

    def moved_share(self) -> float:
        """Share of the card's routed assignments that the CPU's own routing
        sends to another expert."""
        moved = sum(int((c - o).abs().sum()) for (_, c), o in zip(self.card, self.own)) / 2
        return moved / max(1, sum(int(c.sum()) for _, c in self.card))


def _two_layers(arch, params):
    """The first two layers of a model (with a dense prefix block: that
    block and the first of the others), as a config and its weights."""
    small = dataclasses.replace(arch, n_layers=2)
    n_prefix = arch.moe.first_k_dense if arch.moe is not None else 0
    gp = {k: v for k, v in params.items() if k not in ("blocks", "prefix_blocks")}
    if n_prefix:
        gp["prefix_blocks"] = params["prefix_blocks"][:2]
    gp["blocks"] = params["blocks"][:2 - min(n_prefix, 2)]
    return small, gp


def phase_reference(lm, params, paged: bool, run=None) -> dict:
    """A 2-layer slice of the served weights on the card against the plain
    path on the CPU: prefill logits, and the logits of one decode step
    through a dense cache or, paged, through a block pool whose table maps
    the slot's blocks out of order.  Both sides take the card's routing
    choices (``RoutingTape``); the CPU's own routing must agree on all but
    2% of the assignments."""
    import numpy as np
    import torch

    from repro_torch.models import LM

    arch = lm.arch
    run = run or ("paged" if paged else "dense")
    small, gp = _two_layers(arch, params)
    cp = _to_cpu(gp)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, arch.vocab_size, (1, 32)))
    tok = torch.as_tensor(rng.integers(0, arch.vocab_size, (1, 1)))
    tape = RoutingTape()
    tape.record()
    got = _prefill_decode(LM(small, torch.bfloat16, "cuda"), gp, prompt, tok, paged)
    tape.replay()
    want = _prefill_decode(LM(small, torch.bfloat16, "cpu"), cp, prompt, tok, paged)
    tape.remove()
    out = {"ref_routing_moved_share": tape.moved_share()}
    log(f"reference {run}: the CPU's own routing moves {out['ref_routing_moved_share']:.4f} "
        "of the card's routed assignments")
    # bf16 near-ties flip a few choices (up to 4 of 512 assignments between
    # two plain-path variants on one CPU); a faulty router moves far more
    if out["ref_routing_moved_share"] > 0.02:
        fail(f"{run}: the card's routing disagrees with the CPU plain path's")
    for stage, g, w in zip(("prefill", "decode"), got, want):
        g, w = g.float().cpu()[..., : arch.vocab_size], w.float()[..., : arch.vocab_size]
        if not torch.isfinite(g).all():
            fail(f"{run} {stage} logits are not finite")
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0))
        out[f"ref_{stage}_max_abs_err"] = err
        out[f"ref_{stage}_cosine"] = cos
        log(f"reference {run}: 2-layer {stage} logits, card vs CPU plain path: max |err| {err:.4g} "
            f"(max |logit| {scale:.3g}), cosine {cos:.6f}")
        # bf16 through two full-width layers on two devices: the products
        # round at other places, so hold the logits to 5% of their range
        if err > 5e-2 * scale or cos < 0.999:
            fail(f"{run} {stage} logits of the card disagree with the CPU plain path")
    return out


def phase_profile(eng, arch, rng, n_steps: int = 4) -> dict:
    """Where a full-batch decode step's time goes, replayed (the engine's
    path on the card) and eager (its private ``_replay`` off): 8 fresh
    requests are prefilled, then for each mode ``n_steps`` decode steps run
    on the host clock (the host sieve pass timed on its own), then
    ``n_steps`` more under ``torch.profiler``.  The idle share comes from
    the profiled steps alone: 1 - device busy time / their wall time; a
    busy time above the wall time is a counting fault and fails the run.
    For the replayed step, CUDA events also time the captured graph alone
    on the card (``graph_span_ms``, the gaps between its kernels included):
    a replay of the same inputs rewrites the same KV rows and outputs."""
    import torch

    from repro_torch.serving import Request

    for _ in range(eng.cfg.n_slots):
        eng.submit(Request(
            prompt=[int(t) for t in rng.integers(0, arch.vocab_size, 256)],
            max_new_tokens=4 * n_steps + 2,
        ))
    eng._graph = None  # captured anew, without the serving run's PathProbe counters
    eng.step()  # prefills every slot, decodes once and captures the decode step
    out = {}
    for mode in ("replay", "eager"):
        eng._replay = mode == "replay"
        out[mode] = _profile_steps(eng, n_steps)
        if mode == "replay":
            out[mode]["graph_span_ms"] = _graph_span_ms(eng)
        p = out[mode]
        log(f"profile {mode}: full-batch decode step {p['plain_step_ms']:.1f} ms unprofiled (host "
            f"sieve {p['host_sieve_ms']:.1f} ms); profiled {p['step_ms']:.1f} ms with the device busy "
            f"{p['device_ms']:.1f} ms, idle share {p['idle_share']:.3f}; per step {p['kernels_per_step']} "
            f"kernels on the device, {p['launches_per_step']} cudaLaunchKernel and "
            f"{p['graph_launches_per_step']} cudaGraphLaunch calls"
            + (f"; the graph alone {p['graph_span_ms']:.2f} ms" if "graph_span_ms" in p else ""))
        for key, calls, ms in p["top_device"]:
            log(f"  device {ms:8.3f} ms/step {calls:6d} calls  {key[:90]}")
        for key, calls, ms in p["port_kernels"]:
            log(f"  port kernel {key}: {ms:.3f} ms/step, {calls} calls")
        for key, calls, ms in p["top_host"]:
            log(f"  host   {ms:8.3f} ms/step {calls:6d} calls  {key[:90]} (profiled)")
    eng._replay = True
    while not eng.sched.idle:
        eng.step()
    return out


def _graph_span_ms(eng, n: int = 10) -> float:
    """Device time of one replay of the engine's captured decode step, by
    CUDA events around ``n`` replays on the current stream."""
    import torch

    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        eng._graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def _profile_steps(eng, n_steps: int) -> dict:
    """``n_steps`` decode steps on the host clock, then ``n_steps`` under
    ``torch.profiler`` (see ``phase_profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_sieve, sieve_s = eng._run_sieve, [0.0]

    def timed_sieve(counts):
        t = time.perf_counter()
        run_sieve(counts)
        sieve_s[0] += time.perf_counter() - t

    eng._run_sieve = timed_sieve
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    plain_step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    sieve_ms = 1e3 * sieve_s[0] / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    del eng._run_sieve
    rows = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side rows only (kernels, copies): an op's row repeats the time
    # of the kernels it launched
    on_device = [e for e in rows if str(e.device_type).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in on_device) / 1e3 / n_steps
    if device_ms > step_ms:
        fail(f"profile: device busy {device_ms:.2f} ms exceeds the profiled step {step_ms:.2f} ms")
    top_dev = sorted(on_device, key=dev_us, reverse=True)[:12]
    top_cpu = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]

    def host_calls(key):
        return sum(e.count for e in rows if e.key == key) // n_steps

    return dict(
        plain_step_ms=plain_step_ms, host_sieve_ms=sieve_ms,
        step_ms=step_ms, device_ms=device_ms,
        kernels_per_step=sum(e.count for e in on_device if not e.key.startswith("Mem")) // n_steps,
        launches_per_step=host_calls("cudaLaunchKernel"),
        graph_launches_per_step=host_calls("cudaGraphLaunch"),
        idle_share=1.0 - device_ms / step_ms,
        top_device=[(e.key, e.count // n_steps, dev_us(e) / 1e3 / n_steps) for e in top_dev],
        # the port's own kernels (the __global__ functions of SOURCES, a
        # template's instance by its arguments), top 12 or not
        port_kernels=[(name, e.count // n_steps, dev_us(e) / 1e3 / n_steps)
                      for e, name in ((e, _port_kernel_of(e.key)) for e in on_device) if name],
        top_host=[(e.key, e.count // n_steps, e.self_cpu_time_total / 1e3 / n_steps) for e in top_cpu],
    )


@functools.lru_cache(maxsize=None)
def _port_kernel_names() -> frozenset:
    """The ``__global__`` functions of the sources in ``SOURCES``."""
    import re

    return frozenset(name for f in {src for src, _ in SOURCES.values()}
                     for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                            (ROOT / f).read_text()))


def _port_kernel_of(key: str):
    """The port kernel (with its template arguments) that a profiler row
    of a device kernel names, or None for any other kernel."""
    import re

    m = re.search(r"(\w+)(<[^<>()]*>)?\(", key)
    return m.group(1) + (m.group(2) or "") if m and m.group(1) in _port_kernel_names() else None


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def _prefill_decode(lm, params, prompt, tok, paged: bool, stub=None):
    """Prefill logits and the logits of one decode step that feeds token
    ``tok`` (1, 1) at position P.  Paged: the prompt's K/V is
    padded to whole pages and written over pool blocks taken in reverse
    order (block 0 is the trash block), as the engine does.  ``stub``
    (the vision-patch stub's ``embeds`` and ``mrope_positions``) takes the
    prompt's place, and the decode step then carries M-RoPE positions
    whose streams differ too."""
    import torch

    dev = lm.device
    if stub is None:
        logits_p, req_cache, _ = lm.prefill(params, {"tokens": prompt.to(dev)})
        P = prompt.shape[1]
    else:
        logits_p, req_cache, _ = lm.prefill(params, {k: v.to(dev) for k, v in stub.items()})
        P = stub["embeds"].shape[1]
    batch = {"tokens": tok.to(dev), "position": torch.tensor([P], dtype=torch.int32, device=dev)}
    if stub is not None:
        batch["mrope_positions"] = torch.tensor([[[P]], [[P + 3]], [[P + 7]]], dtype=torch.int32, device=dev)
    if not paged:
        cache = lm.init_cache(1, 64)
        for key in cache:
            for dst, src in zip(cache[key], req_cache[key]):
                dst[:, :, :P].copy_(src)
    else:
        page, max_blocks = 16, 64
        n = P // page + 1  # blocks covering positions 0..P
        n_pool = n + 2  # block 0 trash, block 1 never used
        ids = torch.arange(n_pool - 1, 1, -1)
        cache = lm.init_paged_cache(n_pool, page)
        nbp = -(-P // page)
        for dst, src in ((d, s) for key in cache for d, s in zip(cache[key], req_cache[key])):
            rows = torch.nn.functional.pad(src[:, 0], (0, 0, 0, 0, 0, nbp * page - P))
            dst[:, ids[:nbp].to(dev)] = rows.reshape((rows.shape[0], nbp, page) + rows.shape[2:])
        table = torch.zeros((1, max_blocks), dtype=torch.int32)
        table[0, :n] = ids
        owner = torch.full((n_pool,), -1, dtype=torch.int32)
        owner[ids] = 0
        pos = torch.zeros((n_pool,), dtype=torch.int32)
        pos[ids] = torch.arange(n, dtype=torch.int32)
        batch.update(block_tables=table.to(dev), pool_owner=owner.to(dev), pool_pos=pos.to(dev))
    logits_d, _, _ = lm.decode_step(params, batch, cache)
    return logits_p, logits_d


# ---------------------------------------------------------------------------
# phase 5: the runtime loop
# ---------------------------------------------------------------------------


def _serving_requests(arch, seed: int, n: int, prompt=(128, 513), new=(16, 33)):
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=[int(t) for t in rng.integers(0, arch.vocab_size, int(rng.integers(*prompt)))],
                    max_new_tokens=int(rng.integers(*new))) for _ in range(n)]


def _check_tokens(what: str, reqs, vocab: int) -> None:
    for r in reqs:
        if len(r.generated) != r.max_new_tokens or not all(0 <= t < vocab for t in r.generated):
            fail(f"{what}: request {r.req_id} finished with {len(r.generated)} of {r.max_new_tokens} "
                 "tokens or a token outside the vocabulary")


def _finished_tokens(eng) -> list:
    return [r.generated for r in sorted(eng.sched.finished, key=lambda r: r.req_id)]


def _runtime_measured(lm, params, batching, path_kernels, kernel_ms, run: str) -> dict:
    """The measured engine on the 12 requests of phase 4: launches by path
    and by probes, probe times, boundary cost, one capture, the trace."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine
    from repro_torch.telemetry import Telemetry, write_trace

    arch = lm.arch
    tel = Telemetry()
    eng = ServingEngine(lm, params, batching, telemetry=tel, cost_source="measured",
                        sieve_refresh_every=RUNTIME_REFRESH)
    probe_launches = {k: 0 for k in ops.LAUNCHES}
    run_probes, decode = eng._run_probes, eng._decode
    calls = {"decode": 0, "replays": 0}

    def counted_probes():
        before = dict(ops.LAUNCHES)
        run_probes()
        for k in probe_launches:
            probe_launches[k] += ops.LAUNCHES[k] - before[k]

    def counted_decode(batch):
        calls["decode"] += 1
        calls["replays"] += eng._graph is not None
        return decode(batch)

    eng._run_probes, eng._decode = counted_probes, counted_decode
    reqs = _serving_requests(arch, 0, 12)
    ops.reset_launches()  # counts from here on are this run's
    t_start = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = []  # (step, boundary, decode only, ms)
    while not eng.sched.idle:
        k, p0 = eng.stats.steps, eng.stats.prefill_tokens
        t0 = time.perf_counter()
        eng.step()
        steps.append((k, (k + 1) % RUNTIME_REFRESH == 0, eng.stats.prefill_tokens == p0,
                      1e3 * (time.perf_counter() - t0)))
        if eng.stats.steps > 2000:
            fail(f"runtime {run}: the measured engine did not finish in 2000 steps")
    wall = time.perf_counter() - t_start
    launches = dict(ops.LAUNCHES)
    _check_tokens(f"runtime {run} measured", reqs, arch.vocab_size)
    if eng.n_captures != 1 or calls["replays"] != calls["decode"] - 1:
        fail(f"runtime {run}: {eng.n_captures} captures, {calls['replays']} of {calls['decode']} decode "
             "steps replayed; one capture and every later step replayed are required")
    for name, n in launches.items():
        if (name in path_kernels) != (n > 0) or (name in path_kernels) != (probe_launches[name] > 0):
            fail(f"runtime {run}: kernel {name} launched {n} times, {probe_launches[name]} by the probes; "
                 f"the path's kernels {path_kernels} and no other must launch, probes included")
    feed, probes = eng._timing_feed, eng._probes
    if feed.n_fed <= 0 or probes.n_probes <= 0 or len(eng.sieve_refreshes) < 2:
        fail(f"runtime {run}: the measured loop fed {feed.n_fed} cells from {probes.n_probes} probes "
             f"with {len(eng.sieve_refreshes)} refreshes")
    spans = {}
    for e in tel.events():
        if e["kind"] == "span":
            spans.setdefault(e["name"], []).append((e["value"], e["dur_ns"] / 1e6))
    tail_by_n = {}
    for n, ms in spans.get("stage/tail_gemv", []):
        tail_by_n.setdefault(int(n), []).append(ms)

    def med(name):
        v = [ms for _, ms in spans.get(name, [])]
        return float(np.median(v)) if v else None

    probe_ms = [ms for _, ms in spans["engine/probe"]]
    boundary = [ms for _, b, only, ms in steps if b and only]
    other = [ms for k, b, only, ms in steps if not b and only and k > 0]
    out_dir = ROOT / "chiprun_out"
    trace = write_trace(tel, str(out_dir / f"trace_measured_{run}.json"))
    out = dict(
        requests=len(reqs), steps=eng.stats.steps, wall_s=wall, captures=eng.n_captures,
        decode_calls=calls["decode"], replays=calls["replays"], launches=launches,
        probe_launches={k: n for k, n in probe_launches.items() if n},
        probes=probes.n_probes, fed=feed.n_fed, rejected=feed.n_rejected, refreshes=len(eng.sieve_refreshes),
        pim_healthy=eng.pim_healthy,
        tail_probe_ms={n: float(np.median(v)) for n, v in sorted(tail_by_n.items())},
        tail_model_ms={n: 1e3 * eng._pim.expert_time(eng.layer_spec, n) for n in sorted(tail_by_n)},
        head_probe_ms=med("stage/head_gmm"), attention_probe_ms=med("stage/attention"),
        dispatch_probe_ms=med("stage/dispatch"),
        kernel_ms={k: kernel_ms[k] for k in path_kernels},
        probe_pass_ms=spread(probe_ms), refresh_ms=med("engine/sieve_refresh"),
        boundary_step_ms=spread(boundary) if boundary else None,
        other_decode_step_ms=spread(other) if other else None,
        trace=str(Path(trace).relative_to(ROOT)),
    )
    log(f"runtime {run} measured: {len(reqs)} requests, {out['steps']} steps in {wall:.2f} s; "
        f"{calls['replays']} of {calls['decode']} decode steps replayed ({eng.n_captures} capture); "
        f"{probes.n_probes} probes, {feed.n_fed} cells fed ({feed.n_rejected} rejected), "
        f"{out['refreshes']} refreshes; probe launches {out['probe_launches']}; trace {out['trace']}")
    log(f"runtime {run} probes (median device ms): tail by tokens "
        + ", ".join(f"{n}: {ms:.4f} (PIM model {out['tail_model_ms'][n]:.4f})"
                    for n, ms in out["tail_probe_ms"].items())
        + f"; head {out['head_probe_ms']:.4f}; attention {out['attention_probe_ms']:.4f}; "
        f"dispatch {out['dispatch_probe_ms']:.4f}; phase 3 kernels "
        + ", ".join(f"{k} {v:.4f}" for k, v in out["kernel_ms"].items()))
    b, o, pp = out["boundary_step_ms"], out["other_decode_step_ms"], out["probe_pass_ms"]
    log(f"runtime {run} boundary: probe pass {pp['median']:.2f} ms per boundary ({pp['min']:.2f}-"
        f"{pp['max']:.2f}, {pp['n']} boundaries), refresh {out['refresh_ms']:.3f} ms; decode-only steps: "
        + (f"boundary {b['median']:.1f} ms ({b['min']:.1f}-{b['max']:.1f}, {b['n']})" if b else "no boundary")
        + (f" against {o['median']:.1f} ms ({o['min']:.1f}-{o['max']:.1f}, {o['n']}) for the others"
           if o else ""))
    del eng
    torch.cuda.empty_cache()
    return out


def _runtime_health(lm, params, batching, run: str) -> dict:
    """The sentinel tail probe 16x slower over a window of steps, then
    brownout stage 2 and back, a shed and a clamped batch request."""
    import torch

    from repro_torch.serving import Request, ServingEngine
    from repro_torch.telemetry import Telemetry
    from repro_torch.telemetry.probes import TAIL_SPAN

    arch = lm.arch
    window = range(12, 28)
    stages = {40: 2, 44: 3, 46: 1, 48: 0}

    def slow_sentinel(name, value, dt):
        return dt * 16 if name == TAIL_SPAN and value == 1 else dt

    counter = RowCounter(2)  # slot 0 the engine's steps, slot 1 the probes
    try:
        eng = ServingEngine(lm, params, batching, telemetry=Telemetry(), cost_source="measured",
                            sieve_refresh_every=RUNTIME_REFRESH)
        run_probes = eng._run_probes

        def probes_apart():
            counter.slot = 1
            try:
                run_probes()
            finally:
                counter.slot = 0

        eng._run_probes = probes_apart
        reqs = _serving_requests(arch, 1, 8, prompt=(128, 129), new=(56, 57))
        for r in reqs:
            eng.submit(r)
        traj, admitted = [], {}
        while not eng.sched.idle:
            k = eng.stats.steps
            eng._probes.corrupt = slow_sentinel if k in window else None
            if k in stages:
                eng.set_brownout_stage(stages[k])
                if stages[k] in (1, 3):
                    batch_req = Request(prompt=list(reqs[0].prompt), max_new_tokens=30, priority="batch")
                    admitted[stages[k]] = (batch_req, eng.submit(batch_req))
            gpu_only, rows = eng._sieve_gpu_only, counter.rows[0].tolist()
            eng.step()
            after = counter.rows[0].tolist()
            traj.append(dict(step=k, gpu_only=gpu_only, healthy=eng.pim_healthy, stage=eng.brownout_stage,
                             head=after[0] - rows[0], tail=after[1] - rows[1]))
            if eng.stats.steps > 2000:
                fail(f"runtime {run} health: the engine did not finish in 2000 steps")
    finally:
        counter.remove()
    detect = next((t["step"] for t in traj if t["step"] >= window.start and not t["healthy"]), None)
    recover = next((t["step"] for t in traj if t["step"] >= window.stop and t["healthy"]
                    and t["step"] > (detect or 0)), None)
    gpu_steps = [t for t in traj if t["gpu_only"]]
    by_cause = {"fault": sum(t["step"] < min(stages) for t in gpu_steps)}
    by_cause["brownout"] = len(gpu_steps) - by_cause["fault"]
    if detect is None or detect - window.start >= RUNTIME_REFRESH:
        fail(f"runtime {run} health: not quarantined within one refresh cadence of the fault (step {detect})")
    if recover is None:
        fail(f"runtime {run} health: not healthy again after the fault cleared")
    if any(t["tail"] for t in gpu_steps):
        fail(f"runtime {run} health: a GPU-only step put tail rows on the PIM side: "
             f"{[t for t in gpu_steps if t['tail']]}")
    if not all(t["gpu_only"] for t in traj if t["step"] in (41, 42, 43, 44, 45)) or by_cause["brownout"] < 4:
        fail(f"runtime {run} brownout: stage 2 and 3 did not clamp the split to GPU-only")
    if traj[-1]["gpu_only"] or not traj[-1]["healthy"]:
        fail(f"runtime {run}: the run ended GPU-only or unhealthy")
    shed_req, shed_ok = admitted[3]
    clamp_req, clamp_ok = admitted[1]
    if shed_ok or eng.stats.shed_requests != 1 or shed_req.generated:
        fail(f"runtime {run} brownout: stage 3 did not shed the batch request")
    if not clamp_ok or clamp_req.max_new_tokens != eng.brownout_batch_max_new \
            or len(clamp_req.generated) != eng.brownout_batch_max_new:
        fail(f"runtime {run} brownout: stage 1 did not clamp the batch request to "
             f"{eng.brownout_batch_max_new} tokens")
    _check_tokens(f"runtime {run} health", reqs + [clamp_req], arch.vocab_size)
    if eng.n_captures != 1:
        fail(f"runtime {run} health: {eng.n_captures} captures; one is required")
    tail_rows_open = sum(t["tail"] for t in traj if not t["gpu_only"])
    out = dict(window=[window.start, window.stop], detect_step=detect, recover_step=recover,
               gpu_only_steps=by_cause, tail_rows_other=tail_rows_open,
               shed=eng.stats.shed_requests, clamped_to=clamp_req.max_new_tokens, captures=eng.n_captures,
               transitions=[(t.t, t.target, t.new) for t in eng.health.transitions], trajectory=traj)
    log(f"runtime {run} health: sentinel 16x slower over steps {window.start}-{window.stop - 1}: quarantined "
        f"at step {detect}, healthy at step {recover}; {len(gpu_steps)} GPU-only steps {by_cause} put "
        f"no tail rows on the PIM side (other steps: {tail_rows_open} tail rows); brownout 2 and back, "
        f"stage 3 shed {out['shed']}, stage 1 clamped a batch request to {out['clamped_to']} tokens; "
        f"{eng.n_captures} capture throughout")
    del eng
    torch.cuda.empty_cache()
    return out


def _runtime_sampling(lm, params, batching, run: str) -> dict:
    """Two engines with ``greedy=False, seed=7`` on the same requests."""
    import torch

    from repro_torch.serving import ServingEngine

    tokens = []
    for _ in range(2):
        eng = ServingEngine(lm, params, batching, greedy=False, seed=7)
        reqs = _serving_requests(lm.arch, 2, 3, prompt=(64, 65), new=(8, 9))
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        _check_tokens(f"runtime {run} sampling", reqs, lm.arch.vocab_size)
        tokens.append([r.generated for r in reqs])
        del eng
    if tokens[0] != tokens[1]:
        fail(f"runtime {run}: two engines with greedy=False, seed=7 gave other tokens")
    log(f"runtime {run} sampling: two engines with greedy=False, seed=7 gave the same "
        f"{sum(map(len, tokens[0]))} tokens")
    torch.cuda.empty_cache()
    return dict(tokens=sum(map(len, tokens[0])), same=True)


def _runtime_snapshot(lm, params, batching, run: str) -> dict:
    """Snapshot a measured engine (deterministic probe times) mid-run; it
    finishes, then is restored into its own captured graph and into a fresh
    engine, and both must finish as it did, bit for bit."""
    import tempfile

    import torch

    from repro_torch.serving import ServingEngine
    from repro_torch.telemetry import Telemetry

    def probe_time(name, value, dt):  # pure in span name and value
        return 1e-4 * (1 + 0.1 * (value - 1)) if name == "stage/tail_gemv" else 1e-4

    def engine():
        eng = ServingEngine(lm, params, batching, telemetry=Telemetry(), cost_source="measured",
                            sieve_refresh_every=RUNTIME_REFRESH)
        eng._probes.corrupt = probe_time
        decode = eng._decode

        def recorded(batch):
            out = decode(batch)
            eng.last_logits = out[0].float().cpu()
            return out

        eng._decode = recorded
        return eng

    def finish(eng):
        eng.run_until_done()
        return _finished_tokens(eng), eng.last_logits, [t.clone() for t in eng.cache["blocks"]]

    def same(a, b):
        return a[0] == b[0] and torch.equal(a[1], b[1]) and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as snap_dir:
        a = engine()
        for r in _serving_requests(lm.arch, 3, 8, prompt=(128, 257), new=(20, 25)):
            a.submit(r)
        while a.stats.steps < 10:
            a.step()
        t0 = time.perf_counter()
        path = a.snapshot(snap_dir)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        want = finish(a)
        t0 = time.perf_counter()
        a.restore(snap_dir)
        restore_captured_s = time.perf_counter() - t0
        again = finish(a)
        b = engine()
        t0 = time.perf_counter()
        b.restore(snap_dir)
        restore_fresh_s = time.perf_counter() - t0
        fresh = finish(b)
    if not same(again, want) or not same(fresh, want):
        fail(f"runtime {run} snapshot: a restored engine did not continue bit for bit "
             f"(captured {same(again, want)}, fresh {same(fresh, want)})")
    if a.n_captures != 1 or b.n_captures != 1:
        fail(f"runtime {run} snapshot: captures {a.n_captures} / {b.n_captures}; one each is required")
    out = dict(bytes=size, save_s=save_s, restore_fresh_s=restore_fresh_s,
               restore_captured_s=restore_captured_s, captures=[a.n_captures, b.n_captures], bitwise=True)
    log(f"runtime {run} snapshot: {size / 1e9:.3f} GB at step 10, save {save_s:.2f} s, restore "
        f"{restore_fresh_s:.2f} s into a fresh engine and {restore_captured_s:.2f} s into the captured one; "
        "both continued with the same tokens, last logits and KV cache bit for bit, one capture each")
    del a, b, want, again, fresh
    torch.cuda.empty_cache()
    return out


def phase_runtime(lm, params, batching, path_kernels, kernels) -> dict:
    run = "paged" if batching.paged else "dense"
    kernel_ms = {k: v["ms"] for k, v in kernels.items()}
    return dict(
        measured=_runtime_measured(lm, params, batching, path_kernels, kernel_ms, run),
        health=_runtime_health(lm, params, batching, run),
        sampling=_runtime_sampling(lm, params, batching, run),
        snapshot=_runtime_snapshot(lm, params, batching, run),
    )


# ---------------------------------------------------------------------------
# phase 8: every policy, the on-device split, engine chaos
# ---------------------------------------------------------------------------

CHAOS_STEPS = 48  # make_plan's horizon: the fault spans steps 14-27


def host_cpu() -> str:
    """The host CPU's model name, as ``/proc/cpuinfo`` gives it, and the
    cores visible (host-clock numbers depend on both)."""
    name = "unknown"
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            if key.strip() == "model name":
                name = value.strip()
                break
    return f"CPU model {name}, {os.cpu_count()} cores visible"


def _dual_threshold_check(moe, n_tokens: int, mismatches: list):
    """``check_step`` of the ``dual_threshold`` run: ``dual_threshold_schedule``
    on each layer's counts gives the head groups (its GPU set), head rows
    (that set's rows, clamped at the decode step's capacity) and tail rows
    (its PIM set's rows, clamped at ``dual_tail_tokens``) the captured row
    counters must hold; a step that differs goes into ``mismatches``."""
    import numpy as np

    from repro_torch.core.scheduler import dual_threshold_schedule
    from repro_torch.models.moe import capacity

    tau = moe.dual_tail_tokens
    cap = capacity(n_tokens, moe, moe.n_experts)

    def check(eng, counts, rows):
        want = [0, 0, 0]
        for c in counts:
            part = dual_threshold_schedule(c, eng.cost_model, None, tail_tokens=tau, max_head=moe.dual_max_head)
            want[0] += int(np.minimum(c[part.gpu_experts], cap).sum())
            want[1] += int(np.minimum(c[part.pim_experts], tau).sum())
            want[2] += len(part.gpu_experts)
        if rows != want:
            mismatches.append((eng.stats.steps, rows, want))

    return check


def phase_dual_threshold(lm, params, batching, cost_run: dict) -> dict:
    """The fixed-threshold dual path (``expert_exec="dual_path"``) under the
    cost-blind ``dual_threshold`` host rule, on the same weights and 12
    requests as phase 4's dense/fused run.  On every replayed decode step
    the captured row counters must equal ``dual_threshold_schedule`` on the
    step's counts: head groups = its GPU set's size, head rows = that
    set's rows (clamped at capacity), tail rows = its PIM set's rows
    (clamped at ``dual_tail_tokens``).  Then the 2-layer slice against the
    CPU plain path (the phase-4 rule), and the run beside ``cost_run``,
    phase 4's ``dual_path_cost`` run."""
    from repro_torch.models import LM

    arch = dataclasses.replace(lm.arch, moe=dataclasses.replace(lm.arch.moe, expert_exec="dual_path"))
    mismatches = []
    check = _dual_threshold_check(arch.moe, batching.n_slots, mismatches)
    lm2 = LM(arch, dtype=lm.dtype, device=lm.device)
    run = "dense dual_path/dual_threshold"
    out = phase_serve(lm2, params, batching, DENSE_FUSED_PATH, run=run, policy="dual_threshold",
                      check_step=check)
    if mismatches or out["checked_steps"] < 2:
        fail(f"{run}: the head/tail split of {len(mismatches)} of {out['checked_steps']} replayed decode "
             f"steps differs from dual_threshold_schedule's (step, [head rows, tail rows, head groups], "
             f"wanted): {mismatches[:3]}")
    log(f"{run}: on all {out['checked_steps']} replayed decode steps the captured head groups, head rows "
        "and tail rows equal dual_threshold_schedule's GPU and PIM sets on the step's counts")
    out.update(phase_reference(lm2, params, paged=False, run=run))
    for key in ("full_batch_step_ms", "decode_tok_per_s", "ttft_p50_s", "tpot_p50_s"):
        out[f"{key}_dual_path_cost"] = cost_run[key]
    log(f"{run} beside dense dual_path_cost: full-batch step {out['full_batch_step_ms']:.1f} / "
        f"{cost_run['full_batch_step_ms']:.1f} ms, decode {out['decode_tok_per_s']:.1f} / "
        f"{cost_run['decode_tok_per_s']:.1f} tok/s, TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} / "
        f"{cost_run['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} / "
        f"{cost_run['tpot_p50_s'] * 1e3:.2f} ms; decode path: head rows "
        f"{out['path']['decode']['head_rows']} / {cost_run['path']['decode']['head_rows']}, tail rows "
        f"{out['path']['decode']['tail_rows']} / {cost_run['path']['decode']['tail_rows']}")
    del lm2
    return out


def _policy_host_ms(steps, cost_model, cost_table, moe, tag: str) -> dict:
    """Host ms of ``schedule(p, ...)`` over every layer of each recorded
    step, for each policy (the engine's keywords: the dual rules get the
    decode step's window), as the median with min-max over the steps.
    Each partition must cover the layer's active experts."""
    import numpy as np

    from repro_torch.core.scheduler import POLICIES, schedule

    out = {}
    for policy in POLICIES:
        kw = ({"tail_tokens": moe.dual_tail_tokens, "max_head": moe.dual_max_head}
              if policy in ("dual_threshold", "dual_cost") else {})
        ms, n_gpu = [], 0
        for counts in steps:
            t0 = time.perf_counter()
            parts = [schedule(policy, c, cost_model, cost_table, **kw) for c in counts]
            ms.append(1e3 * (time.perf_counter() - t0))
            for c, part in zip(counts, parts):
                part.validate(int((c > 0).sum()))
                n_gpu += len(part.gpu_experts)
        out[policy] = dict(spread(ms), gpu_experts_per_layer=n_gpu / (len(steps) * len(steps[0])))
    log(f"{tag} host ms per decode step ({len(steps)} full-batch steps x {len(steps[0])} layers x "
        f"{len(steps[0][0])} experts; {host_cpu()}), median (min-max), GPU experts a layer: "
        + "; ".join(f"{p} {r['median']:.3f} ({r['min']:.3f}-{r['max']:.3f}), {r['gpu_experts_per_layer']:.1f}"
                    for p, r in out.items()))
    return out


def _device_split(steps, cost_model, cost_table, tag: str, n_time: int = 100) -> dict:
    """``sieve_partition_torch`` and ``sieve_partition_dynamic`` on the
    card, greedy and argmin, each captured once as a CUDA graph over a
    fixed counts tensor, then replayed for every layer of every recorded
    step with that layer's counts written in place: the GPU set and split
    must equal the host ``sieve_schedule``'s exactly.  CUDA events time
    ``n_time`` replays and ``n_time`` eager calls on one layer's counts."""
    import numpy as np
    import torch

    from repro_torch.core.scheduler import sieve_schedule
    from repro_torch.core.scheduler_torch import (
        SieveParams, make_sieve_state, sieve_partition_dynamic, sieve_partition_torch,
    )

    E = len(steps[0][0])
    state = make_sieve_state(cost_table, cost_model, 1024, device="cuda")
    params = SieveParams.from_cost_model(cost_model, 0)  # t_comm 0 at ep_degree 1
    counts_buf = torch.zeros((E,), dtype=torch.int32, device="cuda")
    forms = {"torch": lambda mode: sieve_partition_torch(counts_buf, state.pim_time_by_count, params, mode),
             "dynamic": lambda mode: sieve_partition_dynamic(counts_buf, *state, mode)}
    out = {}
    for form, call in forms.items():
        for mode in ("greedy", "argmin"):
            for _ in range(3):  # eager warm-up: the static scalars' upload, the sort's scratch
                call(mode)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                res = call(mode)
            bad, n = [], 0
            for si, counts in enumerate(steps):
                for li, c in enumerate(counts):
                    host = sieve_schedule(c, cost_model, cost_table, mode=mode)
                    counts_buf.copy_(torch.as_tensor(c, dtype=torch.int32))
                    graph.replay()
                    got = np.nonzero(res["gpu_mask"].cpu().numpy())[0]
                    n += 1
                    if int(res["split"]) != host.meta["split"] or set(got) != set(host.gpu_experts.tolist()):
                        bad.append((si, li, int(res["split"]), host.meta["split"]))
            if bad:
                fail(f"{tag}: sieve_partition_{form} ({mode}) replayed differs from the host sieve_schedule "
                     f"on {len(bad)} of {n} layers (step, layer, device split, host split): {bad[:4]}")
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(n_time):
                graph.replay()
            e1.record()
            torch.cuda.synchronize()
            replay_ms = e0.elapsed_time(e1) / n_time
            e0.record()
            for _ in range(n_time):
                call(mode)
            e1.record()
            torch.cuda.synchronize()
            eager_ms = e0.elapsed_time(e1) / n_time
            out[f"{form}_{mode}"] = dict(layers=n, same=True, replay_ms=replay_ms, eager_ms=eager_ms,
                                         replay_ms_per_step=replay_ms * len(steps[0]))
            del graph, res
    log(f"{tag} on-device split (E {E}): equal to the host sieve_schedule on every layer, greedy and argmin; "
        "device ms per call (CUDA events over 100), replayed / eager: "
        + "; ".join(f"{k} {v['replay_ms']:.4f} / {v['eager_ms']:.4f}" for k, v in out.items()))
    return out


def phase_policies(serve_out: dict, moe, tag: str) -> dict:
    """Host time of every policy and the on-device split over the
    full-batch decode steps a serving run recorded (``keep_counts``)."""
    steps = serve_out.pop("_counts")[:10]
    cost_model, cost_table = serve_out.pop("_cost_model"), serve_out.pop("_cost_table")
    if not steps:
        fail(f"{tag}: the serving run recorded no full-batch decode step")
    return dict(host_cpu=host_cpu(), steps=len(steps), layers=len(steps[0]), experts=len(steps[0][0]),
                host_ms=_policy_host_ms(steps, cost_model, cost_table, moe, tag),
                device_split=_device_split(steps, cost_model, cost_table, tag))


def _chaos_full_width(lm, params, batching, scenario: str, magnitude=None) -> dict:
    """A measured engine built as phase 5's, driven through ``EngineChaos``
    under ``make_plan(scenario, CHAOS_STEPS, seed=0)`` with the slots kept
    full; returns its summary and every request's tokens."""
    import numpy as np

    from repro_torch.faults import EngineChaos, make_plan
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.telemetry import Telemetry

    eng = ServingEngine(lm, params, batching, telemetry=Telemetry(), cost_source="measured",
                        sieve_refresh_every=RUNTIME_REFRESH)
    chaos = EngineChaos(eng, make_plan(scenario, float(CHAOS_STEPS), seed=0, magnitude=magnitude))
    rng = np.random.default_rng(5)
    max_new = 12
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, lm.arch.vocab_size, 64)], max_new_tokens=max_new)
            for _ in range(batching.n_slots * (CHAOS_STEPS // max_new + 2))]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    for _ in range(CHAOS_STEPS):
        chaos.step()
    out = chaos.summary()
    out.update(wall_s=time.perf_counter() - t0, captures=eng.n_captures,
               tokens=[list(r.generated) for r in reqs])
    del eng, chaos
    return out


def phase_chaos(lm, params, batching) -> dict:
    """Both engine scenarios at full width (and a x1 control for the
    tokens), then ``run_engine_chaos(device="cuda")`` at proxy size with
    tests/test_faults.py's checks."""
    import torch

    from repro_torch.faults import ENGINE_SCENARIOS, run_engine_chaos

    out = {"full_width": {}, "proxy": {}}
    control = _chaos_full_width(lm, params, batching, "pim-brownout-engine", magnitude=1.0)
    for scenario in ENGINE_SCENARIOS:
        r = _chaos_full_width(lm, params, batching, scenario)
        diff = sum(a != b for x, y in zip(r["tokens"], control["tokens"]) for a, b in zip(x, y))
        diff += sum(abs(len(x) - len(y)) for x, y in zip(r["tokens"], control["tokens"]))
        n_tok = sum(map(len, control["tokens"]))
        caps = {rec["decode_cache"] for rec in r["trajectory"]}
        keys = ("fault_t", "clear_t", "detect_step", "gpu_only_step", "recover_step", "restored", "feed_rejected")
        row = {k: r[k] for k in keys}
        row.update(captures=r["captures"], captures_seen=sorted(caps), tokens=n_tok, tokens_differing=diff,
                   wall_s=r["wall_s"], control_gpu_only_step=control["gpu_only_step"])
        out["full_width"][scenario] = row
        log(f"chaos {scenario} full width ({CHAOS_STEPS} steps, refresh {RUNTIME_REFRESH}): fault steps "
            f"{r['fault_t']:g}-{r['clear_t'] - 1:g}, detected at {r['detect_step']}, GPU-only at "
            f"{r['gpu_only_step']}, recovered at {r['recover_step']}, restored {r['restored']}, feed rejected "
            f"{r['feed_rejected']}, captures {r['captures']}; {diff} of {n_tok} tokens differ from the x1 "
            f"control (not asserted: the GPU-only clamp moves rows between two bf16 kernels)")
        if (r["detect_step"] is None or r["gpu_only_step"] is None or r["recover_step"] is None
                or not r["restored"] or r["gpu_only_step"] - r["fault_t"] > RUNTIME_REFRESH):
            fail(f"chaos {scenario} full width: not detected, clamped within one refresh cadence and "
                 f"restored: {row}")
        if r["captures"] != 1 or caps != {1} or r["cache_misses_after_fault"] != 0:
            fail(f"chaos {scenario} full width: captures {sorted(caps)}; one is required throughout")
        if any(rec["quarantined"] != rec["gpu_only"] for rec in r["trajectory"]):
            fail(f"chaos {scenario} full width: quarantine and the GPU-only clamp disagree on a step")
        if scenario == "probe-poison" and r["feed_rejected"] <= 0:
            fail("chaos probe-poison full width: the feed's outlier gates rejected nothing")
        if control["gpu_only_step"] is not None:
            fail("chaos control (x1): the fault-free run was clamped to GPU-only")
    torch.cuda.empty_cache()
    # the reduced proxy, as tests/test_faults.py::TestEngineChaos runs it
    ctl = run_engine_chaos("pim-brownout-engine", n_steps=28, seed=0, refresh=4, magnitude=1.0)
    for scenario in ENGINE_SCENARIOS:
        r = run_engine_chaos(scenario, n_steps=28, seed=0, refresh=4)
        ok = (r["gpu_only_step"] is not None and r["gpu_only_step"] - r["fault_t"] <= 4
              and r["cache_misses_after_fault"] == 0 and r["cache_at_end"] == 1
              and r["recover_step"] is not None and r["restored"]
              and all(rec["quarantined"] == rec["gpu_only"] for rec in r["trajectory"])
              and (scenario != "probe-poison" or r["feed_rejected"] > 0)
              and (scenario != "pim-brownout-engine" or ctl["tokens"] == r["tokens"]))
        row = {k: r[k] for k in ("fault_t", "detect_step", "gpu_only_step", "recover_step", "restored",
                                 "feed_rejected", "cache_at_end", "cache_misses_after_fault")}
        row["same_tokens_as_control"] = ctl["tokens"] == r["tokens"]
        out["proxy"][scenario] = row
        log(f"chaos {scenario} proxy (run_engine_chaos on the card, 28 steps): {row}")
        if not ok:
            fail(f"chaos {scenario} proxy: tests/test_faults.py's checks failed: {row}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the dense and VLM families
# ---------------------------------------------------------------------------

# (config, layers served (None: full depth), KV layouts) of each family run
FAMILIES = (
    ("granite-3-2b", None, ("dense", "paged")),
    ("qwen1.5-0.5b", None, ("dense",)),
    ("qwen2-vl-7b", None, ("dense",)),
    ("granite-3-8b", 2, ("dense",)),
    ("deepseek-coder-33b", 2, ("dense",)),
)


def _serve_family(lm, params, batching, profile: bool) -> dict:
    """12 seeded requests (as phase 4) through ``ServingEngine``: every
    token delivered, one capture, every decode step after the first
    replayed, one launch of the layout's attention kernel per layer and
    decode step (counted through the replays) and no other kernel; with
    ``profile``, then ``phase_profile``'s split of a full-batch step."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine

    arch = lm.arch
    run = f"{arch.name} {'paged' if batching.paged else 'dense'}"
    eng = ServingEngine(lm, params, batching)
    decode, calls = eng._decode, {"decode": 0, "replays": 0}

    def counted(batch):
        calls["decode"] += 1
        calls["replays"] += eng._graph is not None
        return decode(batch)

    eng._decode = counted
    reqs = _serving_requests(arch, 0, 12)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # counts from here on are this run's
    t_start = time.perf_counter()
    for r in reqs:
        r.arrival_time = t_start
        eng.submit(r)
    decode_steps = []  # steps that ran no prefill: (decode tokens, ms)
    while not eng.sched.idle:
        p0, d0 = eng.stats.prefill_tokens, eng.stats.decode_tokens
        ts = time.perf_counter()
        eng.step()
        if eng.stats.prefill_tokens == p0:
            decode_steps.append((eng.stats.decode_tokens - d0, 1e3 * (time.perf_counter() - ts)))
        if eng.stats.steps > 2000:
            fail(f"{run}: serving did not finish in 2000 steps")
    wall = time.perf_counter() - t_start
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    _check_tokens(run, reqs, arch.vocab_size)
    attn = "decode_attention_paged" if batching.paged else "decode_attention"
    if eng.n_captures != 1 or calls["replays"] != calls["decode"] - 1:
        fail(f"{run}: {eng.n_captures} captures, {calls['replays']} of {calls['decode']} decode steps "
             "replayed; one capture and every later step replayed are required")
    if launches != {attn: arch.n_layers * calls["decode"]}:
        fail(f"{run}: launches {launches}; {arch.n_layers} x {calls['decode']} of {attn} and no other "
             "kernel are required")
    if eng.paged is not None and eng.paged.n_free != eng.paged.n_pool - 1:
        fail(f"{run}: {eng.paged.n_free} of {eng.paged.n_pool - 1} pool blocks free after the run")
    ttft = sorted(r.first_token_time - r.arrival_time for r in reqs)
    tpot = sorted((r.finish_time - r.first_token_time) / (len(r.generated) - 1) for r in reqs)
    dec_tok = sum(n for n, _ in decode_steps)
    dec_ms = sum(ms for _, ms in decode_steps)
    full = [ms for n, ms in decode_steps if n == batching.n_slots]
    out = dict(
        requests=len(reqs), prompt_tokens=eng.stats.prefill_tokens, decode_tokens=eng.stats.decode_tokens,
        steps=eng.stats.steps, wall_s=wall,
        decode_tok_per_s=1e3 * dec_tok / dec_ms if dec_ms else 0.0,
        full_batch_step_ms=float(np.median(full)) if full else None, full_batch_steps=len(full),
        ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
        tpot_p50_s=tpot[len(tpot) // 2], tpot_max_s=tpot[-1],
        captures=eng.n_captures, decode_calls=calls["decode"], replays=calls["replays"],
        launches=launches, launches_per_decode_step=launches[attn] / calls["decode"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log(f"serve {run}: {len(reqs)} requests, {out['prompt_tokens']} prompt + {out['decode_tokens']} decode "
        f"tokens in {wall:.2f} s ({out['steps']} steps); decode {out['decode_tok_per_s']:.1f} tok/s, "
        f"full-batch step median {out['full_batch_step_ms'] or 0.0:.2f} ms over {len(full)}; "
        f"TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms "
        f"max {out['ttft_max_s'] * 1e3:.1f} ms; TPOT p50 {out['tpot_p50_s'] * 1e3:.2f} ms; "
        f"{calls['replays']} of {calls['decode']} decode steps replayed, {eng.n_captures} capture; "
        f"launches {launches} ({out['launches_per_decode_step']:.0f} per decode step)")
    if profile:
        out["profile"] = phase_profile(eng, arch, np.random.default_rng(0))
    del eng
    torch.cuda.empty_cache()
    return out


def _family_reference(lm, params, paged: bool) -> dict:
    """A 2-layer slice of the served weights on the card against the plain
    path on the CPU (the phase-4 rule: max |err| at most 5% of the largest
    logit, cosine at least 0.999): prefill and one decode step, the VLM's
    prefill on the vision-patch stub with distinct t/h/w positions."""
    import numpy as np
    import torch

    from repro_torch.models import LM

    arch = lm.arch
    run = f"{arch.name} {'paged' if paged else 'dense'}"
    small, gp = _two_layers(arch, params)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, arch.vocab_size, (1, 32)))
    tok = torch.as_tensor(rng.integers(0, arch.vocab_size, (1, 1)))
    card, cpu = LM(small, torch.bfloat16, "cuda"), LM(small, torch.bfloat16, "cpu")
    stub = card.stub_inputs(1, 32, seed=3) if arch.modality_stub == "vision_patches" else None
    got = _prefill_decode(card, gp, prompt, tok, paged, stub)
    want = _prefill_decode(cpu, _to_cpu(gp), prompt, tok, paged,
                           None if stub is None else {k: v.cpu() for k, v in stub.items()})
    out = {}
    for stage, g, w in zip(("prefill", "decode"), got, want):
        g, w = g.float().cpu()[..., : arch.vocab_size], w.float()[..., : arch.vocab_size]
        if not torch.isfinite(g).all():
            fail(f"{run} {stage} logits are not finite")
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0))
        out[f"ref_{stage}_max_abs_err"], out[f"ref_{stage}_cosine"] = err, cos
        log(f"reference {run}: 2-layer {stage} logits{' (vision-patch stub)' if stub is not None else ''}, "
            f"card vs CPU plain path: max |err| {err:.4g} (max |logit| {scale:.3g}), cosine {cos:.6f}")
        if err > 5e-2 * scale or cos < 0.999:
            fail(f"{run} {stage} logits of the card disagree with the CPU plain path")
    return out


def _vision_prefill(lm, params) -> dict:
    """One prefill of the full model on 256 seeded vision-patch embeddings
    with distinct t/h/w positions: finite logits of the expected shape, a
    cache of the prompt's K/V, and logits other than the same embeddings'
    with text positions (the positions reach the rotation)."""
    import torch

    stub = lm.stub_inputs(1, 256, seed=5)
    t0 = time.perf_counter()
    logits, cache, _ = lm.prefill(params, stub)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    a = lm.arch
    if tuple(logits.shape) != (1, 1, lm.vocab_padded) or not torch.isfinite(logits[..., : a.vocab_size]).all():
        fail(f"{a.name} stub prefill: logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits[..., : a.vocab_size]).all())}")
    if tuple(cache["blocks"][0].shape) != (a.n_layers, 1, 256, a.attn.n_kv_heads, a.attn.d_head):
        fail(f"{a.name} stub prefill: cache {tuple(cache['blocks'][0].shape)}")
    text = dict(stub, mrope_positions=stub["mrope_positions"][0].expand(3, -1, -1))
    moved = float((lm.prefill(params, text)[0] - logits).float().abs().max())
    if moved == 0.0:
        fail(f"{a.name} stub prefill: the t/h/w positions did not change the logits")
    log(f"{a.name}: prefill of 256 vision-patch embeddings with distinct t/h/w positions in {seconds:.2f} s: "
        f"finite logits {tuple(logits.shape)}; text positions move them by up to {moved:.3g}")
    return dict(seconds=seconds, logits_moved_by_positions=moved)


def phase_families() -> dict:
    """Each family of ``FAMILIES`` at full width with seeded random
    weights: served on each KV layout, then its 2-layer slice against the
    CPU plain path (and the VLM's stub prefill); the weights are freed
    before the next family is built."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.serving import BatchingConfig

    out = {}
    for name, layers, layouts in FAMILIES:
        arch = get_arch(name)
        if layers is not None:
            arch = dataclasses.replace(arch, n_layers=layers)
        lm, params = build_model(arch)
        fam = out[name] = dict(n_layers=arch.n_layers, weights_gb=torch.cuda.memory_allocated() / 1e9)
        for layout in layouts:
            batching = BatchingConfig(n_slots=8, max_seq=1024, paged=layout == "paged", page_size=16)
            fam[layout] = _serve_family(lm, params, batching, profile=layers is None)
            fam[layout].update(_family_reference(lm, params, paged=layout == "paged"))
        if arch.modality_stub == "vision_patches":
            fam["vision_prefill"] = _vision_prefill(lm, params)
        del lm, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: deepseek-v2-236b
# ---------------------------------------------------------------------------

# the dense first layer and four MoE layers of the 60: the model's 236B
# parameters do not fit one card; every width stays as published
DSV2_LAYERS = 5
DSV2_FUSED_PATH = ("swiglu_gmm_capacity", "swiglu_gemv")
DSV2_THREE_CALL_PATH = ("gmm_capacity", "expert_gemv")
DSV2_SUFFIX = "_deepseek_v2"  # phase 3's rows at deepseek-v2's shapes


def deepseek_arch():
    """deepseek-v2-236b cut to ``DSV2_LAYERS`` layers, on the Sieve dual
    path (``expert_exec="dual_path_cost"``; the config ships ``"dense"``)."""
    from repro_torch.configs import get_arch

    arch = get_arch("deepseek-v2-236b")
    return dataclasses.replace(arch, n_layers=DSV2_LAYERS,
                               moe=dataclasses.replace(arch.moe, expert_exec="dual_path_cost"))


def _mla_decode_ms(lm, params, n: int = 10) -> float:
    """Device time of one full-batch decode step's MLA attention: the
    ``mla_decode`` of every layer (the dense prefix's and the MoE
    blocks'), on 8 slots of 1024 positions filled with seeded values and
    live lengths of 256-544, captured as one CUDA graph and timed by CUDA
    events around ``n`` replays."""
    import numpy as np
    import torch

    from repro_torch.models import attention

    arch = lm.arch
    gen = torch.Generator(device="cuda").manual_seed(11)
    cache = lm.init_cache(8, 1024)
    for leaves in cache.values():
        for leaf in leaves:
            leaf.normal_(generator=gen)
    layers = [(blk["attn"], cache["prefix"], i) for i, blk in enumerate(params.get("prefix_blocks", []))]
    layers += [(blk["attn"], cache["blocks"], i) for i, blk in enumerate(params["blocks"])]
    x = torch.randn((8, 1, arch.d_model), generator=gen, device="cuda").to(lm.dtype)
    position = torch.as_tensor(np.random.default_rng(12).integers(255, 544, 8), dtype=torch.int32,
                               device="cuda")

    def step():
        return [attention.mla_decode(p, x, position, c[0][i], c[1][i], arch.attn) for p, c, i in layers]

    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph, cache
    return e0.elapsed_time(e1) / n


def phase_deepseek() -> dict:
    """deepseek-v2-236b at full width, cut to its dense first layer and
    four MoE layers, served with MLA on the dense cache as phase 4 serves
    qwen3-moe, fused and then three-call, each run with its checks,
    profile and 2-layer slice against the CPU plain path; MLA decode's
    share of a replayed step's device time; and eager against replayed
    engines of both paths in turns.  (Phase 3 holds and times its four
    MoE kernels at its shapes.)"""
    import torch

    from repro_torch.serving import BatchingConfig

    arch = deepseek_arch()
    m = arch.attn.mla
    log(f"deepseek-v2: {arch.n_layers} of 60 layers (the dense first layer, d_ff {arch.d_ff}, and "
        f"{arch.n_layers - arch.moe.first_k_dense} MoE layers), full width: d_model {arch.d_model}, "
        f"{arch.attn.n_heads} MLA heads (kv_lora {m.kv_lora_rank}, rope {m.qk_rope_dim}, q_lora "
        f"{m.q_lora_rank}), {arch.moe.n_experts} experts top-{arch.moe.top_k} of d_expert "
        f"{arch.moe.d_expert}, {arch.moe.n_shared} shared, vocab {arch.vocab_size}; bf16 random weights "
        f"from seed 0; expert_exec {arch.moe.expert_exec} (the config ships dense); 8 slots of 1024 "
        "positions, dense KV cache (MLA has no paged layout)")
    lm, params = build_model(arch)
    out = {"weights_gb": torch.cuda.memory_allocated() / 1e9}
    batching = BatchingConfig(n_slots=8, max_seq=1024)
    for run, fused, path in (("fused", "1", DSV2_FUSED_PATH), ("three_call", "0", DSV2_THREE_CALL_PATH)):
        with fused_swiglu(fused):
            out[run] = phase_serve(lm, params, batching, path, run=f"deepseek-v2 {run}",
                                   keep_counts=run == "fused")
            out[run].update(phase_reference(lm, params, paged=False, run=f"deepseek-v2 {run}"))
    # phase 8's policies and on-device split at 160 experts
    out["policies"] = phase_policies(out["fused"], arch.moe, "deepseek-v2")
    out["mla_decode_ms"] = _mla_decode_ms(lm, params)
    for run in ("fused", "three_call"):
        graph_ms = out[run]["profile"]["replay"]["graph_span_ms"]
        out[run]["mla_decode_share"] = out["mla_decode_ms"] / graph_ms
        log(f"deepseek-v2 {run}: MLA decode {out['mla_decode_ms']:.3f} ms of the replayed step's "
            f"{graph_ms:.3f} ms graph, share {out[run]['mla_decode_share']:.3f}")
    out["in_turns"] = phase_ab(lm, params, paths={"fused": (batching, "1"), "three_call": (batching, "0")})
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="the parent commit's kernels/csrc directory: time its dense, split-KV and "
                         "paged decode attention in turns beside the new ones (phase 3)")
    args = ap.parse_args()
    card = phase_device()
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.configs import get_arch

    from repro_torch.serving import BatchingConfig

    arch = get_arch("qwen3-moe-30b-a3b")
    build_info = phase_build()
    parent = load_parent(args.parent_csrc) if args.parent_csrc else None
    kernels = phase_kernels(arch, parent)
    # the four MoE kernels again at deepseek-v2's shapes (phase 7's model)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kernels.update(phase_moe_kernels(deepseek_arch(), gen, DSV2_SUFFIX))
    kernels.update(phase_kernel_instances(arch))
    held = phase_family_shapes()
    lm, params = build_model(arch)
    serve = {}
    with fused_swiglu("1"):
        dense = BatchingConfig(n_slots=8, max_seq=1024)
        serve["dense"] = phase_serve(lm, params, dense, DENSE_FUSED_PATH, keep_counts=True)
        serve["dense"].update(phase_reference(lm, params, paged=False))
        serve["dense"]["runtime"] = phase_runtime(lm, params, dense, DENSE_FUSED_PATH, kernels)
        # phase 8 on qwen3's weights, before phase 6 frees them
        serve["policies"] = phase_policies(serve["dense"], arch.moe, "qwen3-moe")
        serve["dual_threshold"] = phase_dual_threshold(lm, params, dense, serve["dense"])
        serve["chaos"] = phase_chaos(lm, params, dense)
    with fused_swiglu("0"):
        paged = BatchingConfig(n_slots=8, max_seq=1024, paged=True, page_size=16)
        serve["paged"] = phase_serve(lm, params, paged, PAGED_UNFUSED_PATH)
        serve["paged"].update(phase_reference(lm, params, paged=True))
        serve["paged"]["runtime"] = phase_runtime(lm, params, paged, PAGED_UNFUSED_PATH, kernels)
    serve["in_turns"] = phase_ab(lm, params)
    # qwen3's 61.2 GB of weights go before any other model is built
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"qwen3-moe weights freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    families = phase_families()
    deepseek = phase_deepseek()

    # each kernel's launches come from the run of its own path
    launches = {k: serve["dense"]["launches"][k] for k in DENSE_FUSED_PATH}
    launches.update({k: serve["paged"]["launches"][k] for k in PAGED_UNFUSED_PATH})
    granite = families["granite-3-2b"]
    launches["decode_attention_dh64"] = granite["dense"]["launches"]["decode_attention"]
    launches["decode_attention_paged_dh64"] = granite["paged"]["launches"]["decode_attention_paged"]
    launches.update({f"{k}{DSV2_SUFFIX}": deepseek["fused"]["launches"][k] for k in DSV2_FUSED_PATH})
    launches.update({f"{k}{DSV2_SUFFIX}": deepseek["three_call"]["launches"][k] for k in DSV2_THREE_CALL_PATH})
    for name, r in kernels.items():
        if "path_launches" in r:
            launches[name] = r["path_launches"]
    rows = []
    for name, r in kernels.items():
        source, replaces = SOURCES[r.get("kernel", name)]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    kind = torch.cuda.get_device_name(0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, device=kind, build=build_info, kernels=kernels, held=held, serve=serve, families=families,
        deepseek=deepseek,
    ), indent=1, default=str))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
