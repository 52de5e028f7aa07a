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
   table cells outside the pool).  The six kernels that leave counters
   for the next launch (the fused head and tail, dense, split-KV and paged
   decode attention, the grouped GEMM) run each case three times on the
   same buffers, each launch against the plain version and all three
   bitwise equal.  A ``torch.profiler`` trace of one head call, and of one
   tail call, must hold one kernel.  It times kernel, plain version and one PyTorch library call
   with CUDA events (median and min-max of 20 launches; the head at its
   prefill shape too), and each wrapper's host time per call.  The split-KV
   kernel has no model caller: its path is its entry point, driven once
   per layer of a decode step with the counts zeroed.  Then the rows
   beyond qwen3-moe's shapes, each held and timed the same way: dense,
   split-KV and paged attention at granite-3-2b's decode shape (the dh-64
   instance), at zamba2-7b's shared-attention shape (the dh-112
   instance; its split-KV and paged rows on their entry points) and with
   a 32-head query group at dh 128 (on its entry points), the dense
   kernel at whisper-base's decoder shape (dh 64, 8 heads on 8 kv heads,
   4 slots of 448), ``gmm_ragged`` at the decode gate call's routing, and the four MoE
   kernels (fused head and tail, grouped matmul, expert GEMV) again at
   deepseek-v2-236b's shapes (160 experts top-6, d_model 5120, d_expert
   1536; phase 7's model); the rows without a
   model caller are driven as one decode step would drive them.  The
   attention kernels are also held (not timed) at the decode shape of each
   family that phase 6 serves, on each KV layout it is served on.  With
   ``--parent-csrc DIR`` (the parent commit's
   ``src/repro_torch/kernels/csrc``, unpacked) it also builds the parent's
   dense, split-KV and paged attention, fused tail and grouped matmul, times
   them in turns beside the new ones on the same inputs (the tail at
   qwen3-moe's, deepseek-v2's and, in phase 9, the all-to-all layout's
   decode shape; the grouped matmul's gate call at both models' shapes and
   its ragged layout), and requires the attention outputs at dh 128 and
   every grouped-matmul case of the capacity layout to equal the parent's
   bit for bit;
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
   scenario with tests/test_faults.py's checks;
10. the hybrid, ssm and audio families, after phase 7 frees deepseek-v2:
   zamba2-7b (81 blocks: 13 segments of the shared attention block and 5
   Mamba2 blocks, and a 3-block tail), rwkv6-7b (32 blocks) and
   whisper-base (6 encoder and 6 decoder layers) at full width and depth,
   bf16 weights from ``LM.init(seed=0)``, each freed before the next is
   built.  Each prefills 4 prompts (256 tokens; whisper 64 tokens over
   1500 seeded stub frames) into a decode cache and decodes 32 greedy
   steps eagerly, with the launch counts zeroed before the prefill: every
   token in the vocabulary and every logit finite, and exactly 13
   (zamba2) and 6 (whisper) decode-attention launches a step and no other
   kernel (rwkv6: none, as no Pallas kernel covers RWKV6 in the
   reference).  It prints the weight bytes, the peak allocated, the
   prefill time, the decode step (median and min-max) and tokens/s beside
   the weight-read bound (weights, and whisper's cross K/V, at 3.35 TB/s),
   and a profile of 4 more steps.  Then prefill against step-by-step
   decode over 32 tokens at full depth (the bf16 rule of
   ``_recurrent_consistency``), and a 2-block slice on the card against the
   CPU plain path by the phase-4 rule;
11. training, after phase 7 frees deepseek-v2 (before phase 10):
   (a) qwen3-moe-30b-a3b at full width, cut to 4 of 48 layers, its
   experts dense (the dual modes' kernels have no backward), bf16 from
   ``LM.init(seed=0)``, per-block remat, trains 12 steps of
   ``make_train_step`` (AdamW, 2 warmup steps) on ``SyntheticLM`` batches
   of 4 x 1024 tokens: every loss finite, the last 4 steps' mean below
   step 1's, no kernel of the port launched (the launch counts and a
   profile of step 2); it prints the step time (median and min-max of
   steps 3-12), tokens/s, the model-FLOPs share (6 x active parameters x
   tokens over 989 TFLOP/s), the peak allocated memory against the
   prediction and the top device ops.  (b) One layer at full width in
   float32, 1 x 64 tokens: the loss and every gradient leaf on the card
   against the CPU (cosine >= 0.9999 and max |err| <= 1e-3 of the
   leaf's max |grad|).  (c) ``dual_path_cost`` under autograd on the card
   raises before any kernel launches; without gradients it launches the
   kernels.  (d) examples/train_moe.py's MoE (float32, 2 microbatches)
   through ``FaultTolerantDriver`` for 40 steps, asynchronous checkpoints
   every 10 into a temporary directory, a failure injected at step 25:
   one restart, from step 20, the restored state bitwise equal to the
   step-20 checkpoint by sha256, all 40 steps done.  (e) The hybrid, ssm
   and audio families at full width, bf16, per-block remat, 5 steps of
   ``make_train_step`` each (AdamW lr 3e-5, 2 warmup steps) on
   ``SyntheticLM`` batches: zamba2-7b cut to 12 of 81 blocks (two segments
   of the shared attention block, whose gradient sums both applications,
   and 5 Mamba2 blocks; 2 x 1024 tokens), rwkv6-7b to 2 of 32 blocks (2 x
   512, the WKV chunks recomputed in the backward pass) and whisper-base
   whole (4 x 448 decoder tokens over 1500 stub frames): the step time,
   its split into loss and gradients and AdamW, tokens/s, the model-FLOPs
   share, the peak allocated memory against the prediction, the mean loss
   of the last 2 steps below step 1's, no kernel launched.  (f) One block
   of each at full width in float32 (zamba2's shared attention block and
   one Mamba2 block, one rwkv6 block, whisper's first encoder and decoder
   layer over 1500 frames) by (b)'s rule;
9. expert parallelism, last, once every other model is freed: the fused
   head and tail at the all-to-all layout's decode shape (128 segments
   sharing 16 experts' weights through ``rhs_of_group``) held and timed as
   phase 3's rows; one process's eager decode step at 12 layers; then
   qwen3-moe at full width, cut to 12 of 48 layers, as a (1, 8) mesh of
   eight ranks spawned by ``repro_torch.launch.mesh.run_on_mesh`` (on one
   card all share ``cuda:0`` on gloo; with eight cards each has its own on
   NCCL), 16 experts a rank, decode sequence-parallel over 128 of the 1024
   positions a rank.  Each rank draws its own experts keyed from seed 0 and
   runs 8 prompts of 128-512 tokens and 16 greedy decode steps four ways
   (replicated dispatch fused and three-call, all-to-all fused, and fused
   from an empty int8 KV cache), each with its launch counters zeroed just
   before: every token valid, on every rank and step the head's and tail's
   rows and the drops adding up to the assignments routed to its experts,
   only the path's kernels launched, and the counts equal on every rank
   and adding up to tokens x top-k per layer.  A 2-layer slice as the mesh
   and as one process on the card agree within the bf16 tolerance with
   exact counts on both bodies, and the sequence-parallel attention from
   an int8 cache stays within the reference's relative 0.03 of a bf16
   cache.  Each rank's MoE and collective time per step print beside the
   one-process step (timings, not checks), and a rank's weight bytes by
   group (experts, attention, embedding and logits, the rest): the (1, 8)
   ranks split the vocabulary (tensor parallelism where it divides; 4 kv
   heads do not divide 8).  Then tensor parallelism: a second
   ``run_on_mesh`` of eight ranks as a (2, 4) mesh, the 8 slots split over
   2 data rows, attention split by heads (8 heads on one kv head a rank,
   the dense decode-attention kernel at that shape: its row
   ``decode_attention_tp_g8`` is held and timed as phase 3's rows before
   the runs), the vocabulary 4 ways: qwen3 at the same 12 layers,
   replicated dispatch fused, 8 prompts (each prefilled by both data rows)
   and 6 greedy decode steps with the same checks, the drops and rows
   summed over the data rows; the 2-layer qwen3
   slice and a full-width 2-layer deepseek-v2 slice (the dense prefix
   block and one MoE layer: 128 MLA heads, d_ff 12288 and the two shared
   experts split 4 ways, 40 experts a rank) each held against one process
   by the rule of the (1, 8) slice, whose first layer's exact routing
   applies only where both sides route the same inputs.  Last, on the same
   ranks, the hybrid, ssm and audio families tensor-parallel, their heads
   (attention, Mamba2, RWKV6, cross-attention), FFNs and vocabulary split
   4 ways: zamba2-7b one segment (the shared attention block and 5 Mamba2
   blocks), rwkv6-7b 2 blocks, whisper-base whole, each drawn keyed on the
   mesh; global rank 0 first runs the same slice as one process on the
   card and sends its greedy tokens, then 4 prompts of 64 tokens (whisper's
   over 1500 frames, 2 a data row) are prefilled and decoded ``TP_STEPS``
   steps fed those tokens, the counts zeroed before the prefill: every
   step's logits held against the one process's by the phase-4 rule, one
   decode-attention launch per attention block and step (rows
   ``decode_attention_tp_dh112`` and ``decode_attention_tp_dh64``, held
   and timed as phase 3's rows before the runs), a rank's weights by
   group.  Then, the families freed, the same ranks train qwen3-moe at
   full width on the (2, 4) mesh (``_tp_train``), cut to 1 layer for time
   and for eight ranks' memory on one card: first one float32 layer's
   gradients of a global batch of 4 x 512 tokens, on global rank 0 held
   against the mean of one process's gradients over the two data rows'
   halves (the reference's mesh semantics, aux loss included) by the
   phase-4 rule, leaf by leaf; then ``MESH_TRAIN_STEPS`` steps of
   ``make_train_step`` in bf16 with remat, int8 compression and AdamW on
   that batch: the loss finite and falling, no kernel launched, the
   replicated leaves bitwise equal across the model ranks and every leaf
   across the data ranks (position-weighted digests of the bits), and the
   step's host-clock split (loss and gradients, the data-parallel reduce,
   clip with compression, AdamW, the collectives' share).

It logs the elapsed seconds at the end of each group of phases and a
sha256 of the tokens of every one-process run (``tokens <run>`` lines;
phase 11: its losses), and prints the kernel table as one JSON line, the ``nvidia-smi`` line, and
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


# sha256 of what each one-process run generated (its requests' tokens, or
# phase 11's losses), by run in the order the runs end: logged as
# ``tokens <run>: sha256 ...`` and kept in chip_smoke.json, so the runs of
# two trees can be held token for token
TOKEN_DIGESTS: dict = {}


def note_tokens(run: str, values) -> None:
    """Log and keep the sha256 of ``values`` (nested lists, arrays or
    tensors of token ids, or floats, written exactly) under ``run``; a
    run's second record takes the key ``<run> #2``."""
    import hashlib

    key, n = run, 2
    while key in TOKEN_DIGESTS:
        key, n = f"{run} #{n}", n + 1
    text = json.dumps(values, default=lambda o: o.tolist())
    TOKEN_DIGESTS[key] = hashlib.sha256(text.encode()).hexdigest()[:16]
    log(f"tokens {key}: sha256 {TOKEN_DIGESTS[key]}")


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
    """The parent commit's kernels that a later PR redesigned, built from
    its ``csrc`` directory (an unpacked ``git archive`` of the parent) with
    the port's nvcc flags into a temporary directory: the dense, split-KV
    and paged decode attention under their C interface as of commit
    91c1063 (launch functions by kernel name, plus the split count of
    each), and the fused SwiGLU tail and the grouped matmul (capacity and
    ragged layouts) under theirs as of c3c6f28, bound as callables on CUDA
    tensors: ``swiglu_gemv(tokens, wg, wu, wd, expert_ids, valid)``,
    ``gmm_capacity(buf, rhs, group_sizes, rhs_of_group)`` and
    ``gmm_ragged(lhs, rhs, group_sizes, bm)``."""
    import ctypes
    import tempfile

    import torch

    from repro_torch.kernels import build

    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    IP, LLP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
    argtypes = {
        # q, k, v, lengths, part, lse, tickets, out, B, T, Kv, G, dh, scale, stream
        "decode_attention": [P] * 8 + [I] * 5 + [F, P],
        "decode_attention_split": [P] * 8 + [I] * 5 + [F, P],
        # q, pool_k, pool_v, tables, lengths, part, lse, tickets, out, B, n_pool,
        # page, Kv, G, dh, max_blocks, scale, stream
        "decode_attention_paged": [P] * 9 + [I] * 7 + [F, P],
        # tok, tok_stride, wg, wu, wd, expert_ids, valid, partial, out, S, K, F, N, stream
        "fused_swiglu_gemv": [P, LL] + [P] * 7 + [I] * 4 + [P],
        # x, rhs, group_sizes, rhs_of_group, out, part, tickets, G, C, K, N, E, n_blocks, stream
        "grouped_gemm": [P] * 7 + [I] * 6 + [P],
    }
    tmp = tempfile.TemporaryDirectory(prefix="parent_kernels_")
    procs = {
        name: subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", f"{tmp.name}/{name}.so", str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in argtypes
    }
    fns, libs = {"_tmp": tmp}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"parent {name} did not build:\n{out}")
        lib = libs[name] = ctypes.CDLL(f"{tmp.name}/{name}.so")
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes[name], ctypes.c_int
        fns[name] = fn
        if name.startswith("decode_attention"):
            lib.decode_attention_splits.argtypes, lib.decode_attention_splits.restype = [I], ctypes.c_int
            fns[f"{name}_splits"] = lib.decode_attention_splits

    tail, gg = libs["fused_swiglu_gemv"], libs["grouped_gemm"]
    tail.fused_swiglu_gemv_init.argtypes, tail.fused_swiglu_gemv_init.restype = [IP], ctypes.c_int
    gg.grouped_gemm_init.argtypes, gg.grouped_gemm_init.restype = [IP, IP], ctypes.c_int
    gg.grouped_gemm_scratch.argtypes = [I] * 5 + [LLP, LLP, IP]
    gg.grouped_gemm_scratch.restype = None
    # lhs, rhs, group_sizes, out, M, K, N, E, bm, stream
    gg.gmm_ragged.argtypes, gg.gmm_ragged.restype = [P] * 4 + [I] * 5 + [P], ctypes.c_int
    state = {}

    def init():
        if not state:
            smem, n_sm = ctypes.c_int(), ctypes.c_int()
            if tail.fused_swiglu_gemv_init(ctypes.byref(smem)) or \
                    gg.grouped_gemm_init(ctypes.byref(n_sm), ctypes.byref(smem)):
                fail("parent kernel init failed")
            state["n_sm"] = n_sm.value
        return torch.cuda.current_stream().cuda_stream

    def swiglu_gemv(toks, wg, wu, wd, eids, valid):
        stream = init()
        S, K = toks.shape
        Fd, N = wd.shape[1], wd.shape[2]
        partial = torch.empty((Fd // 64, S, N), dtype=torch.float32, device=toks.device)
        out = torch.empty((S, N), dtype=toks.dtype, device=toks.device)
        rc = fns["fused_swiglu_gemv"](toks.data_ptr(), toks.stride(0), wg.data_ptr(), wu.data_ptr(),
                                      wd.data_ptr(), eids.data_ptr(), valid.data_ptr(), partial.data_ptr(),
                                      out.data_ptr(), S, K, Fd, N, stream)
        if rc != 0:
            fail(f"parent fused_swiglu_gemv failed to launch ({rc})")
        return out

    def gmm_capacity(buf, rhs, gs, rog=None):
        stream = init()
        G, C, K = buf.shape
        E, _, N = rhs.shape
        key = ("gmm", G, C, K, N)
        if key not in state:
            pf, nt, sm = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
            gg.grouped_gemm_scratch(G, C, K, N, state["n_sm"], ctypes.byref(pf), ctypes.byref(nt),
                                    ctypes.byref(sm))
            state[key] = (torch.empty((pf.value,), dtype=torch.float32, device=buf.device),
                          torch.zeros((nt.value,), dtype=torch.int32, device=buf.device))
        part, tickets = state[key]
        out = torch.empty((G, C, N), dtype=buf.dtype, device=buf.device)
        rc = fns["grouped_gemm"](buf.data_ptr(), rhs.data_ptr(), gs.data_ptr(),
                                 None if rog is None else rog.data_ptr(), out.data_ptr(), part.data_ptr(),
                                 tickets.data_ptr(), G, C, K, N, E, state["n_sm"], stream)
        if rc != 0:
            fail(f"parent grouped_gemm failed to launch ({rc})")
        return out

    def gmm_ragged(lhs, rhs, gs, bm):
        stream = init()
        M, K = lhs.shape
        E, _, N = rhs.shape
        out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
        rc = gg.gmm_ragged(lhs.data_ptr(), rhs.data_ptr(), gs.data_ptr(), out.data_ptr(), M, K, N, E, bm,
                           stream)
        if rc != 0:
            fail(f"parent gmm_ragged failed to launch ({rc})")
        return out

    fns.update(swiglu_gemv=swiglu_gemv, gmm_capacity=gmm_capacity, gmm_ragged=gmm_ragged)
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


def phase_moe_kernels(arch, gen, suffix: str = "", parent=None) -> dict:
    """The four MoE kernels (the fused head and tail, the grouped matmul
    and the expert GEMV) against their plain versions at ``arch``'s widths
    and expert count, then timed: a decode step's routing of 8 tokens,
    capacity ``C`` at 8 tokens, and the head and the grouped matmul's down
    call at a 512-token prefill's capacity too.  Rows are named
    ``<kernel><suffix>``.  ``parent`` (``load_parent``): the parent
    commit's tail and grouped matmul, timed in turns beside the new ones
    at the decode shape, and the grouped matmul's every case held equal to
    the parent's bit for bit."""
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
    # persistent, one launch: each case three launches on the same buffers
    # (group tickets back at zero after each) with bitwise-equal outputs
    S = E  # E * tau rows, tau = 1
    eids = torch.arange(E, dtype=torch.int32, device=dev)
    valid_np = (counts == 1).astype(np.int32)
    shared = torch.as_tensor(np.random.default_rng(8).integers(0, 8, S), dtype=torch.int32, device=dev)
    errs = []
    for what, v, ids in (("decode tail", valid_np, eids), ("all dead", np.zeros(S, np.int32), eids),
                         ("all live", np.ones(S, np.int32), eids),
                         ("rows sharing 8 experts, unsorted", valid_np, shared)):
        toks = rnd((S, K))
        valid = torch.as_tensor(v, device=dev)
        want = ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, ids, valid)
        errs.append(_repeat_compare(f"swiglu_gemv {what}", lambda: ops.swiglu_gemv(toks, wg, wu, wd, ids, valid),
                                    want, zero_rows=valid == 0))
    # strided rows, as the tail path passes buf[:, :1]
    slab = rnd((E, C_dec, K))
    valid = torch.as_tensor(valid_np, device=dev)
    got = ops.swiglu_gemv(slab[:, :1].reshape(E, K), wg, wu, wd, eids, valid)
    want = ref.fused_swiglu_gemv_ref(slab[:, 0].contiguous(), wg, wu, wd, eids, valid)
    errs.append(_compare("swiglu_gemv strided", got, want, zero_rows=valid == 0))
    toks = rnd((S, K))
    n_valid = int(valid_np.sum())
    tail_kernels = _kernels_per_call(lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid))
    if len(tail_kernels) != 1 or not tail_kernels[0].startswith("fused_swiglu_gemv_kernel"):
        fail(f"one swiglu_gemv call ran the kernels {tail_kernels}, not one fused kernel")

    def library_tail():
        h = F.silu(torch.bmm(toks[:, None], wg)) * torch.bmm(toks[:, None], wu)
        return torch.bmm(h, wd)[:, 0] * valid[:, None]

    tail_bytes = n_valid * (3 * K * Fd * 2 + K * 2) + S * N * 2 + S * 8
    results["swiglu_gemv"] = dict(
        max_abs_err=max(errs),
        host_us=host_us(lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid)),
        kernels_per_call=tail_kernels,
        clean_l2_ms=spread(time_samples(lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid),
                                        flush_by="read")),
        read_floor_ms=_read_floor(tail_bytes),
        **timings(ms=lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid),
                  plain_ms=lambda: ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, eids, valid),
                  library_ms=library_tail),
        bytes=tail_bytes,
        flops=2 * n_valid * 3 * K * Fd,
        shape=f"tokens ({S},{K}), {n_valid} valid rows",
    )
    if parent is not None:
        results["swiglu_gemv"]["parent"] = dict(decode=in_turns(
            lambda: parent["swiglu_gemv"](toks, wg, wu, wd, eids, valid),
            lambda: ops.swiglu_gemv(toks, wg, wu, wd, eids, valid)))

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
        # the capacity layout keeps the parent's main loop, split and K order
        if parent is not None and not torch.equal(parent["gmm_capacity"](buf, w, gs, rhs_of_group),
                                                  ops.gmm_capacity(buf, w, gs, rhs_of_group)):
            fail(f"gmm_capacity{suffix} C={C}, {int((sizes > 0).sum())} live groups: "
                 "not bitwise equal to the parent's")
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
    if parent is not None:
        results["gmm_capacity"]["parent"] = dict(
            gate=in_turns(lambda: parent["gmm_capacity"](buf, wg, gs), lambda: ops.gmm_capacity(buf, wg, gs)),
            bitwise_equal=True)

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
    r = results["swiglu_gemv"]
    log(f"kernel swiglu_gemv{suffix}: kernels per call {r['kernels_per_call']}; with the L2 flushed by a read "
        f"{r['clean_l2_ms']['median']:.4f} ms; a plain read of its bound's bytes (torch.amax) "
        f"{r['read_floor_ms']['median']:.4f} ms")
    for name, r in results.items():
        _log_turns(f"{name}{suffix}", r)
    torch.cuda.empty_cache()
    return {f"{name}{suffix}": dict(r, kernel=name) for name, r in results.items()}


def phase_kernels(arch, parent=None) -> dict:
    """Every kernel against its plain version, then timed.  ``parent``
    (``load_parent``): the parent commit's attention, tail and grouped
    matmul, timed in turns beside the new ones at the same inputs."""
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

    moe_rows = phase_moe_kernels(arch, gen, parent=parent)
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
        _log_turns(name, r)
    torch.cuda.empty_cache()
    return {**moe_rows, **results}


def _read_floor(n_bytes: int) -> dict:
    """The device time of a plain read of ``n_bytes``: one ``torch.amax``
    over a contiguous bf16 buffer of that size, timed as the kernels are
    (median and min-max of 20, 1 GiB zeroed before each).  A kernel that
    must read that many bytes under the same flush is measured against it
    as well as against its bound."""
    import torch

    buf = torch.ones((n_bytes // 2,), dtype=torch.bfloat16, device="cuda")
    out = spread(time_samples(lambda: buf.amax()))
    del buf
    return out


def _log_turns(name: str, r: dict) -> None:
    """One line per parent comparison of a row: the parent's and the new
    kernel's median and min-max in turns, and their ratio."""
    for shape, t in r.get("parent", {}).items():
        if isinstance(t, dict) and "parent" in t:
            log(f"in turns, {name} {shape}: parent {t['parent']['median']:.4f} ms "
                f"({t['parent']['min']:.4f}-{t['parent']['max']:.4f}), new {t['new']['median']:.4f} ms "
                f"({t['new']['min']:.4f}-{t['new']['max']:.4f}), new/parent {t['new_over_parent']:.3f}")


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
                        timed: bool = True, T: int = 1024, serving=None) -> dict:
    """Rows of the attention kernels at one head dim and group size over
    ``B`` slots of ``T`` positions: each of ``kinds`` ("dense", "split",
    "paged") held against its plain version at the serving lengths (seeded
    in (T/8, T/2 + 32], or ``serving``) and at edge lengths (three
    launches on the same buffers, bitwise equal, exact zeros on length-0
    rows), then timed beside the plain version and SDPA (over the gathered
    pool for paged).  ``timed=False``: held only, each kernel's row its
    largest error."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    G, page = H // Kv, 16
    max_blocks = -(-T // page)
    n_pool = B * max_blocks + 1

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rng = np.random.default_rng(seed)
    serving = rng.integers(T // 8 + 1, T // 2 + 33, B) if serving is None else np.asarray(serving)
    edges = np.r_[0, 1, 63, 64, 65, T, T - 1, min(500, T)][:B]
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


def _ragged_row(arch, parent=None) -> dict:
    """gmm_ragged at the decode gate call's routing (the head split of
    ``_decode_routing``: groups of two or more rows, bm 8), held against
    its plain version (three launches bitwise, exact zeros on padding rows;
    plus a prefill-like case with bm 128 and rows past the spans) and
    timed beside the plain version and ``torch._grouped_mm`` where it runs,
    and in turns beside the parent's kernel (``parent``)."""
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
    row["read_floor_ms"] = _read_floor(row["bytes"])
    log(f"kernel gmm_ragged: a plain read of its bound's bytes (torch.amax) {row['read_floor_ms']['median']:.4f} ms")
    if parent is not None:
        pl_sizes = np.random.default_rng(5).integers(0, 41, E) * 3  # the prefill-like case: bm 128
        pl_lhs, pl_gs, _, _ = case(pl_sizes, 128)
        row["parent"] = dict(
            decode=in_turns(lambda: parent["gmm_ragged"](lhs, rhs, gs, 8), lambda: ops.gmm_ragged(lhs, rhs, gs, 8)),
            prefill_like=in_turns(lambda: parent["gmm_ragged"](pl_lhs, rhs, pl_gs, 128),
                                  lambda: ops.gmm_ragged(pl_lhs, rhs, pl_gs, 128)))
    return {"gmm_ragged": row}


def phase_kernel_instances(arch, parent=None) -> dict:
    """Phase 3's rows beyond the qwen3-moe path's kernels: the attention
    kernels (dense, split-KV, paged) at granite-3-2b's decode shape (dh
    64, 4 query heads per kv head), at zamba2-7b's shared-attention shape
    (the dh-112 instance, 32 heads on 32 kv heads) and with a 32-head
    group at dh 128 (two head groups of the grid), the dense kernel at
    whisper-base's decode shape (dh 64, 8 heads on 8 kv heads), and
    gmm_ragged.  The rows with no model caller are then driven as one
    decode step would drive them, counts zeroed just before."""
    import numpy as np
    import torch

    rows = {}
    rows.update(_attention_instance("dh64", 8, 32, 8, 64, ("dense", "split", "paged"), seed=64))
    rows.update(_attention_instance("dh112", 8, 32, 32, 112, ("dense", "split", "paged"), seed=112))
    rows.update(_attention_instance("g32", 8, 32, 1, 128, ("dense", "split", "paged"), seed=32))
    # whisper-base's decoder self-attention (phase 10): 4 slots of its 448
    # learned positions, at the lengths of the middle of phase 10's decode
    rows.update(_attention_instance(WHISPER_ROW, 4, 8, 8, 64, ("dense",), seed=164, T=448,
                                    serving=np.full(4, 64 + RECURRENT_STEPS // 2)))
    rows.update(_ragged_row(arch, parent))
    # (row, launches of one decode step): the split-KV kernel per layer of
    # granite-3-2b (40), zamba2-7b's 13 shared-attention applications
    # (the dense kernel's launches come from phase 10's zamba2 run), the
    # 32-head group per layer of granite-3-8b (40, its width: 32 heads of
    # 128), gmm_ragged per layer of qwen3-moe (48)
    for name, n, counter in (("decode_attention_split_dh64", 40, "decode_attention_split"),
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
        _log_turns(name, r)
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

        def head_stage(slab, wg, wu, wd, sizes, rhs_of_group=None):
            rows[self.slot, 0] += sizes.sum()
            rows[self.slot, 2] += (sizes > 0).sum()
            return head(slab, wg, wu, wd, sizes, rhs_of_group)

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
    note_tokens(f"{arch.name} {run}", [r.generated for r in reqs])
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
        note_tokens(f"in turns {name}", tokens[(name, "replay")])
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


def _logit_distance(got, want, vocab: int):
    """(max |err|, the largest |logit| of ``want``, cosine) of two logit
    tensors over the vocabulary; non-finite logits fail the run."""
    import torch

    g, w = got.float().cpu()[..., :vocab], want.float().cpu()[..., :vocab]
    if not torch.isfinite(g).all() or not torch.isfinite(w).all():
        fail("logits are not finite")
    cos = float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0))
    return float((g - w).abs().max()), float(w.abs().max()), cos


def _hold_logits(run: str, stage: str, got, want, vocab: int) -> dict:
    """The phase-4 rule on bf16 logits of two computations of one function:
    max |err| at most 5% of the largest logit, cosine at least 0.999."""
    err, scale, cos = _logit_distance(got, want, vocab)
    log(f"{run} {stage}: max |err| {err:.4g} (max |logit| {scale:.3g}, relative {err / scale:.4g}), "
        f"cosine {cos:.6f}")
    if err > 5e-2 * scale or cos < 0.999:
        fail(f"{run} {stage}: the logits disagree (max |err| {err:.4g} of {scale:.3g}, cosine {cos:.6f})")
    return {f"{stage}_max_abs_err": err, f"{stage}_rel_err": err / scale, f"{stage}_cosine": cos}


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
    # bf16 through two full-width layers on two devices: the products
    # round at other places, so hold the logits to 5% of their range
    for stage, g, w in zip(("prefill", "decode"), got, want):
        out.update({f"ref_{k}": v for k, v in _hold_logits(
            f"reference {run}: 2-layer logits, card vs CPU plain path", stage, g, w, arch.vocab_size).items()})
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
    prof = _profile_window(eng.step, n_steps)
    del eng._run_sieve
    return dict(plain_step_ms=plain_step_ms, host_sieve_ms=sieve_ms, **prof)


def _profile_window(step, n_steps: int) -> dict:
    """``n_steps`` calls of ``step`` under ``torch.profiler``: the step's
    wall time, the device's busy time and idle share (a busy time above
    the wall time is a counting fault and fails the run), kernels and
    launch calls per step, the top device and host rows and the port's
    own kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
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
    """The port kernel (with its template arguments, nested ones too) that
    a profiler row of a device kernel names, or None for any other kernel."""
    import re

    m = re.search(r"(\w+)(<[^()]*>)?\(", key.replace("(anonymous namespace)::", ""))
    return m.group(1) + (m.group(2) or "") if m and m.group(1) in _port_kernel_names() else None


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_cpu(tree):
    return _tree_map(lambda t: t.cpu(), tree)


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
    note_tokens(what, [r.generated for r in reqs])


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
    note_tokens(f"chaos {scenario}", out["tokens"])
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
    what = f"reference {run}: 2-layer logits{' (vision-patch stub)' if stub is not None else ''}, card vs CPU"
    for stage, g, w in zip(("prefill", "decode"), got, want):
        out.update({f"ref_{k}": v for k, v in _hold_logits(what, stage, g, w, arch.vocab_size).items()})
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
# phase 11: training
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4  # of qwen3-moe's 48
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 12
# the peak allocated memory of the full-width run, predicted from the
# parameter count (PERF.md, section 6) before the first run
TRAIN_PEAK_PREDICTED_GB = (42.0, 50.0)
# card against CPU (b): per gradient leaf
TRAIN_MIN_COSINE, TRAIN_MAX_REL_ERR = 0.9999, 1e-3
DRIVER_STEPS, DRIVER_EVERY, DRIVER_FAIL_AT = 40, 10, 25


def train_arch(n_layers: int = TRAIN_LAYERS, expert_exec: str = "dense"):
    """qwen3-moe-30b-a3b at full width, cut to ``n_layers`` layers, its
    experts run by ``expert_exec`` (the config ships ``dual_path_cost``,
    whose kernels have no backward)."""
    from repro_torch.configs import get_arch

    base = get_arch("qwen3-moe-30b-a3b")
    return dataclasses.replace(base, n_layers=n_layers,
                               moe=dataclasses.replace(base.moe, expert_exec=expert_exec))


def driver_arch():
    """The ~100M-class MoE of examples/train_moe.py:35-44 (8 layers,
    d_model 512, 32 experts top-4)."""
    from repro_torch.configs import AttnConfig, MoEConfig, get_arch

    return dataclasses.replace(
        get_arch("qwen3-moe-30b-a3b"), n_layers=8, d_model=512, vocab_size=8192,
        attn=AttnConfig(kind="gqa", n_heads=8, n_kv_heads=2, d_head=64, rope_theta=1e4),
        moe=MoEConfig(n_experts=32, top_k=4, d_expert=512),
    )


def _active_params(arch, params) -> int:
    """Parameters a token's matmuls touch: every leaf but the embedding
    table (a gather) and, of the routed experts, ``top_k`` of
    ``n_experts``."""
    from repro_torch.train.tree import leaves_with_paths

    n = 0
    for path, t in leaves_with_paths(params):
        if path[0] == "embed":
            continue
        routed = "moe" in path and path[-1] in ("w_gate", "w_up", "w_down") and "shared" not in path
        n += t.numel() * arch.moe.top_k // arch.moe.n_experts if routed else t.numel()
    return n


def _train_full_width(card: str) -> dict:
    """(a): qwen3-moe at full width, 4 layers, bf16, per-block remat,
    ``TRAIN_STEPS`` steps of ``make_train_step`` on ``SyntheticLM``
    batches, the second step profiled; the port's kernels must never
    launch."""
    import numpy as np
    import torch

    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.train_loop import _microbatched_grads
    from repro_torch.train.tree import leaves

    arch = train_arch()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    lm = LM(arch, torch.bfloat16, "cuda", remat=True)
    tc = TrainConfig(opt=AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS))
    params, opt, res = init_train_state(lm, 0, tc)
    n_params = sum(t.numel() for t in leaves(params))
    active = _active_params(arch, params)
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batches = [to_device(data.batch(i), "cuda") for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(lm, tc)
    ops.reset_launches()
    losses, norms, step_ms, prof = [], [], [], None

    def one(i):
        nonlocal params, opt, res
        params, opt, res, m = step(params, opt, batches[i], res)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))

    for i in range(TRAIN_STEPS):
        if i == 1:  # the second step, profiled; steps 3-12 are timed unprofiled
            prof = _profile_window(lambda: one(1), 1)
            continue
        torch.cuda.synchronize()
        t = time.perf_counter()
        one(i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    # one more step, split: loss and gradients, then the AdamW update
    split = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, grads = _microbatched_grads(lm, params, batches[-1], 1)
    torch.cuda.synchronize()
    split["loss_and_grads_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    params, opt, _ = adamw_update(tc.opt, params, grads, opt)
    torch.cuda.synchronize()
    split["adamw_ms"] = 1e3 * (time.perf_counter() - t)
    del grads
    tokens = TRAIN_BATCH * TRAIN_SEQ
    timed = spread(step_ms[1:])  # steps 3-12
    out = dict(
        arch=f"{arch.name} full width, {arch.n_layers} of 48 layers, expert_exec dense, bf16, remat",
        params=n_params, active_params=active, init_s=init_s, losses=losses, grad_norms=norms,
        step_ms=timed, tokens_per_s=tokens / (timed["median"] / 1e3),
        model_flops_share=6 * active * tokens / (timed["median"] / 1e3) / PEAK_BF16_FLOPS,
        peak_gb=peak_gb, base_gb=base_gb, predicted_peak_gb=TRAIN_PEAK_PREDICTED_GB, launches=launched,
        profile=prof, split=split,
    )
    log(f"train (a): {out['arch']}; {n_params / 1e9:.3f} B parameters ({active / 1e6:.0f} M active a "
        f"token), batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW lr {tc.opt.lr} with 2 warmup steps; init {init_s:.1f} s")
    log(f"train (a): step {timed['median']:.1f} ms ({timed['min']:.1f}-{timed['max']:.1f}, steps 3-"
        f"{TRAIN_STEPS}, host clock), {out['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
        f"{out['model_flops_share']:.4f} (6 x active parameters x tokens over {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s); peak allocated {peak_gb:.2f} GB ({base_gb:.2f} GB before), predicted "
        f"{TRAIN_PEAK_PREDICTED_GB[0]:.0f}-{TRAIN_PEAK_PREDICTED_GB[1]:.0f} GB | {card}")
    log("train (a): loss by step " + ", ".join(f"{x:.4f}" for x in losses) + "; grad norm "
        + ", ".join(f"{x:.3f}" for x in norms))
    log(f"train (a) profile of step 2: {prof['step_ms']:.1f} ms with the device busy {prof['device_ms']:.1f} "
        f"ms, idle share {prof['idle_share']:.3f}, {prof['kernels_per_step']} kernels; a 13th step split: "
        f"loss and gradients {split['loss_and_grads_ms']:.1f} ms, AdamW {split['adamw_ms']:.1f} ms (host "
        "clock, synchronized)")
    for key, calls, ms in prof["top_device"]:
        log(f"  device {ms:8.3f} ms/step {calls:6d} calls  {key[:90]}")
    if not all(np.isfinite(losses)):
        fail(f"train (a): a loss is not finite: {losses}")
    note_tokens("train (a) losses", losses)
    if not np.mean(losses[-4:]) < losses[0]:
        fail(f"train (a): the mean loss of the last 4 steps {np.mean(losses[-4:]):.4f} is not below step "
             f"1's {losses[0]:.4f}")
    if prof["port_kernels"] or launched:
        fail(f"train (a): the training path launched the port's CUDA kernels: {prof['port_kernels']} "
             f"{launched}")
    del params, opt, res, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_card_against_cpu(arch=None, what: str = "train (b)", desc: str = "one full-width layer",
                            **lm_kw) -> dict:
    """(b): one layer at full width in float32 (or ``arch``), a batch of 1 x
    64 tokens (whisper: over 1500 stub frames): loss and every gradient
    leaf on the card against the same step on the CPU (TF32 is off, phase
    1)."""
    import numpy as np
    import torch

    from repro_torch.models import LM
    from repro_torch.train.train_loop import _loss_and_grads
    from repro_torch.train.tree import leaves_with_paths, tree_map

    arch = arch or train_arch(n_layers=1)
    card_lm = LM(arch, torch.float32, "cuda", **lm_kw)
    params = tree_map(lambda p: p.requires_grad_(True), card_lm.init(seed=1))
    cpu_params = tree_map(lambda p: p.detach().cpu().requires_grad_(True), params)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, arch.vocab_size, (1, 65)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    if arch.family == "audio":
        batch["embeds"] = LM(arch, torch.float32, "cpu", **lm_kw).stub_inputs(1, arch.enc_seq, seed=1)["embeds"]
    t0 = time.perf_counter()
    loss, metrics, grads = _loss_and_grads(card_lm, params, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_loss, cpu_metrics, cpu_grads = _loss_and_grads(LM(arch, torch.float32, "cpu", **lm_kw), cpu_params, batch)
    cpu_s = time.perf_counter() - t0
    worst_cos, worst_rel, rows = 1.0, 0.0, []
    for (path, g), c in zip(leaves_with_paths(grads), [c for _, c in leaves_with_paths(cpu_grads)]):
        a, b = g.double().flatten(), c.to(g.device).double().flatten()
        scale = float(b.abs().max())
        cos = float(a @ b / (a.norm() * b.norm())) if scale > 0 else float(a.abs().max() == 0)
        rel = float((a - b).abs().max()) / scale if scale > 0 else float(a.abs().max())
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
        rows.append(("/".join(map(str, path)), cos, rel))
    counts_equal = bool(torch.equal(metrics["aux"].counts.cpu(), cpu_metrics["aux"].counts))
    out = dict(loss_card=float(loss), loss_cpu=float(cpu_loss), worst_cosine=worst_cos,
               worst_rel_err=worst_rel, leaves=rows, counts_equal=counts_equal, card_s=card_s, cpu_s=cpu_s)
    log(f"{what}: {desc} in float32, batch 1 x 64: loss card {float(loss):.6f}, CPU "
        f"{float(cpu_loss):.6f}; over {len(rows)} gradient leaves the worst cosine {worst_cos:.7f} (bound "
        f"{TRAIN_MIN_COSINE}) and the worst max |err| / max |grad| {worst_rel:.2e} (bound {TRAIN_MAX_REL_ERR}); "
        f"routing counts equal: {counts_equal}; card {card_s:.1f} s, CPU {cpu_s:.1f} s")
    if abs(float(loss) - float(cpu_loss)) > 1e-4 * abs(float(cpu_loss)):
        fail(f"{what}: the card's loss {float(loss)} differs from the CPU's {float(cpu_loss)}")
    if worst_cos < TRAIN_MIN_COSINE or worst_rel > TRAIN_MAX_REL_ERR:
        bad = [r for r in rows if r[1] < TRAIN_MIN_COSINE or r[2] > TRAIN_MAX_REL_ERR]
        fail(f"{what}: gradient leaves beyond the bounds: {bad}")
    del params, cpu_params, grads, cpu_grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_dual_raises() -> dict:
    """(c): a dual-mode MoE layer under autograd on the card raises before
    any kernel launches; the same forward without gradients runs the
    kernels."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.train.tree import tree_map

    arch = train_arch(n_layers=1, expert_exec="dual_path_cost")
    lm = LM(arch, torch.bfloat16, "cuda")
    params = tree_map(lambda p: p.requires_grad_(True), lm.init(seed=2))
    toks = torch.randint(0, arch.vocab_size, (1, 65), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}
    ops.reset_launches()
    message = None
    try:
        lm.loss(params, batch)[0].backward()
    except RuntimeError as e:
        message = str(e)
    if message is None or "no backward" not in message or any(ops.LAUNCHES.values()):
        fail(f"train (c): loss.backward under dual_path_cost on the card raised {message!r}, after "
             f"launches {ops.LAUNCHES}")
    with torch.no_grad():
        lm.loss(params, batch)
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    if not launched:
        fail("train (c): without gradients the dual path launched no kernel")
    log(f"train (c): under autograd dual_path_cost raised {message[:110]!r}...; without gradients the "
        f"same loss launched {launched}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(message=message, launches_without_grad=launched)


def _train_driver() -> dict:
    """(d): the MoE of examples/train_moe.py (float32, one batch of 8 x
    256 tokens a step) through ``FaultTolerantDriver`` on the card: asynchronous checkpoints
    every ``DRIVER_EVERY`` steps into a temporary directory, a failure
    injected at step ``DRIVER_FAIL_AT``; the state restored after it must
    equal, leaf by leaf, the sha256 that the last checkpoint before it
    recorded when it was saved, and the run must end at ``DRIVER_STEPS``."""
    import tempfile

    import torch

    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.models import LM
    from repro_torch.recovery.codec import sha256_array, to_storable, unpack_state
    from repro_torch.train import (DriverConfig, FaultTolerantDriver, TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.checkpoint import step_dir
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.tree import leaves

    arch = driver_arch()
    lm = LM(arch, torch.float32, "cuda", q_chunk=128, kv_chunk=128)
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=DRIVER_STEPS))
    params, opt, res = init_train_state(lm, 0, tc)
    n_params = sum(t.numel() for t in leaves(params))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=256, global_batch=8))
    batches = {i: to_device(data.batch(i), "cuda") for i in range(DRIVER_STEPS)}
    step = make_train_step(lm, tc)
    resume_at = DRIVER_FAIL_AT // DRIVER_EVERY * DRIVER_EVERY
    restored, losses = [], []

    def step_fn(state, i):
        if drv.restarts and not restored:  # the first step after the restart: the restored state
            restored.extend(sha256_array(to_storable(t)[0]) for t in leaves(state))
        p, o, r, m = step(state["params"], state["opt"], batches[i], state["res"])
        losses.append(float(m["loss"]))
        return {"params": p, "opt": o, "res": r}, {"loss": losses[-1]}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        drv = FaultTolerantDriver(step_fn, DriverConfig(ckpt_dir=ckpt, ckpt_every=DRIVER_EVERY, async_ckpt=True))
        t0 = time.perf_counter()
        _, hist = drv.run({"params": params, "opt": opt, "res": res}, DRIVER_STEPS,
                          inject_failure_at={DRIVER_FAIL_AT: RuntimeError("simulated preemption")})
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        with open(os.path.join(step_dir(ckpt, resume_at), "manifest.json"), "rb") as f:
            manifest = [e["sha256"] for e in unpack_state(f.read())["leaves"]]
        saved = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt) if not n.endswith(".tmp"))
    note_tokens("train (d) losses", losses)
    done = [h["step"] for h in hist if "loss" in h]
    step_s = sum(h["dt"] for h in hist if "loss" in h)
    restarts = [h for h in hist if h.get("event") == "restart"]
    out = dict(arch=f"examples/train_moe.py's MoE: {arch.n_layers} layers, d_model {arch.d_model}, "
                    f"{arch.moe.n_experts} experts top-{arch.moe.top_k}, float32",
               params=n_params, restarts=drv.restarts, steps_done=done, checkpoints=saved, wall_s=wall_s,
               steps_s=step_s, first_loss=losses[0], last_loss=losses[-1],
               restored_equals_checkpoint=restored == manifest)
    log(f"train (d): {out['arch']}, {n_params / 1e6:.1f} M parameters, {DRIVER_STEPS} steps of 8 x 256 "
        f"tokens through FaultTolerantDriver, asynchronous checkpoints every {DRIVER_EVERY} "
        f"steps ({saved}), failure at step {DRIVER_FAIL_AT}: {drv.restarts} restart from step "
        f"{restarts[0]['step'] if restarts else None}, the restored state bitwise equal to the step-"
        f"{resume_at} checkpoint by sha256: {out['restored_equals_checkpoint']}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {wall_s:.1f} s, {step_s:.1f} s of it in the {len(done)} steps (host clock)")
    if drv.restarts != 1 or not restarts or restarts[0]["step"] != resume_at:
        fail(f"train (d): expected one restart from step {resume_at}, got {drv.restarts} ({restarts})")
    if not out["restored_equals_checkpoint"]:
        fail(f"train (d): the restored state is not the step-{resume_at} checkpoint")
    if done[-1] != DRIVER_STEPS - 1 or sorted(set(done)) != list(range(DRIVER_STEPS)):
        fail(f"train (d): the run did not complete {DRIVER_STEPS} steps: {done}")
    del params, opt, res, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (e) the hybrid, ssm and audio families at full width: (config, its cut,
# rows, tokens a row (whisper: decoder tokens over 1500 stub frames)):
# zamba2 at 12 of 81 blocks, two segments of the shared attention block and
# 5 Mamba2 blocks (the shared block's gradient sums two applications);
# rwkv6 at 2 of 32 blocks; whisper-base whole
TRAIN_FAMILIES = (
    ("zamba2-7b", {"n_layers": 12}, 2, 1024),
    ("rwkv6-7b", {"n_layers": 2}, 2, 512),
    ("whisper-base", {}, 4, 448),
)
FAMILY_TRAIN_STEPS = 5
# AdamW's peak rate: the default 3e-4 overshoots from random weights at
# full width in the first steps (zamba2-7b: loss 11.11 -> 16.44 after the
# first update, PERF.md), and a few steps must show the loss falling
FAMILY_TRAIN_LR = 3e-5
# peak allocated memory predicted from the parameter counts (PERF.md,
# section 6) before the first run
FAMILY_PEAK_PREDICTED_GB = {"zamba2-7b": (16.0, 19.0), "rwkv6-7b": (12.5, 15.0), "whisper-base": (2.0, 4.0)}


def _family_chunks(arch) -> dict:
    """Whisper's 1500 frames take attention chunks that divide them."""
    return dict(q_chunk=WHISPER_CHUNK, kv_chunk=WHISPER_CHUNK) if arch.family == "audio" else {}


def _model_flops(arch, params, B: int, S: int) -> float:
    """6 x parameters x the tokens that pass them, a training step's matmul
    FLOPs: every leaf but the embedding table (a gather); zamba2's shared
    block once per segment; whisper's encoder over its frames, the rest
    over the decoder's tokens."""
    from repro_torch.train.tree import leaves_with_paths

    frames = arch.enc_seq if arch.family == "audio" else S
    nseg = arch.n_layers // arch.attn_every if arch.family == "hybrid" else 1
    total = 0
    for path, t in leaves_with_paths(params):
        if path[0] == "embed":
            continue
        tokens = B * (frames if path[0] in ("enc_blocks", "enc_norm") else S)
        total += 6 * t.numel() * tokens * (nseg if path[0] == "shared_attn" else 1)
    return float(total)


def _train_family(name: str, cut: dict, B: int, S: int, card: str) -> dict:
    """(e) one family: ``FAMILY_TRAIN_STEPS`` steps of ``make_train_step``
    at full width, bf16, per-block remat, AdamW (lr ``FAMILY_TRAIN_LR``)
    with 2 warmup steps, on
    ``SyntheticLM`` batches (whisper's frames from its stub); the loss
    falling, no kernel of the port launched; a last step split into loss
    and gradients, then AdamW."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.train_loop import _microbatched_grads
    from repro_torch.train.tree import leaves

    arch = dataclasses.replace(get_arch(name), **cut)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    lm = LM(arch, torch.bfloat16, "cuda", remat=True, **_family_chunks(arch))
    tc = TrainConfig(opt=AdamWConfig(lr=FAMILY_TRAIN_LR, warmup_steps=2, total_steps=FAMILY_TRAIN_STEPS + 1))
    params, opt, res = init_train_state(lm, 0, tc)
    n_params = sum(t.numel() for t in leaves(params))
    data = SyntheticLM(DataConfig(vocab_size=arch.vocab_size, seq_len=S, global_batch=B))
    batches = []
    for i in range(FAMILY_TRAIN_STEPS + 1):
        b = to_device(data.batch(i), "cuda")
        if arch.family == "audio":
            b.update(lm.stub_inputs(B, arch.enc_seq, seed=i))
        batches.append(b)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(lm, tc)
    ops.reset_launches()
    losses, step_ms = [], []
    for i in range(FAMILY_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, res, m = step(params, opt, batches[i], res)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t))
    launched = {k: n for k, n in ops.LAUNCHES.items() if n}
    split = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, grads = _microbatched_grads(lm, params, batches[-1], 1)
    torch.cuda.synchronize()
    split["loss_and_grads_ms"] = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    params, opt, _ = adamw_update(tc.opt, params, grads, opt)
    torch.cuda.synchronize()
    split["adamw_ms"] = 1e3 * (time.perf_counter() - t)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del grads
    timed = spread(step_ms[1:])  # steps 2 on
    flops = _model_flops(arch, params, B, S)
    cut_desc = f"{arch.n_layers} blocks" + (f" + {arch.enc_layers} encoder layers" if arch.encdec else "")
    out = dict(arch=f"{name} full width, {cut_desc}, bf16, remat", params=n_params, init_s=init_s,
               batch=(B, S), losses=losses, step_ms=timed, split=split, tokens_per_s=B * S / (timed["median"] / 1e3),
               model_flops=flops, model_flops_share=flops / (timed["median"] / 1e3) / PEAK_BF16_FLOPS,
               peak_gb=peak_gb, base_gb=base_gb, predicted_peak_gb=FAMILY_PEAK_PREDICTED_GB[name],
               launches=launched)
    lo, hi = FAMILY_PEAK_PREDICTED_GB[name]
    log(f"train (e) {name}: {out['arch']}, {n_params / 1e9:.3f} B parameters, batch {B} x {S} tokens"
        f"{f' over {arch.enc_seq} frames' if arch.encdec else ''}; init {init_s:.1f} s")
    log(f"train (e) {name}: step {timed['median']:.1f} ms ({timed['min']:.1f}-{timed['max']:.1f}, steps 2-"
        f"{FAMILY_TRAIN_STEPS}, host clock), loss and gradients {split['loss_and_grads_ms']:.1f} ms, AdamW "
        f"{split['adamw_ms']:.1f} ms; {out['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
        f"{out['model_flops_share']:.4f} ({flops / 1e12:.2f} TFLOP a step over {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s); peak allocated {peak_gb:.2f} GB ({base_gb:.2f} GB before), predicted {lo:.1f}-{hi:.1f} GB "
        f"| {card}")
    log(f"train (e) {name}: loss by step " + ", ".join(f"{x:.4f}" for x in losses))
    if not all(np.isfinite(losses)):
        fail(f"train (e) {name}: a loss is not finite: {losses}")
    note_tokens(f"train (e) {name} losses", losses)
    if not np.mean(losses[-2:]) < losses[0]:
        fail(f"train (e) {name}: the mean loss of the last 2 steps {np.mean(losses[-2:]):.4f} is not below "
             f"step 1's {losses[0]:.4f}")
    if launched:
        fail(f"train (e) {name}: the training path launched the port's CUDA kernels: {launched}")
    del params, opt, res, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_families(card: str) -> dict:
    """(e) and (f): each family's training run at full width, then one
    float32 block of it on the card against the CPU, leaf for leaf, as (b)
    holds qwen3's layer: zamba2's shared attention block and one Mamba2
    block, one rwkv6 block, whisper's first encoder and decoder layer."""
    from repro_torch.configs import get_arch

    one_block = {"hybrid": dict(n_layers=2, attn_every=2), "ssm": dict(n_layers=1),
                 "audio": dict(n_layers=1, enc_layers=1)}
    out = {}
    for name, cut, B, S in TRAIN_FAMILIES:
        out[name] = _train_family(name, cut, B, S, card)
        arch = get_arch(name)
        small = dataclasses.replace(arch, **one_block[arch.family])
        out[name]["card_vs_cpu"] = _train_card_against_cpu(
            small, f"train (f) {name}", "one block at full width", **_family_chunks(small))
    return out


def phase_train(card: str) -> dict:
    """Phase 11: training on the card, after deepseek-v2 is freed."""
    import torch

    log(f"training: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the phase")
    out, t0 = {}, time.perf_counter()
    for part, fn in (("full_width", lambda: _train_full_width(card)), ("card_vs_cpu", _train_card_against_cpu),
                     ("dual_raises", _train_dual_raises), ("driver", _train_driver),
                     ("families", lambda: _train_families(card))):
        t = time.perf_counter()
        out[part] = fn()
        out[part]["part_s"] = time.perf_counter() - t
    out["phase_s"] = time.perf_counter() - t0
    log("training parts: " + ", ".join(f"{k} {v['part_s']:.1f} s" for k, v in out.items() if isinstance(v, dict))
        + f"; phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the hybrid, ssm and audio families
# ---------------------------------------------------------------------------

# (config, prompt tokens, audio frames, kernel launches per decode step):
# zamba2's 13 shared-attention applications, whisper's 6 decoder layers;
# rwkv6 runs no kernel (no Pallas kernel covers RWKV6 in the reference)
RECURRENT = (
    ("zamba2-7b", 256, None, {"decode_attention": 13}),
    ("rwkv6-7b", 256, None, {}),
    ("whisper-base", 64, 1500, {"decode_attention": 6}),
)
RECURRENT_BATCH, RECURRENT_STEPS = 4, 32
CONSISTENCY_TOKENS = 32  # prefill against step-by-step decode over these
# the encoder's 1500 frames take chunks that divide them, as the
# reference's flash_attention requires (its default 1024 does not)
WHISPER_CHUNK = 750
WHISPER_ROW = "dh64_g1"  # phase 3's tag of the attention row at whisper-base's decode shape


def _recurrent_lm(arch, device: str):
    import torch

    from repro_torch.models import LM

    return LM(arch, torch.bfloat16, device, **_family_chunks(arch))


def _tree_bytes(tree) -> int:
    sizes = []
    _tree_map(lambda t: sizes.append(t.numel() * t.element_size()), tree)
    return sum(sizes)


def _recurrent_batch(lm, B: int, P: int, frames, seed: int) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, lm.arch.vocab_size, (B, P)), device=lm.device)}
    if frames:
        batch.update(lm.stub_inputs(B, frames, seed=seed))
    return batch


def _slice_of(arch, params):
    """A 2-block slice of a model, as a config and its weights: zamba2's
    first segment (the shared attention and one Mamba2 block), rwkv6's first
    two blocks, whisper's first encoder and first decoder layer."""
    gp = {k: v for k, v in params.items() if k not in ("mamba_seg", "mamba_tail", "blocks", "enc_blocks")}
    if arch.family == "hybrid":
        gp["mamba_seg"] = [params["mamba_seg"][0][:1]]
        return dataclasses.replace(arch, n_layers=2, attn_every=2), gp
    if arch.family == "ssm":
        gp["blocks"] = params["blocks"][:2]
        return dataclasses.replace(arch, n_layers=2), gp
    gp["enc_blocks"], gp["blocks"] = params["enc_blocks"][:1], params["blocks"][:1]
    return dataclasses.replace(arch, n_layers=1, enc_layers=1), gp


def _recurrent_slice(arch, params, frames) -> dict:
    """The 2-block slice on the card against the CPU plain path on the same
    weights (the phase-4 rule): prefill logits of a 32-token prompt (and,
    for whisper, its frames), and one decode step after it."""
    import torch

    small, gp = _slice_of(arch, params)
    out, logits = {}, {}
    for device, tree in (("cuda", gp), ("cpu", _to_cpu(gp))):
        lm = _recurrent_lm(small, device)
        batch = _recurrent_batch(lm, 1, 32, frames, seed=1)
        lp, cache, _ = lm.prefill(tree, batch, max_seq=33)
        step = {"tokens": batch["tokens"][:, :1],
                "position": torch.full((1,), 32, dtype=torch.int32, device=lm.device)}
        ld, _, _ = lm.decode_step(tree, step, cache)
        logits[device] = (lp, ld)
    for stage, g, w in zip(("prefill", "decode"), logits["cuda"], logits["cpu"]):
        out.update({f"ref_{k}": v for k, v in _hold_logits(
            f"{arch.name} 2-block slice, card vs CPU plain path", stage, g, w, arch.vocab_size).items()})
    return out


def _recurrent_consistency(lm, params, frames) -> dict:
    """Prefill against step-by-step decode over the same
    ``CONSISTENCY_TOKENS`` tokens on the card at full depth, as
    tests/test_consistency.py holds the reference (there in float32 at 2-5
    blocks, relative 2e-3; whisper decodes against the prefill's cross
    K/V).

    The bf16 tolerance.  bf16's own error grows with depth on these
    random-weight models: against a float32 prefill of the same weights
    (upcast, on the card) the bf16 prefill's logits were off by 7.4% of
    the largest logit for zamba2-7b, 70% (cosine 0.81) for rwkv6-7b and
    0.7% for whisper-base on an H100 (PERF.md), while float32 prefill and
    float32 step-by-step decode agreed to 1.2e-5 (zamba2) and 7.7e-7
    (whisper).  So two bf16 computations of the function cannot
    meet the phase-4 rule at full depth, and the rule here holds the bf16
    decode to the float32 prefill: its max |err| at most 1.5x the bf16
    prefill's (or 5% of the largest logit) and its cosine distance at most
    2x the prefill's (or 1e-3): decode is as accurate as prefill.  The
    bf16 prefill against the bf16 decode is recorded beside it."""
    import torch

    from repro_torch.models import LM

    arch, V = lm.arch, lm.arch.vocab_size
    batch = _recurrent_batch(lm, RECURRENT_BATCH, CONSISTENCY_TOKENS, frames, seed=2)
    logits_pf, pcache, _ = lm.prefill(params, batch)
    cache = lm.init_cache(RECURRENT_BATCH, CONSISTENCY_TOKENS)
    if "cross" in cache:
        cache["cross"] = pcache["cross"]
    for i in range(CONSISTENCY_TOKENS):
        step = {"tokens": batch["tokens"][:, i:i + 1],
                "position": torch.full((RECURRENT_BATCH,), i, dtype=torch.int32, device=lm.device)}
        logits, cache, _ = lm.decode_step(params, step, cache)
    del pcache, cache
    f32 = LM(arch, torch.float32, lm.device, q_chunk=lm.q_chunk, kv_chunk=lm.kv_chunk)
    p32 = _tree_map(lambda t: t.float(), params)
    logits_f32, _, _ = f32.prefill(p32, {k: v.float() if v.is_floating_point() else v for k, v in batch.items()})
    del p32
    torch.cuda.empty_cache()
    pd = _logit_distance(logits, logits_pf, V)
    pf_err, scale, pf_cos = _logit_distance(logits_pf, logits_f32, V)
    dec_err, _, dec_cos = _logit_distance(logits, logits_f32, V)
    run = f"{arch.name} prefill vs step-by-step decode ({CONSISTENCY_TOKENS} tokens, full depth)"
    log(f"{run}: bf16 prefill vs bf16 decode max |err| {pd[0]:.4g} (max |logit| {pd[1]:.3g}, relative "
        f"{pd[0] / pd[1]:.4g}), cosine {pd[2]:.6f}; against the float32 prefill: bf16 prefill relative "
        f"{pf_err / scale:.4g} cosine {pf_cos:.6f}, bf16 decode relative {dec_err / scale:.4g} cosine {dec_cos:.6f}")
    if dec_err > max(1.5 * pf_err, 5e-2 * scale) or 1 - dec_cos > max(2 * (1 - pf_cos), 1e-3):
        fail(f"{run}: decode is less accurate than prefill against the float32 prefill")
    return dict(consistency_max_abs_err=pd[0], consistency_rel_err=pd[0] / pd[1], consistency_cosine=pd[2],
                f32_prefill_rel_err=pf_err / scale, f32_prefill_cosine=pf_cos,
                f32_decode_rel_err=dec_err / scale, f32_decode_cosine=dec_cos)


def _recurrent_model(name: str, P: int, frames, per_step: dict, card: str) -> dict:
    """One family's model at full width and depth: weights, a prefill of 4
    prompts with a decode cache, 32 greedy decode steps (eager) with the
    launch counts zeroed before the prefill and read after the last step,
    a profile of 4 more steps, the consistency check and the 2-block
    slice."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops

    arch = get_arch(name)
    t0 = time.perf_counter()
    lm = _recurrent_lm(arch, "cuda")
    params = lm.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = _tree_bytes(params)
    B, V = RECURRENT_BATCH, arch.vocab_size
    batch = _recurrent_batch(lm, B, P, frames, seed=0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # counts from here on are this run's
    t0 = time.perf_counter()
    logits, cache, _ = lm.prefill(params, batch, max_seq=P + RECURRENT_STEPS + 4)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    if tuple(logits.shape) != (B, 1, lm.vocab_padded):
        fail(f"{name} prefill: logits {tuple(logits.shape)}")
    tok = logits[:, 0, :V].argmax(-1)
    generated, step_ms, finite = [tok], [], [torch.isfinite(logits[..., :V]).all()]
    position = torch.full((B,), P, dtype=torch.int32, device=lm.device)

    def step():  # one greedy decode step at ``position``, then the next position
        nonlocal tok, logits
        logits, _, _ = lm.decode_step(params, {"tokens": tok[:, None], "position": position}, cache)
        tok = logits[:, 0, :V].argmax(-1)
        position.add_(1)

    for _ in range(RECURRENT_STEPS):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        generated.append(tok)
        finite.append(torch.isfinite(logits[..., :V]).all())
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated()
    tokens = torch.stack(generated, 1).cpu()
    if not bool(torch.stack(finite).all()) or not bool(((tokens >= 0) & (tokens < V)).all()):
        fail(f"{name}: non-finite logits or a token outside the vocabulary")
    note_tokens(f"recurrent {name}", tokens)
    want = {k: n * RECURRENT_STEPS for k, n in per_step.items()}
    if launches != want:
        fail(f"{name}: launches {launches} over prefill and {RECURRENT_STEPS} decode steps; {want} required")
    read_bytes = weight_bytes + (_tree_bytes(cache["cross"]) if "cross" in cache else 0)
    bound_ms = 1e3 * read_bytes / PEAK_HBM_BYTES
    sp = spread(step_ms[2:])
    out = dict(
        n_layers=arch.n_layers, weight_bytes=weight_bytes, init_s=init_s, peak_allocated_bytes=peak,
        prefill_tokens=B * P, frames=frames, prefill_ms=prefill_ms, decode_step_ms=sp,
        decode_tok_per_s=1e3 * B * RECURRENT_STEPS / sum(step_ms),
        decode_read_bytes=read_bytes, decode_bound_ms=bound_ms, step_over_bound=sp["median"] / bound_ms,
        launches=launches, launches_per_decode_step={k: n / RECURRENT_STEPS for k, n in launches.items()},
    )
    log(f"{name}: {arch.n_layers} blocks{f' + {arch.enc_layers} encoder layers' if arch.encdec else ''}, "
        f"d_model {arch.d_model}; weights {weight_bytes / 1e9:.3f} GB (init {init_s:.1f} s), peak allocated "
        f"{peak / 1e9:.3f} GB | {card}")
    log(f"{name}: prefill of {B} x {P} tokens{f' over {frames} frames' if frames else ''} {prefill_ms:.1f} ms; "
        f"{RECURRENT_STEPS} greedy decode steps (eager, host clock): median {sp['median']:.2f} ms "
        f"({sp['min']:.2f}-{sp['max']:.2f}, steps 3-{RECURRENT_STEPS}), {out['decode_tok_per_s']:.1f} tokens/s; "
        f"weight-read bound {bound_ms:.4f} ms ({read_bytes / 1e9:.4f} GB{' with the cross K/V' if frames else ''} "
        f"at 3.35 TB/s), step / bound {out['step_over_bound']:.1f} | {card}")
    if per_step:
        log(f"{name}: launches per decode step {out['launches_per_decode_step']} (prefill runs no kernel)")
    else:
        log(f"{name}: no kernel launched: RWKV6 has no Pallas kernel in the reference, so the port runs no "
            "kernel counterpart on this path (plain PyTorch, as plain jnp there)")
    prof = _profile_window(step, 4)
    out["profile"] = {k: v for k, v in prof.items() if k != "top_host"}
    log(f"{name}: profiled decode step {prof['step_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms, "
        f"idle share {prof['idle_share']:.3f}, {prof['kernels_per_step']} kernels a step")
    for key, calls, ms in prof["top_device"][:6]:
        log(f"  device {ms:8.3f} ms/step {calls:6d} calls  {key[:90]}")
    out.update(_recurrent_consistency(lm, params, frames))
    out.update(_recurrent_slice(arch, params, frames))
    del lm, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_recurrent(card: str) -> dict:
    """Phase 10: zamba2-7b, rwkv6-7b and whisper-base at full width and
    depth, one after the other, each freed before the next is built."""
    return {name: _recurrent_model(name, P, frames, per_step, card) for name, P, frames, per_step in RECURRENT}


# ---------------------------------------------------------------------------
# phase 9: expert parallelism
# ---------------------------------------------------------------------------

# qwen3-moe at full width on a (1, 8) mesh, the expert-parallel layout of an
# eight-GPU node: 16 experts a rank.  Depth is cut to 12 of 48 layers: the
# eight ranks must share one 80 GB card (24 layers fit), and at 24 the
# phase took 277 s of a script that should stay within half its 1200 s
EP_SHAPE = (1, 8)
EP_LAYERS = 12
EP_SLOTS, EP_MAX_SEQ, EP_STEPS = 8, 1024, 16
EP_PATHS = {"1": ("swiglu_gmm_capacity", "swiglu_gemv"), "0": ("gmm_capacity", "expert_gemv")}
# (run, REPRO_EP_MODE, REPRO_FUSED_SWIGLU, REPRO_KV_INT8)
EP_RUNS = (
    ("psum_fused", "psum", "1", "0"),
    ("psum_three_call", "psum", "0", "0"),
    ("a2a_fused", "a2a", "1", "0"),
    ("int8_fused", "psum", "1", "1"),
)
EP_SUFFIX = "_ep_a2a"  # phase 9's kernel rows at the all-to-all segment shape
# tensor parallelism: the same 12 layers as a (2, 4) mesh, the 8 slots over
# 2 data rows and attention split by heads over 4 (8 heads on one kv head a
# rank), psum fused, fewer decode steps than the (1, 8) runs to keep the
# script's time
TP_SHAPE = (2, 4)
TP_STEPS = 6
TP_RUN = "tp_psum_fused"
TP_PATH = EP_PATHS["1"] + ("decode_attention",)
TP_ROW = "tp_g8"  # phase 3's tag of the dense attention row at a TP rank's decode shape
# the hybrid, ssm and audio families on the (2, 4) mesh after qwen3 and
# deepseek-v2: zamba2 one segment (the shared attention block and 5 Mamba2
# blocks), rwkv6 2 of 32 blocks, whisper-base whole; 4 prompts of 64 tokens
# (whisper's over 1500 stub frames), 2 a data row, and TP_STEPS decode steps
TP_FAMILIES = (("zamba2-7b", {"n_layers": 6}), ("rwkv6-7b", {"n_layers": 2}), ("whisper-base", {}))
TP_FAM_SLOTS, TP_FAM_PROMPT = 4, 64
# phase 3's tags of the dense attention rows at a rank's decode shape
# (rows 3g, 3h): zamba2's shared attention (8 heads on 8 kv heads, dh 112)
# and whisper's decoder (2 on 2, dh 64)
TP_FAM_ROWS = {"zamba2-7b": "tp_dh112", "whisper-base": "tp_dh64"}
# a rank's weights by group, predicted from the shapes (PERF.md, section 6)
# mesh training on the (2, 4) ranks after the families (``_tp_train``):
# qwen3-moe at full width, 1 layer, 2 rows of 512 tokens a data row
MESH_TRAIN_LAYERS, MESH_TRAIN_ROWS, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 1, 2, 512, 3
MESH_TRAIN_LR = 1e-3
TP_FAM_PREDICTED = {
    "zamba2-7b": "attention 0.026, ssm 0.199, embedding/logits 0.115, rest 0.077, in all 0.416; 1.649 whole",
    "rwkv6-7b": "ssm 0.271, embedding/logits 0.268, in all 0.539; 1.95 whole",
    "whisper-base": "attention 0.009, embedding/logits 0.027, rest 0.013, in all 0.049; 0.195 whole",
}
EP_PARITY_PROMPT = 32  # tokens of each of the 8 prompts of the 2-layer parity
EP_INT8_STEPS = 8  # decode steps of the 2-layer int8 check


def ep_arch(n_layers: int = EP_LAYERS):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch("qwen3-moe-30b-a3b"), n_layers=n_layers)


def _ep_prompts(arch, seed: int = 0):
    """The 8 prompts of phase 9: 128-512 tokens, multiples of 8 so the
    all-to-all body (which needs the tokens to divide over the 8 ranks) runs
    at prefill too."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, arch.vocab_size, int(n)).astype(np.int64)
            for n in rng.integers(16, 65, EP_SLOTS) * 8]


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


class EPProbe:
    """What one rank's MoE path did in each step of an expert-parallel run:
    its head's live rows and its tail's valid rows, the rows that arrived
    in its experts' buffers, its dispatch's overflow drops and its
    executor's drops (summed on the card, read once a step), the device
    time of its MoE layers (CUDA events around each ``moe_block``) and the
    host time of its collectives.  It wraps module functions of
    ``repro_torch.models`` until :meth:`remove`."""

    KEYS = ("head", "tail", "arrived", "disp_drop", "exec_drop")

    def __init__(self, device):
        import torch

        from repro_torch.models import collectives, moe, transformer

        self.device = device
        self.records = []
        self._saved = []
        self._reset()

        def wrap(mod, name, make):
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, make(orig))

        def head(orig):
            def head_stage(slab, wg, wu, wd, sizes, rhs_of_group=None):
                self.t["head"] += sizes.sum()
                return orig(slab, wg, wu, wd, sizes, rhs_of_group)
            return head_stage

        def tail(orig):
            def tail_stage(toks, wg, wu, wd, eids, valid):
                self.t["tail"] += valid.sum()
                return orig(toks, wg, wu, wd, eids, valid)
            return tail_stage

        def dispatch(orig):
            def run(*args, **kw):
                d = orig(*args, **kw)
                self.t["disp_drop"] += d.n_dropped
                return d
            return run

        def executor(orig):
            def run(params, buf, rows, cfg, sieve=None):
                y, dropped = orig(params, buf, rows, cfg, sieve=sieve)
                self.t["arrived"] += rows.sum()
                self.t["exec_drop"] += dropped
                return y, dropped
            return run

        def block(orig):
            def moe_block(*args, **kw):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = orig(*args, **kw)
                e1.record()
                self.events.append((e0, e1))
                return out
            return moe_block

        def timed(orig):
            def run(*args, **kw):
                t0 = time.perf_counter()
                out = orig(*args, **kw)
                self.coll_s += time.perf_counter() - t0
                return out
            return run

        wrap(moe, "head_stage", head)
        wrap(moe, "tail_stage", tail)
        wrap(moe, "dispatch", dispatch)
        wrap(moe, "experts_ffn_exec", executor)
        wrap(moe, "experts_ffn_dual_segmented", executor)
        wrap(transformer, "moe_block", block)
        for name in ("all_reduce", "all_gather", "all_to_all"):
            wrap(collectives, name, timed)

    def _reset(self) -> None:
        import torch

        self.t = {k: torch.zeros((), dtype=torch.int64, device=self.device) for k in self.KEYS}
        self.events, self.coll_s = [], 0.0

    def end_step(self, kind: str, aux, n_tokens: int, local: slice, step_s: float, mi=None) -> dict:
        """Close the step: its numbers with the global per-layer counts of
        ``aux`` and the assignments routed to this rank's experts.  ``mi``,
        the MeshInfo the step ran on, gives its data ranks (``dp``) and how
        many data rows of the mesh computed the same tokens (``copies``)."""
        import torch
        import torch.distributed as dist

        torch.cuda.synchronize()
        rec = {k: int(v) for k, v in self.t.items()}
        counts = aux.counts.cpu()
        dp = 1 if mi is None else mi.dp_size
        copies = 1 if mi is None else dist.get_world_size() // (mi.ep_size * dp)
        rec.update(kind=kind, tokens=n_tokens, counts=counts.numpy(), dropped=int(aux.dropped), dp=dp,
                   copies=copies,
                   routed_local=int(counts[:, local].sum()),
                   moe_ms=sum(a.elapsed_time(b) for a, b in self.events),
                   coll_ms=1e3 * self.coll_s, step_ms=1e3 * step_s)
        self.records.append(rec)
        self._reset()
        return rec

    def remove(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)


def _ep_check_step(rec: dict, run: str, a2a: bool, top_k: int) -> None:
    """One rank's step: every row that reached its experts ran in the head or
    the tail or was dropped by the executor; with replicated dispatch and
    one data rank its rows plus its dispatch drops are the assignments
    routed to its experts (with the all-to-all the sources drop before the
    exchange; over data ranks the sum is checked across ranks,
    ``_check_runs``); the global counts add up to the step's tokens times
    top-k on every layer."""
    if rec["head"] + rec["tail"] + rec["exec_drop"] != rec["arrived"]:
        raise RuntimeError(f"{run} {rec['kind']}: head {rec['head']} + tail {rec['tail']} + executor "
                           f"drops {rec['exec_drop']} != {rec['arrived']} rows in this rank's buffers")
    if not a2a and rec["dp"] == 1 and rec["arrived"] + rec["disp_drop"] != rec["routed_local"]:
        raise RuntimeError(f"{run} {rec['kind']}: {rec['arrived']} rows + {rec['disp_drop']} dispatch drops "
                           f"!= {rec['routed_local']} assignments routed to this rank's experts")
    if a2a and rec["arrived"] > rec["routed_local"]:
        raise RuntimeError(f"{run} {rec['kind']}: more rows arrived than were routed to this rank")
    per_layer = rec["counts"].sum(axis=1)
    if not (per_layer == rec["tokens"] * top_k).all():
        raise RuntimeError(f"{run} {rec['kind']}: per-layer counts {per_layer.tolist()} != "
                           f"{rec['tokens']} tokens x top-{top_k}")


def _greedy(logits, vocab: int, run: str):
    import torch

    if not torch.isfinite(logits).all():
        raise RuntimeError(f"{run}: non-finite logits")
    tok = torch.argmax(logits[:, -1, :vocab].float(), dim=-1)
    if not ((tok >= 0) & (tok < vocab)).all():
        raise RuntimeError(f"{run}: a token outside the vocabulary")
    return tok.to(torch.int32)


def _ep_serve(lm, params, mi, prompts, run: str, a2a: bool, int8: bool, path, prefill_lm=None,
              steps: int = 0) -> dict:
    """One phase-9 run on this rank: the 8 prompts prefilled one by one into
    the slots of a rank-local cache (none with int8: its cache starts empty,
    as the reference's int8 path does), then ``steps`` (else
    ``EP_STEPS``) greedy decode steps of all 8 slots, with the launch counters zeroed just before.
    With data ranks, ``prefill_lm`` (the same model on the mesh with the
    batch of one prompt replicated over the data axis) prefills every
    prompt, and a rank keeps the slots of its data rows."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.sharding import batch_rows, expert_rows

    arch, dev = lm.arch, lm.device
    pre = prefill_lm or lm
    mine = batch_rows(EP_SLOTS, mi)
    local = expert_rows(arch.moe.n_experts, mi)
    t_run = time.perf_counter()
    probe = EPProbe(dev)
    ops.reset_launches()
    cache = lm.init_cache(EP_SLOTS, EP_MAX_SEQ)
    if int8:
        tok = torch.as_tensor([int(p[0]) for p in prompts], dtype=torch.int32, device=dev)
        pos = torch.zeros(EP_SLOTS, dtype=torch.int32, device=dev)
    else:
        toks = []
        for i, prompt in enumerate(prompts):
            t0 = time.perf_counter()
            logits, c, aux = pre.prefill(params, {"tokens": torch.as_tensor(prompt, device=dev)[None]},
                                         max_seq=EP_MAX_SEQ)
            torch.cuda.synchronize()
            rec = probe.end_step("prefill", aux, len(prompt), local, time.perf_counter() - t0, pre.mi)
            _ep_check_step(rec, run, a2a, arch.moe.top_k)
            if mine.start <= i < mine.stop:
                for key in cache:
                    for dst, src in zip(cache[key], c[key]):
                        dst[:, i - mine.start].copy_(src[:, 0])
            toks.append(_greedy(logits, arch.vocab_size, run))
            del c
        tok = torch.cat(toks)
        pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    generated = []
    for _ in range(steps or EP_STEPS):
        t0 = time.perf_counter()
        logits, cache, aux = lm.decode_step(params, {"tokens": tok[:, None], "position": pos}, cache)
        torch.cuda.synchronize()
        rec = probe.end_step("decode", aux, EP_SLOTS, local, time.perf_counter() - t0, mi)
        _ep_check_step(rec, run, a2a, arch.moe.top_k)
        tok = _greedy(logits, arch.vocab_size, run)
        generated.append(tok.cpu().numpy())
        pos = pos + 1
    launches = dict(ops.LAUNCHES)
    probe.remove()
    for name, n in launches.items():
        if (name in path) != (n > 0):
            raise RuntimeError(f"{run}: kernel {name} launched {n} times; the path's kernels are {path}")
    return {"steps": probe.records, "launches": launches, "tokens": generated,
            "wall_s": time.perf_counter() - t_run}


def _tape_route(choices: list, replay: bool = False):
    """``moe.route`` recording each call's top-k choices into ``choices``
    or, with ``replay``, taking them from it in call order: the weights
    from this run's own router probabilities, the counts from the taken
    choices (``RoutingTape`` for one process).  Restores the router on
    exit."""
    import torch

    from repro_torch.models import moe

    route = moe.route
    calls = iter(list(choices))

    def taped(x, w, cfg):
        r = route(x, w, cfg)
        if not replay:
            choices.append(r.expert_idx)
            return r
        idx = next(calls).to(x.device)
        top_p = torch.softmax(x.float() @ w.float(), dim=-1).gather(1, idx.long())
        weights = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        counts = torch.zeros_like(r.counts).index_add_(0, idx.reshape(-1).long(),
                                                       torch.ones_like(idx.reshape(-1)))
        return r._replace(expert_idx=idx, weights=weights.to(x.dtype), counts=counts)

    @contextlib.contextmanager
    def installed():
        moe.route = taped
        try:
            yield choices
        finally:
            moe.route = route

    return installed()


def _all_choices(c, mi, a2a: bool):
    """A route call's top-k choices of every token of the global batch, in
    batch order: a rank routed its data rows' tokens (with the all-to-all
    body, its model rank's share of them)."""
    from repro_torch.models import collectives as coll

    if a2a:
        c = coll.all_gather(c, mi.model_group).reshape(-1, c.shape[-1])
    return coll.all_gather(c, mi.data_group).reshape(-1, c.shape[-1])


def _ep_parity(lm, params, mi) -> dict:
    """The first two layers of this rank's weights as a mesh (on (1, 8)
    decoding sequence-parallel, on (2, 4) with attention split by heads),
    on each EP body, against the same two layers as one process on rank
    0's card, drawn keyed from the same seed with all experts: 8 prompts of
    ``EP_PARITY_PROMPT`` tokens, then one decode step.  Both sides take a
    capacity no batch here fills: the all-to-all body sizes capacity per
    source rank, so only a run with no drops equals one process.

    In bfloat16 the two sides round differently: each rank splits its own
    experts between the head and the tail kernel where one process splits
    all of them, and decode attention is the dense kernel (bf16
    probabilities into the value product) in one process and float32
    einsums on the mesh.  A near-tie in a router's top-k then flips, and a
    flip moves a whole expert's output.  So the mesh is held as phase 4
    holds the card to the CPU: the first layer's prefill counts exact where
    both sides route the same inputs there (no layer before it split over
    the model group: a split one sums its partials in another order, so
    there its routing falls under the next clause), at most 2% of all routed
    assignments moved between the two sides' own choices, and, with the
    mesh's choices replayed in the one process, logits within 5% of the
    largest logit and cosine 0.999.  The largest difference and the share
    of logits within ``TOL`` are recorded.

    Then, on the sequence-parallel path, the int8 cache, as the
    reference's test holds it (tests/test_perf_paths.py:126): the first
    layer's sequence-parallel attention, ``EP_INT8_STEPS`` steps from an
    empty int8 cache and from an empty bf16 one on the same inputs, within
    relative 0.03 on every step.
    The 2-layer model's logits from the two caches are recorded per step
    beside whether the two routed alike."""
    import numpy as np
    import torch

    from repro_torch.models import LM

    dev = lm.device
    arch = lm.arch
    small = dataclasses.replace(arch, n_layers=2, moe=dataclasses.replace(arch.moe, min_capacity=4096))
    p2 = dict(params, blocks=params["blocks"][:2])
    rng = np.random.default_rng(3)
    prompt = torch.as_tensor(rng.integers(0, arch.vocab_size, (EP_SLOTS, EP_PARITY_PROMPT)), device=dev)
    tok = torch.as_tensor(rng.integers(0, arch.vocab_size, (EP_SLOTS, 1)), dtype=torch.int32, device=dev)
    pos = torch.full((EP_SLOTS,), EP_PARITY_PROMPT, dtype=torch.int32, device=dev)

    def run(model, weights, tape):
        with tape as choices:
            logits_p, cache, aux_p = model.prefill(weights, {"tokens": prompt}, max_seq=2 * EP_PARITY_PROMPT)
            logits_d, _, aux_d = model.decode_step(weights, {"tokens": tok, "position": pos}, cache)
        return {"choices": choices, "logits": [t[..., : arch.vocab_size].float().cpu() for t in (logits_p, logits_d)],
                "counts": [aux_p.counts.cpu(), aux_d.counts.cpu()]}

    mesh = {}
    for ep in ("psum", "a2a"):
        with _env(REPRO_EP_MODE=ep, REPRO_FUSED_SWIGLU="1"):
            mesh[ep] = run(LM(small, torch.bfloat16, dev, mesh_info=mi), p2, _tape_route([]))
        mesh[ep]["choices"] = [_all_choices(c, mi, ep == "a2a") for c in mesh[ep]["choices"]]
    same_inputs = not lm._tp() and lm.n_prefix == 0
    out = {}
    if lm._seq_par():
        out.update(_ep_parity_int8(lm, p2, small, prompt, mi))
    if mi.model_index != 0 or mi.data_index != 0:
        return out
    ref_lm = LM(small, torch.bfloat16, dev)
    ref_params = ref_lm.init(seed=0, keyed=True)
    with _env(REPRO_FUSED_SWIGLU="1"):
        own = run(ref_lm, ref_params, _tape_route([]))
        for ep, got in mesh.items():
            want = run(ref_lm, ref_params, _tape_route(got["choices"], replay=True))
            out.update(_ep_parity_compare(ep, got, own, want, same_inputs))
    del ref_params
    return out


def _ep_parity_int8(lm, p2, small, prompt, mi) -> dict:
    """The int8 cache against bf16 on the sequence-parallel path: the first
    layer's attention within relative 0.03 on every step, then the 2-layer
    model's logits per step beside whether the two routed alike."""
    import torch

    from repro_torch.models import LM
    from repro_torch.models.attention import gqa_decode_seqpar

    dev, arch = lm.device, lm.arch
    # the int8 cache against bf16: the first layer's attention, then the model
    a, T_loc = arch.attn, EP_MAX_SEQ // mi.ep_size
    kv = (EP_SLOTS, T_loc, a.n_kv_heads, a.d_head)
    bf16 = [torch.zeros(kv, dtype=torch.bfloat16, device=dev) for _ in range(2)]
    q8 = [torch.zeros(kv, dtype=torch.int8, device=dev) for _ in range(2)]
    q8 += [torch.zeros(kv[:3], dtype=torch.float32, device=dev) for _ in range(2)]
    gen = torch.Generator(device=dev).manual_seed(5)
    attn_rel = []
    for i in range(EP_INT8_STEPS):
        x = torch.randn((EP_SLOTS, 1, arch.d_model), generator=gen, device=dev).to(torch.bfloat16)
        p = torch.full((EP_SLOTS,), i, dtype=torch.int32, device=dev)
        y_ref = gqa_decode_seqpar(p2["blocks"][0]["attn"], x, p, bf16[0], bf16[1], a, mi).float()
        y_q = gqa_decode_seqpar(p2["blocks"][0]["attn"], x, p, q8[0], q8[1], a, mi,
                                kv_scales=(q8[2], q8[3])).float()
        attn_rel.append(float((y_ref - y_q).abs().max() / y_ref.abs().max()))
    if not all(rel < 0.03 for rel in attn_rel):
        raise RuntimeError(f"int8 KV attention off the bf16 cache by more than 0.03: {attn_rel}")
    steps = {}
    model = LM(small, torch.bfloat16, dev, mesh_info=mi)
    for int8 in ("0", "1"):
        with _env(REPRO_KV_INT8=int8, REPRO_EP_MODE="psum", REPRO_FUSED_SWIGLU="1"):
            cache = model.init_cache(EP_SLOTS, EP_MAX_SEQ)
            steps[int8] = []
            for i in range(EP_INT8_STEPS):
                p = torch.full((EP_SLOTS,), i, dtype=torch.int32, device=dev)
                logits, cache, aux = model.decode_step(p2, {"tokens": prompt[:, i:i + 1].to(torch.int32),
                                                            "position": p}, cache)
                steps[int8].append((logits[..., : arch.vocab_size].float().cpu(), aux.counts.cpu()))
    return {"int8_attention_rel": attn_rel,
            "int8_steps": [(float((a - b).abs().max() / a.abs().max()), bool(torch.equal(ca, cb)))
                           for (a, ca), (b, cb) in zip(steps["0"], steps["1"])]}


def _moved(g, w) -> int:
    """Routed assignments of ``g`` (tokens x top-k choices) not in ``w``."""
    return sum(len(set(a.tolist()) - set(b.tolist())) for a, b in zip(g.cpu(), w.cpu()))


def _ep_parity_compare(ep: str, got: dict, own: dict, want: dict, same_inputs: bool = True) -> dict:
    """``_ep_parity``'s rule for one EP body: ``got`` the mesh's run, ``own``
    one process on its own routing, ``want`` one process on the mesh's.
    ``same_inputs``: both sides route the same inputs in the first layer."""
    import torch

    out = {f"{ep}_first_layer_moved": _moved(got["choices"][0], own["choices"][0])}
    if same_inputs and not torch.equal(got["choices"][0].cpu(), own["choices"][0].cpu()):
        raise RuntimeError(f"parity {ep}: the first layer's prefill routing differs from one process")
    if same_inputs and not torch.equal(got["counts"][0][0], own["counts"][0][0]):
        raise RuntimeError(f"parity {ep}: the first layer's prefill counts differ from one process")
    moved = total = 0
    for g, w in zip(got["choices"], own["choices"]):
        moved += _moved(g, w)
        total += g.numel()
    out[f"{ep}_moved_share"] = moved / total
    if moved / total > 0.02:
        raise RuntimeError(f"parity {ep}: {moved} of {total} routed assignments moved against one process")
    for stage, g, w in zip(("prefill", "decode"), got["logits"], want["logits"]):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0))
        within = float(torch.isclose(g, w, **TOL).float().mean())
        out.update({f"{ep}_{stage}_max_abs_err": err, f"{ep}_{stage}_max_logit": scale,
                    f"{ep}_{stage}_cosine": cos, f"{ep}_{stage}_share_within_tol": within})
        if not torch.isfinite(g).all() or err > 5e-2 * scale or cos < 0.999:
            raise RuntimeError(f"parity {ep} {stage}: the mesh's logits differ from one process on the "
                               f"mesh's routing by {err} (largest logit {scale}, cosine {cos})")
    return out


WEIGHT_GROUPS = ("experts", "attention", "ssm", "embedding_logits", "rest")


def _weight_groups(params) -> dict:
    """A rank's parameter bytes (GB) by group: the routed experts, the
    attention (whisper's cross-attention too), the Mamba2 and RWKV6 blocks,
    the embedding and logits tables, the rest (norms, routers, the dense
    and shared-expert FFNs, whisper's decoder positions)."""
    from repro_torch.models.sharding import is_expert_leaf

    out = dict.fromkeys(WEIGHT_GROUPS, 0.0)

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            group = ("experts" if is_expert_leaf(path) else "attention" if "attn" in path or "xattn" in path
                     else "ssm" if "mamba" in path or "rwkv" in path
                     else "embedding_logits" if path[0] in ("embed", "w_out") else "rest")
            out[group] += t.numel() * t.element_size() / 1e9

    walk(params, ())
    return out


def _ep_rank(mesh, n_layers: int) -> dict:
    """Everything one rank of phase 9's (1, 8) mesh runs: its weights, the
    four runs with their checks, and the 2-layer parity."""
    import torch

    from repro_torch.launch.mesh import mesh_info_for
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = ep_arch(n_layers)
    mi = mesh_info_for(mesh, EP_SLOTS)
    lm = LM(arch, torch.bfloat16, mesh.device, mesh_info=mi)
    t0 = time.perf_counter()
    params = lm.init(seed=0)  # keyed: this rank's experts and vocabulary rows only
    torch.cuda.synchronize()
    out = {"rank": mesh.rank, "model_index": mi.model_index, "init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9, "by_group": _weight_groups(params),
           "tp": lm._tp(), "runs": {}}
    prompts = _ep_prompts(arch)
    for run, ep, fused, int8 in EP_RUNS:
        with _env(REPRO_EP_MODE=ep, REPRO_FUSED_SWIGLU=fused, REPRO_KV_INT8=int8):
            out["runs"][run] = _ep_serve(lm, params, mi, prompts, run, ep == "a2a", int8 == "1",
                                         EP_PATHS[fused])
    free, total = torch.cuda.mem_get_info()
    out.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, card_used_gb=(total - free) / 1e9)
    t0 = time.perf_counter()
    out["parity"] = _ep_parity(lm, params, mi)
    out["parity_s"] = time.perf_counter() - t0
    return out


def _tp_rank(mesh, n_layers: int) -> dict:
    """Everything one rank of phase 9's (2, 4) mesh runs: qwen3's weights
    (its experts, heads and vocabulary rows), the psum fused run with the
    checks of the (1, 8) runs, the 2-layer qwen3 parity; then, qwen3's
    weights freed, a full-width deepseek-v2 slice of the dense prefix block
    and one MoE layer, drawn keyed on the mesh and held against one process
    by the same rule."""
    import torch

    from repro_torch.launch.mesh import mesh_info_for
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = mesh.device, torch.bfloat16
    arch = ep_arch(n_layers)
    mi = mesh_info_for(mesh, EP_SLOTS)
    lm = LM(arch, bf, dev, mesh_info=mi)
    t0 = time.perf_counter()
    params = lm.init(seed=0)
    torch.cuda.synchronize()
    out = {"rank": mesh.rank, "model_index": mi.model_index, "init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9, "by_group": _weight_groups(params),
           "tp": lm._tp(), "runs": {}}
    # a one-prompt prefill: the batch of one replicated over the data axis
    prefill_lm = LM(arch, bf, dev, mesh_info=mesh_info_for(mesh, 1))
    with _env(REPRO_EP_MODE="psum", REPRO_FUSED_SWIGLU="1", REPRO_KV_INT8="0"):
        out["runs"][TP_RUN] = _ep_serve(lm, params, mi, _ep_prompts(arch), TP_RUN, False, False, TP_PATH,
                                        prefill_lm=prefill_lm, steps=TP_STEPS)
    free, total = torch.cuda.mem_get_info()
    out.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, card_used_gb=(total - free) / 1e9)
    t0 = time.perf_counter()
    out["parity"] = _ep_parity(lm, params, mi)
    out["parity_s"] = time.perf_counter() - t0
    del lm, prefill_lm, params
    gc.collect()
    torch.cuda.empty_cache()
    ds = dataclasses.replace(deepseek_arch(), n_layers=2)
    dlm = LM(ds, bf, dev, mesh_info=mi)
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    dparams = dlm.init(seed=0)
    torch.cuda.synchronize()
    out["deepseek"] = {"init_s": time.perf_counter() - t0,
                       "weights_gb": (torch.cuda.memory_allocated() - before) / 1e9,
                       "by_group": _weight_groups(dparams), "tp": dlm._tp()}
    t0 = time.perf_counter()
    out["deepseek"]["parity"] = _ep_parity(dlm, dparams, mi)
    out["deepseek"]["parity_s"] = time.perf_counter() - t0
    del dlm, dparams
    gc.collect()
    torch.cuda.empty_cache()
    out["families"] = {name: _tp_family(mesh, name, cut) for name, cut in TP_FAMILIES}
    out["training"] = _tp_train(mesh)
    return out


def _digest(t) -> int:
    """A position-weighted sum of a tensor's bits (int64, wrapping): equal
    bits give equal digests."""
    import torch

    bits = t.detach().contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16).reshape(-1)
    weights = torch.arange(1, bits.numel() + 1, dtype=torch.int64, device=t.device)
    return int((bits.to(torch.int64) * weights).sum())


@contextlib.contextmanager
def _timed_collectives(coll, seconds: list):
    """Within the block every collective of ``coll`` (its all-reduce,
    all-gather and all-to-all, host staging included) adds its host-clock
    seconds to ``seconds[0]``, the device synchronised before and after."""
    import torch

    saved = {name: getattr(coll, name) for name in ("_reduce", "_gather", "_exchange")}

    def timed(fn):
        def run(t, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *args)
            torch.cuda.synchronize()
            seconds[0] += time.perf_counter() - t0
            return out

        return run

    for name, fn in saved.items():
        setattr(coll, name, timed(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(coll, name, fn)


def _per_row_mean_check(arch, mi, batch: dict, rows: int, g_mesh: list) -> dict:
    """One process on the card (float32, keyed weights from seed 1): the
    mean of its gradients of each data row's ``rows`` rows of ``batch``,
    this rank's part of each leaf held against ``g_mesh`` (the mesh's
    ``(path, gradient)`` leaves) by the phase-4 rule.  Returns the worst
    leaf; its weights are freed after."""
    import torch

    from repro_torch.models import LM
    from repro_torch.models.sharding import rank_part
    from repro_torch.train.train_loop import _loss_and_grads
    from repro_torch.train.tree import leaves_with_paths, tree_map

    one = LM(arch, torch.float32, batch["tokens"].device)
    params = tree_map(lambda p: p.requires_grad_(True), one.init(seed=1, keyed=True))
    acc = None
    for d in range(mi.dp_size):
        part = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
        g = [x.float() for _, x in leaves_with_paths(_loss_and_grads(one, params, part)[2])]
        acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
    del params, g
    worst = {"rel_err": 0.0, "cosine": 1.0, "leaves": len(acc)}
    for (path, got), whole in zip(g_mesh, acc):
        want = rank_part(whole / mi.dp_size, path, arch, mi)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0))
        name = "/".join(map(str, path))
        if not torch.isfinite(got).all() or err > 5e-2 * scale or cos < 0.999:
            raise RuntimeError(f"mesh training: gradient of {name} differs from the one process's per-row mean "
                               f"by {err} (largest {scale}, cosine {cos})")
        if scale and err / scale > worst["rel_err"]:
            worst.update(leaf=name, max_abs_err=err, max=scale, rel_err=err / scale)
        worst["cosine"] = min(worst["cosine"], cos)
    return worst


def _tp_train(mesh) -> dict:
    """Mesh training on a rank of the (2, 4) mesh: qwen3-moe at full width,
    ``MESH_TRAIN_LAYERS`` layer, ``expert_exec="dense"``, a global batch of
    ``MESH_TRAIN_ROWS`` rows a data row.  (a) float32: the rank's gradients
    after the data-parallel reduce; global rank 0 then runs one process on
    the card and holds its part of the mean of the one-process gradients
    of the two data rows' halves against them, leaf by leaf (max |err| at
    most 5% of the largest, cosine at least 0.999), while the other ranks
    wait.  (b) bf16, remat, int8 compression: ``MESH_TRAIN_STEPS`` steps of
    ``make_train_step`` on the batch, the launch counts zeroed before, the
    last with each phase the step marks timed on the host clock with the
    device synchronised and the collectives' seconds counted
    (``_timed_collectives``); then each leaf's digest for the checks
    across ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import mesh_info_for
    from repro_torch.models import LM
    from repro_torch.models import collectives as coll
    from repro_torch.models.sharding import tp_axis
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import loss_and_grads
    from repro_torch.train.tree import leaves_with_paths, tree_map

    dev = mesh.device
    base = ep_arch(MESH_TRAIN_LAYERS)
    arch = dataclasses.replace(base, moe=dataclasses.replace(base.moe, expert_exec="dense"))
    dp, R, S = TP_SHAPE[0], MESH_TRAIN_ROWS, MESH_TRAIN_SEQ
    mi = mesh_info_for(mesh, dp * R)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, arch.vocab_size, (dp * R, S + 1)).astype(np.int64)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}

    # (a) float32 gradients against one process's per-row mean
    t0 = time.perf_counter()
    lm32 = LM(arch, torch.float32, dev, mesh_info=mi)
    p32 = tree_map(lambda p: p.requires_grad_(True), lm32.init(seed=1))
    _, _, g_mesh = loss_and_grads(lm32, p32, batch)
    del p32
    g_mesh = leaves_with_paths(g_mesh) if mesh.rank == 0 else None
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        out["f32_check"] = _per_row_mean_check(arch, mi, batch, R, g_mesh)
    del g_mesh, lm32
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["f32_s"] = time.perf_counter() - t0

    # (b) bf16 training steps
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # the loss's float32 logits 128 positions at a time: eight ranks share the card
    lm = LM(arch, torch.bfloat16, dev, mesh_info=mi, remat=True, loss_chunk=128)
    tc = TrainConfig(opt=AdamWConfig(lr=MESH_TRAIN_LR, warmup_steps=1, total_steps=MESH_TRAIN_STEPS + 1),
                     grad_compression=True)
    params, opt, res = init_train_state(lm, 0, tc)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    step = make_train_step(lm, tc)
    losses = []
    ops.reset_launches()
    for _ in range(MESH_TRAIN_STEPS - 1):
        params, opt, res, m = step(params, opt, batch, res)
        losses.append(float(m["loss"]))
    # the last step timed phase by phase as the step marks them, the device
    # synchronised at each mark, the collectives' seconds counted
    split, coll_s, t = {}, [0.0], [0.0]

    def mark(phase: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[phase] = 1e3 * (now - t[0])
        t[0] = now

    timed = make_train_step(lm, tc, mark=mark)
    with _timed_collectives(coll, coll_s):
        torch.cuda.synchronize()
        t[0] = time.perf_counter()
        params, opt, res, m = timed(params, opt, batch, res)
    losses.append(float(m["loss"]))
    split["collectives"] = 1e3 * coll_s[0]
    out.update(losses=losses, split_ms=split, launches={k: n for k, n in ops.LAUNCHES.items() if n},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, grad_norm=float(m["grad_norm"]))
    out["digests"] = [("/".join(map(str, path)), tp_axis(path, w.shape, arch, mi.ep_size) is not None, _digest(x))
                      for (path, x), (_, w) in zip(leaves_with_paths(params), leaves_with_paths(lm.shapes()))]
    out["model_index"], out["data_index"] = mi.model_index, mi.data_index
    del lm, params, opt, res, step, timed, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_family(mesh, name: str, cut: dict) -> dict:
    """One recurrent family's slice on a rank of the (2, 4) mesh: global
    rank 0 first runs it as one process on the card (keyed weights from
    seed 0, the same numbers), prefill and ``TP_STEPS`` greedy decode
    steps, and sends every rank its tokens; then every rank draws its
    slices keyed, prefills the same prompts and decodes fed those tokens,
    the launch counts zeroed just before the prefill.  Rank 0 holds the
    mesh's logits at every step against the one process's by the phase-4
    rule; the launches must be the attention blocks' one a step each."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import mesh_info_for
    from repro_torch.models import LM

    dev, bf = mesh.device, torch.bfloat16
    arch = dataclasses.replace(get_arch(name), **cut)
    chunks = _family_chunks(arch)
    B, P, V = TP_FAM_SLOTS, TP_FAM_PROMPT, arch.vocab_size
    frames = arch.enc_seq if arch.encdec else None
    mi = mesh_info_for(mesh, B)
    tokens = torch.zeros((B, TP_STEPS), dtype=torch.int64)

    def positions(i):
        return torch.full((B,), P + i, dtype=torch.int32, device=dev)

    one = []
    if mesh.rank == 0:
        ref = LM(arch, bf, dev, **chunks)
        rp = ref.init(seed=0, keyed=True)
        batch = _recurrent_batch(ref, B, P, frames, seed=5)
        logits, cache, _ = ref.prefill(rp, batch, max_seq=P + TP_STEPS)
        for i in range(TP_STEPS + 1):
            one.append(logits[..., :V].float().cpu())
            if i == TP_STEPS:
                break
            tok = logits[:, 0, :V].argmax(-1)
            tokens[:, i] = tok.cpu()
            logits, _, _ = ref.decode_step(rp, {"tokens": tok[:, None], "position": positions(i)}, cache)
        del ref, rp, cache, batch
        gc.collect()
        torch.cuda.empty_cache()
    dist.broadcast(tokens, src=0)
    lm = LM(arch, bf, dev, mesh_info=mi, **chunks)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = lm.init(seed=0)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "weights_gb": (torch.cuda.memory_allocated() - before) / 1e9,
           "by_group": _weight_groups(params), "tp": lm._tp()}
    batch = _recurrent_batch(lm, B, P, frames, seed=5)
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache, _ = lm.prefill(params, batch, max_seq=P + TP_STEPS)
    torch.cuda.synchronize()
    out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    got, step_ms = [logits[..., :V].float().cpu()], []
    for i in range(TP_STEPS):
        t0 = time.perf_counter()
        logits, _, _ = lm.decode_step(params, {"tokens": tokens[:, i:i + 1].to(dev), "position": positions(i)},
                                      cache)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        got.append(logits[..., :V].float().cpu())
    out["launches"] = {k: n for k, n in ops.LAUNCHES.items() if n}
    attn_blocks = (arch.n_layers // arch.attn_every if arch.family == "hybrid"
                   else arch.n_layers if arch.family == "audio" else 0)
    want = {"decode_attention": attn_blocks * TP_STEPS} if attn_blocks else {}
    if out["launches"] != want:
        raise RuntimeError(f"tp {name}: launches {out['launches']} over prefill and {TP_STEPS} decode steps; "
                           f"{want} required")
    out["decode_step_ms"] = spread(step_ms[1:])
    if one:
        out["parity"] = []
        for stage, (g, w) in enumerate(zip(got, one)):
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            cos = float(torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0))
            out["parity"].append(dict(stage="prefill" if stage == 0 else f"decode {stage}", max_abs_err=err,
                                      max_logit=scale, rel_err=err / scale, cosine=cos))
            if not torch.isfinite(g).all() or err > 5e-2 * scale or cos < 0.999:
                raise RuntimeError(f"tp {name} {out['parity'][-1]['stage']}: the mesh's logits differ from one "
                                   f"process by {err} (largest logit {scale}, cosine {cos})")
    del lm, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _one_process_step(arch, n: int = 10) -> dict:
    """Eager full-batch decode steps of the one-process model at phase 9's
    depth (keyed weights, all experts), host clock around each synchronised
    step, and its MoE layers' device time (CUDA events): the EP step's
    comparison.  Its weights are freed after."""
    import numpy as np
    import torch

    from repro_torch.models import LM

    lm = LM(arch, torch.bfloat16, "cuda")
    params = lm.init(seed=0, keyed=True)
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(4)
    cache = lm.init_cache(EP_SLOTS, EP_MAX_SEQ)
    pos = torch.as_tensor(rng.integers(128, 513, EP_SLOTS), dtype=torch.int32, device="cuda")
    tok = torch.as_tensor(rng.integers(0, arch.vocab_size, (EP_SLOTS, 1)), dtype=torch.int32, device="cuda")
    probe = EPProbe(torch.device("cuda"))
    step_ms, moe_ms = [], []
    with _env(REPRO_FUSED_SWIGLU="1"):
        for i in range(n + 2):
            t0 = time.perf_counter()
            _, cache, aux = lm.decode_step(params, {"tokens": tok, "position": pos + i}, cache)
            torch.cuda.synchronize()
            rec = probe.end_step("decode", aux, EP_SLOTS, slice(None), time.perf_counter() - t0)
            if i >= 2:
                step_ms.append(rec["step_ms"])
                moe_ms.append(rec["moe_ms"])
    probe.remove()
    del lm, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"weights_gb": weights_gb, "step_ms": spread(step_ms), "moe_ms": spread(moe_ms)}


def phase_ep_kernels(arch, parent=None) -> dict:
    """The fused head and tail at the all-to-all layout's decode shape on
    one rank of the (1, 8) mesh: G = 16 local experts x 8 source segments
    of ``capacity(1)`` rows, the groups sharing the 16 experts' weights
    through ``rhs_of_group``.  Live segments follow one decode step's
    routing of 8 tokens (one from each source rank); the head row puts
    every live segment in the head, the tail row streams every live row.
    Each is held against its plain version and timed against ``torch.bmm``
    SwiGLU on the gathered weights; the bound counts each live expert's
    weights once, as ``weight_of_group`` charges them."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import capacity

    dev = torch.device("cuda")
    bf = torch.bfloat16
    ep = EP_SHAPE[1]
    E, K, Fd, N = arch.moe.n_experts, arch.d_model, arch.moe.d_expert, arch.d_model
    E_loc = E // ep
    G, C = E_loc * ep, capacity(1, arch.moe, E)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    rng = np.random.default_rng(9)
    seg = np.zeros((E_loc, ep), np.int64)  # (local expert, source rank): rows
    for s in range(ep):
        chosen = rng.choice(E, size=arch.moe.top_k, replace=False)
        seg[chosen[chosen < E_loc], s] = 1
    sizes_np = seg.reshape(G)
    live_experts = int((seg.sum(1) > 0).sum())
    rows = int(sizes_np.sum())
    wg, wu = rnd((E_loc, K, Fd), K**-0.5), rnd((E_loc, K, Fd), K**-0.5)
    wd = rnd((E_loc, Fd, N), Fd**-0.5)
    rhs = torch.arange(E_loc, dtype=torch.int32, device=dev).repeat_interleave(ep)
    sizes = torch.as_tensor(sizes_np, dtype=torch.int32, device=dev)
    buf = rnd((G, C, K)) * (torch.arange(C, device=dev)[None, :, None] < sizes[:, None, None])
    dead = torch.arange(C, device=dev)[None, :] >= sizes[:, None]
    idx = rhs.long()
    results = {}

    want = ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, sizes, rhs)
    err = _repeat_compare("swiglu_gmm_capacity at the a2a segment shape",
                          lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, sizes, rhs), want, zero_rows=dead)

    def library_head():
        h = F.silu(torch.bmm(buf, wg[idx])) * torch.bmm(buf, wu[idx])
        return torch.bmm(h, wd[idx]) * (~dead)[..., None]

    results["swiglu_gmm_capacity"] = dict(
        max_abs_err=err,
        host_us=host_us(lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, sizes, rhs)),
        **timings(ms=lambda: ops.swiglu_gmm_capacity(buf, wg, wu, wd, sizes, rhs),
                  plain_ms=lambda: ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, sizes, rhs),
                  library_ms=library_head),
        bytes=live_experts * 3 * K * Fd * 2 + rows * K * 2 + G * C * N * 2 + 2 * G * 4,
        flops=2 * rows * 3 * K * Fd,
        shape=f"buf ({G},{C},{K}) over {E_loc} experts' weights through rhs_of_group, "
              f"{int((sizes_np > 0).sum())} live segments of {live_experts} experts, {rows} live rows",
    )
    toks = buf[:, 0]
    valid = sizes.clone()
    want = ref.fused_swiglu_gemv_ref(toks.contiguous(), wg, wu, wd, rhs, valid)
    err = _repeat_compare("swiglu_gemv at the a2a segment shape",
                          lambda: ops.swiglu_gemv(toks, wg, wu, wd, rhs, valid), want, zero_rows=valid == 0)

    def library_tail():
        h = F.silu(torch.bmm(toks[:, None], wg[idx])) * torch.bmm(toks[:, None], wu[idx])
        return torch.bmm(h, wd[idx])[:, 0] * valid[:, None]

    a2a_bytes = live_experts * 3 * K * Fd * 2 + rows * K * 2 + G * N * 2 + G * 8
    results["swiglu_gemv"] = dict(
        max_abs_err=err,
        host_us=host_us(lambda: ops.swiglu_gemv(toks, wg, wu, wd, rhs, valid)),
        clean_l2_ms=spread(time_samples(lambda: ops.swiglu_gemv(toks, wg, wu, wd, rhs, valid),
                                        flush_by="read")),
        read_floor_ms=_read_floor(a2a_bytes),
        **timings(ms=lambda: ops.swiglu_gemv(toks, wg, wu, wd, rhs, valid),
                  plain_ms=lambda: ref.fused_swiglu_gemv_ref(toks, wg, wu, wd, rhs, valid),
                  library_ms=library_tail),
        bytes=a2a_bytes,
        flops=2 * rows * 3 * K * Fd,
        shape=f"tokens ({G},{K}) of the segments' first rows, eids over {E_loc} experts, {rows} valid rows "
              f"of {live_experts} experts",
    )
    if parent is not None:
        results["swiglu_gemv"]["parent"] = dict(a2a=in_turns(
            lambda: parent["swiglu_gemv"](toks, wg, wu, wd, rhs, valid),
            lambda: ops.swiglu_gemv(toks, wg, wu, wd, rhs, valid)))
    for name, r in results.items():
        _log_row(f"{name}{EP_SUFFIX}", r)
        _log_turns(f"{name}{EP_SUFFIX}", r)
    r = results["swiglu_gemv"]
    log(f"kernel swiglu_gemv{EP_SUFFIX}: with the L2 flushed by a read {r['clean_l2_ms']['median']:.4f} ms; "
        f"a plain read of its bound's bytes (torch.amax) {r['read_floor_ms']['median']:.4f} ms")
    del wg, wu, wd
    torch.cuda.empty_cache()
    return {f"{name}{EP_SUFFIX}": dict(r, kernel=name) for name, r in results.items()}


def _check_runs(ranks: list, runs, card: str) -> dict:
    """The checks across the ranks of each phase-9 run ``(run, ep)``: equal
    counts on every step; the ranks' drops, each data row's counted once,
    adding up to the global count; with replicated dispatch the rows and
    dispatch drops of the ranks holding an expert adding up to the
    assignments routed to it; with the all-to-all the rows lost before the
    exchange the sources' drops; the same tokens on every rank; head and
    tail rows.  Returns each run's summary, and logs it."""
    out = {}
    for run, ep in runs:
        recs = [r["runs"][run]["steps"] for r in ranks]
        for i, step in enumerate(zip(*recs)):
            if any(not (s["counts"] == step[0]["counts"]).all() for s in step[1:]):
                fail(f"{run} step {i}: the ranks report different counts")
            local_drops = sum(s["disp_drop"] + s["exec_drop"] for s in step) / step[0]["copies"]
            if local_drops != step[0]["dropped"]:
                fail(f"{run} step {i}: the ranks' drops add up to {local_drops}, the global count is "
                     f"{step[0]['dropped']}")
            if ep == "a2a" and sum(s["routed_local"] - s["arrived"] for s in step) != sum(
                    s["disp_drop"] for s in step):
                fail(f"{run} step {i}: the rows lost before the exchange are not the sources' drops")
            if ep != "a2a":
                for m in {r["model_index"] for r in ranks}:
                    held = [s for r, s in zip(ranks, step) if r["model_index"] == m]
                    if sum(s["arrived"] + s["disp_drop"] for s in held) != held[0]["copies"] * held[0]["routed_local"]:
                        fail(f"{run} step {i}: the rows and dispatch drops of model rank {m}'s data ranks "
                             f"do not add up to the {held[0]['routed_local']} assignments routed to its experts")
        if any(r["runs"][run]["tokens"][-1].tolist() != ranks[0]["runs"][run]["tokens"][-1].tolist()
               for r in ranks):
            fail(f"{run}: the ranks generated different tokens")
        dec = [[s for s in rr if s["kind"] == "decode"] for rr in recs]
        pre = [s for s in recs[0] if s["kind"] == "prefill"]
        summary = {
            "launches_rank0": ranks[0]["runs"][run]["launches"],
            "decode_step_ms": spread([s["step_ms"] for rr in dec for s in rr[2:]]),
            "decode_moe_ms": spread([s["moe_ms"] for rr in dec for s in rr[2:]]),
            "decode_coll_ms": spread([s["coll_ms"] for rr in dec for s in rr[2:]]),
            "prefill_ms": [s["step_ms"] for s in pre],
            "head_rows": sum(s["head"] for rr in recs for s in rr),
            "tail_rows": sum(s["tail"] for rr in recs for s in rr),
            "dropped": sum(s["dropped"] for s in recs[0]),
            "routed": sum(int(s["counts"].sum()) for s in recs[0]),
            "wall_s": max(r["runs"][run]["wall_s"] for r in ranks),
        }
        if summary["head_rows"] == 0 or summary["tail_rows"] == 0:
            fail(f"{run}: the head or the tail never had a row ({summary})")
        out[run] = summary
        n_steps = len(dec[0])
        log(f"ep {run}: decode step {summary['decode_step_ms']['median']:.1f} ms "
            f"({summary['decode_step_ms']['min']:.1f}-{summary['decode_step_ms']['max']:.1f}, host clock, all "
            f"ranks, steps 3-{n_steps}), a rank's MoE layers {summary['decode_moe_ms']['median']:.1f} ms "
            f"(CUDA events), its collectives {summary['decode_coll_ms']['median']:.1f} ms (host clock); "
            f"prefill {min(summary['prefill_ms'] or [0]):.0f}-{max(summary['prefill_ms'] or [0]):.0f} ms a "
            f"prompt; head rows {summary['head_rows']}, tail rows {summary['tail_rows']}, dropped "
            f"{summary['dropped']} of {summary['routed']}; rank 0 launches {summary['launches_rank0']}; run "
            f"{summary['wall_s']:.1f} s | {card}")
    return out


def _log_groups(what: str, groups: dict, predicted: str) -> None:
    log(f"{what}: " + ", ".join(f"{k} {v:.3f}" for k, v in groups.items())
        + f" GB, in all {sum(groups.values()):.3f} GB (predicted from the shapes: {predicted})")


def phase_ep(card: str) -> dict:
    """Phase 9: qwen3-moe at full width, cut to ``EP_LAYERS`` layers, as a
    (1, 8) mesh of ranks spawned by ``run_on_mesh``; on one card all eight
    share it on gloo, on eight or more each has its own on NCCL.  Every
    rank draws its 16 experts (and the replicated rest) keyed from seed 0,
    runs the four ``EP_RUNS`` with their checks and the 2-layer parity; a
    rank that fails fails the phase.  Then the checks across ranks: equal
    counts on every step, and the ranks' drops adding up to the global
    drop count.  Then tensor parallelism on a (2, 4) mesh (``_tp_phase``)."""
    import torch

    from repro_torch.launch.mesh import run_on_mesh

    world = EP_SHAPE[0] * EP_SHAPE[1]
    arch = ep_arch()
    if torch.cuda.device_count() >= world:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(world)]
        layout = f"one card per rank on nccl ({torch.cuda.device_count()} cards)"
    else:
        backend, devices = "gloo", "cuda:0"
        layout = (f"all {world} ranks share cuda:0 on gloo: every collective is staged through host "
                  "memory, so its times say nothing of NVLink")
    log(f"expert parallelism: {arch.name} full width (d_model {arch.d_model}, {arch.moe.n_experts} experts "
        f"top-{arch.moe.top_k}, d_expert {arch.moe.d_expert}, {arch.attn.n_heads} heads on "
        f"{arch.attn.n_kv_heads} kv heads), {arch.n_layers} of 48 layers, a {EP_SHAPE} mesh: "
        f"{arch.moe.n_experts // EP_SHAPE[1]} experts a rank, sequence-parallel decode over "
        f"{EP_MAX_SEQ // EP_SHAPE[1]} of {EP_MAX_SEQ} positions a rank; {layout}")
    t0 = time.perf_counter()
    one = _one_process_step(arch)
    one["wall_s"] = time.perf_counter() - t0
    log(f"expert parallelism: one process at {arch.n_layers} layers ({one['weights_gb']:.1f} GB of weights): "
        f"eager full-batch decode step {one['step_ms']['median']:.1f} ms ({one['step_ms']['min']:.1f}-"
        f"{one['step_ms']['max']:.1f}), MoE layers {one['moe_ms']['median']:.1f} ms of device time | {card}")
    t0 = time.perf_counter()
    try:
        ranks = run_on_mesh(_ep_rank, EP_SHAPE, backend, devices, args=(arch.n_layers,), timeout_s=600)
    except Exception as e:  # a rank's failure, with its traceback
        fail(f"phase 9 (expert parallelism): {e}")
    out = {"backend": backend, "layout": layout, "wall_s": time.perf_counter() - t0, "one_process": one,
           "ranks": [], "runs": _check_runs(ranks, [(run, ep) for run, ep, _, _ in EP_RUNS], card)}
    for r in ranks:
        out["ranks"].append({k: r[k] for k in ("rank", "init_s", "weights_gb", "peak_gb", "card_used_gb",
                                               "parity_s")})
    par = out["parity"] = ranks[0]["parity"]
    log(f"ep memory: a rank's weights {ranks[0]['weights_gb']:.2f} GB, peak {max(r['peak_gb'] for r in ranks):.2f} "
        f"GB; the card's used memory after the runs {max(r['card_used_gb'] for r in ranks):.1f} GB; rank init "
        f"{max(r['init_s'] for r in ranks):.1f} s, parity {max(r['parity_s'] for r in ranks):.1f} s; the "
        f"one-process step {one['wall_s']:.1f} s; the ranks' wall {out['wall_s']:.1f} s")
    log(f"ep parity, 2-layer slice as a (1, 8) mesh against one process: " + ", ".join(
        f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in par.items()
        if not k.startswith("int8")))
    log(f"ep int8 KV, rank 0: first layer's attention, relative error per step "
        + ", ".join(f"{a:.4f}" for a in par["int8_attention_rel"]) + " (bound 0.03); the 2-layer logits "
        "(relative error, routed alike) per step " + ", ".join(f"({a:.4f}, {b})" for a, b in par["int8_steps"]))
    ratio = out["runs"]["psum_fused"]["decode_step_ms"]["median"] / one["step_ms"]["median"]
    out["ep_over_one_process"] = ratio
    log(f"ep psum_fused decode step over the one-process eager step at {arch.n_layers} layers: x{ratio:.2f} "
        f"({layout}) | {card}")
    out["by_group"] = ranks[0]["by_group"]
    _log_groups(f"ep {EP_SHAPE} memory, rank 0's weights by group (tensor parallel: the vocabulary only)",
                out["by_group"], "experts 1.812, attention 0.453, embedding/logits 0.156, in all 2.42; "
                "3.52 with the vocabulary whole")
    out["tp"] = _tp_phase(card, arch, backend, devices, layout)
    return out


def _tp_phase(card: str, arch, backend: str, devices, layout: str) -> dict:
    """Tensor parallelism: eight ranks as a (2, 4) mesh (``_tp_rank``), the
    checks of the (1, 8) runs across ranks, a rank's weights by group, the
    decode step and its collectives on the host clock, and the two 2-layer
    parities (qwen3, deepseek-v2) against one process."""
    from repro_torch.launch.mesh import run_on_mesh

    m = TP_SHAPE[1]
    log(f"tensor parallelism: {arch.name} at {arch.n_layers} layers on a {TP_SHAPE} mesh, {EP_SLOTS} slots over "
        f"{TP_SHAPE[0]} data rows, attention split by heads ({arch.attn.n_heads // m} heads on "
        f"{arch.attn.n_kv_heads // m} kv head a rank), the vocabulary {m} ways, "
        f"{arch.moe.n_experts // m} experts a rank; {layout}")
    t0 = time.perf_counter()
    try:
        ranks = run_on_mesh(_tp_rank, TP_SHAPE, backend, devices, args=(arch.n_layers,), timeout_s=600)
    except Exception as e:  # a rank's failure, with its traceback
        fail(f"phase 9 (tensor parallelism): {e}")
    out = {"wall_s": time.perf_counter() - t0, "runs": _check_runs(ranks, [(TP_RUN, "psum")], card),
           "ranks": [{k: r[k] for k in ("rank", "init_s", "weights_gb", "peak_gb", "card_used_gb", "parity_s")}
                     for r in ranks]}
    if not all(r["tp"] and r["deepseek"]["tp"] for r in ranks):
        fail("tensor parallelism: attention is not split by heads on the (2, 4) mesh")
    out["by_group"] = ranks[0]["by_group"]
    _log_groups(f"tp {TP_SHAPE} memory, rank 0's qwen3 weights by group", out["by_group"],
                "experts 3.62, attention 0.11, embedding/logits 0.31, in all ~4.05; ~5.32 without tensor "
                "parallelism")
    ds = out["deepseek"] = {k: ranks[0]["deepseek"][k] for k in ("weights_gb", "by_group", "init_s", "parity_s")}
    _log_groups(f"tp {TP_SHAPE} memory, rank 0's deepseek-v2 2-layer slice by group", ds["by_group"],
                "about 10.3 GB in all over the 8 ranks")
    for name, par in (("qwen3", ranks[0]["parity"]), ("deepseek-v2", ranks[0]["deepseek"]["parity"])):
        out[f"parity_{name}"] = par
        log(f"tp parity, {name} 2-layer slice as a {TP_SHAPE} mesh against one process: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in par.items()))
    fams = out["families"] = {}
    for name, _ in TP_FAMILIES:
        r0 = ranks[0]["families"][name]
        if r0["tp"] != (name != "rwkv6-7b"):
            fail(f"tensor parallelism: {name}'s attention split by heads is {r0['tp']} on the (2, 4) mesh")
        fams[name] = dict({k: r0[k] for k in ("weights_gb", "by_group", "init_s", "prefill_ms", "decode_step_ms",
                                               "parity")}, launches_rank0=r0["launches"],
                          decode_step_ms_ranks=[r["families"][name]["decode_step_ms"]["median"] for r in ranks])
        _log_groups(f"tp {TP_SHAPE} memory, rank 0's {name} slice by group", r0["by_group"], TP_FAM_PREDICTED[name])
        worst = max(r0["parity"], key=lambda e: e["rel_err"])
        log(f"tp {name}: rank 0's weights allocated {r0['weights_gb']:.3f} GB; prefill of {TP_FAM_SLOTS} x "
            f"{TP_FAM_PROMPT} tokens {r0['prefill_ms']:.1f} ms, decode step "
            f"{r0['decode_step_ms']['median']:.1f} ms ({r0['decode_step_ms']['min']:.1f}-"
            f"{r0['decode_step_ms']['max']:.1f}, rank 0, host clock, gloo), rank 0 launches {r0['launches']}; "
            f"against one process over prefill and {TP_STEPS} steps the worst max |err| {worst['max_abs_err']:.4g} "
            f"(relative {worst['rel_err']:.4g}, {worst['stage']}), the lowest cosine "
            f"{min(e['cosine'] for e in r0['parity']):.6f} | {card}")
    out["training"] = _check_mesh_training(ranks, card)
    run = out["runs"][TP_RUN]
    log(f"tp {TP_RUN}: decode step {run['decode_step_ms']['median']:.1f} ms, a rank's collectives "
        f"{run['decode_coll_ms']['median']:.1f} ms (host clock, gloo through host memory: not NVLink); rank "
        f"init {max(r['init_s'] for r in ranks):.1f} s, qwen3 parity {max(r['parity_s'] for r in ranks):.1f} s, "
        f"deepseek-v2 init {ds['init_s']:.1f} s and parity {ds['parity_s']:.1f} s; the ranks' wall "
        f"{out['wall_s']:.1f} s | {card}")
    return out


def _check_mesh_training(ranks: list, card: str) -> dict:
    """The checks across the ranks of ``_tp_train``: the same finite,
    falling losses on every rank, no kernel launched, a replicated leaf's
    bits equal on every rank and a split leaf's on every rank of its model
    index, global rank 0's float32 check; then the step's split, logged."""
    import numpy as np

    trains = [r["training"] for r in ranks]
    t0 = trains[0]
    losses = t0["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"mesh training: the loss is not finite and falling: {losses}")
    if any(t["losses"] != losses for t in trains):
        fail(f"mesh training: the ranks report different losses: {[t['losses'] for t in trains]}")
    if any(t["launches"] for t in trains):
        fail(f"mesh training: the training path launched the port's kernels: {[t['launches'] for t in trains]}")
    n_split = 0
    for i, (name, split, _) in enumerate(t0["digests"]):
        n_split += split
        for t in trains:
            if (not split or t["model_index"] == t0["model_index"]) and t["digests"][i][2] != t0["digests"][i][2]:
                fail(f"mesh training: leaf {name} ({'split' if split else 'replicated'}) differs between global "
                     f"rank 0 and the rank at (data {t['data_index']}, model {t['model_index']})")
    f32 = t0["f32_check"]
    keys = ("loss_and_grads", "data_parallel_reduce", "clip_and_compression", "adamw")
    split_ms = {k: max(t["split_ms"][k] for t in trains) for k in keys + ("collectives",)}
    step_ms = max(sum(t["split_ms"][k] for k in keys) for t in trains)
    out = {"losses": losses, "f32_check": f32, "f32_s": max(t["f32_s"] for t in trains),
           "init_s": max(t["init_s"] for t in trains), "peak_gb": [t["peak_gb"] for t in trains],
           "split_ms_rank0": t0["split_ms"], "last_step_ms": step_ms, "last_step_split_ms": split_ms,
           "collectives_share": split_ms["collectives"] / step_ms, "leaves": len(t0["digests"]), "split_leaves": n_split}
    log(f"mesh training: qwen3-moe full width, {MESH_TRAIN_LAYERS} layer, on the {TP_SHAPE} mesh, "
        f"{MESH_TRAIN_ROWS} x {MESH_TRAIN_SEQ} tokens a data row, bf16, remat, int8 compression, AdamW lr "
        f"{MESH_TRAIN_LR}: loss by step " + ", ".join(f"{x:.4f}" for x in losses) + f"; {n_split} of "
        f"{out['leaves']} leaves split, replicated leaves bitwise equal over the model ranks and every leaf over "
        f"the data ranks; float32 gradients against one process's per-row mean on rank 0: worst relative max "
        f"|err| {f32['rel_err']:.4g} ({f32.get('leaf', '-')}), lowest cosine {f32['cosine']:.6f} over "
        f"{f32['leaves']} leaves ({out['f32_s']:.1f} s)")
    log(f"mesh training: last step {step_ms:.1f} ms (the slowest rank, host clock, device synchronised at each "
        "phase): " + ", ".join(f"{k} {split_ms[k]:.1f} ms" for k in keys) + f"; collectives {split_ms['collectives']:.1f}"
        f" ms (share {out['collectives_share']:.3f}; gloo through host memory: not NVLink); peak allocated "
        f"{max(out['peak_gb']):.2f} GB a rank, init {out['init_s']:.1f} s | {card}")
    return out


def phase_tp_kernels() -> dict:
    """Phase 3's rows of the dense decode-attention kernel at a
    tensor-parallel rank's decode shape: qwen3's attention on a (2, 4) mesh,
    4 slots of a data row, 8 heads on one kv head, dh 128, at lengths in the
    middle of the (2, 4) run's decode (row 3f); zamba2's shared attention
    (8 heads on 8 kv heads, dh 112; row 3g) and whisper's decoder (2 on 2,
    dh 64; row 3h) on the same mesh, 2 slots of a data row over the
    families' cache of ``TP_FAM_PROMPT + TP_STEPS`` positions."""
    import numpy as np

    from repro_torch.configs import get_arch

    lens = [len(p) + TP_STEPS // 2 for p in _ep_prompts(ep_arch())[: EP_SLOTS // TP_SHAPE[0]]]
    rows = _attention_instance(TP_ROW, EP_SLOTS // TP_SHAPE[0], 8, 1, 128, ("dense",), seed=8,
                               serving=np.asarray(lens))
    B, T, m = TP_FAM_SLOTS // TP_SHAPE[0], TP_FAM_PROMPT + TP_STEPS, TP_SHAPE[1]
    fam_lens = np.full(B, TP_FAM_PROMPT + TP_STEPS // 2)
    for (name, _), seed in zip(TP_FAMILIES, (112, 113, 64)):
        if name in TP_FAM_ROWS:
            a = get_arch(name).attn
            rows.update(_attention_instance(TP_FAM_ROWS[name], B, a.n_heads // m, a.n_kv_heads // m, a.d_head,
                                            ("dense",), seed=seed, T=T, serving=fam_lens))
    for name, r in rows.items():
        del r["entry"]
        _log_row(name, r)
    return rows


# ---------------------------------------------------------------------------


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="the parent commit's kernels/csrc directory: time its decode attention, fused "
                         "tail and grouped matmul in turns beside the new ones (phases 3 and 9)")
    args = ap.parse_args()
    t0, elapsed = time.perf_counter(), {}

    def done(phase: str) -> None:
        """Log and keep the script's elapsed seconds at the end of ``phase``."""
        elapsed[phase] = time.perf_counter() - t0
        log(f"[{elapsed[phase]:.1f} s] {phase} done")

    card = phase_device()
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.configs import get_arch

    from repro_torch.serving import BatchingConfig

    arch = get_arch("qwen3-moe-30b-a3b")
    build_info = phase_build()
    done("build")
    parent = load_parent(args.parent_csrc) if args.parent_csrc else None
    kernels = phase_kernels(arch, parent)
    # the four MoE kernels again at deepseek-v2's shapes (phase 7's model)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kernels.update(phase_moe_kernels(deepseek_arch(), gen, DSV2_SUFFIX, parent))
    kernels.update(phase_kernel_instances(arch, parent))
    held = phase_family_shapes()
    done("kernels (phase 3)")
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
    done("qwen3-moe dense (phases 4, 5, 8)")
    with fused_swiglu("0"):
        paged = BatchingConfig(n_slots=8, max_seq=1024, paged=True, page_size=16)
        serve["paged"] = phase_serve(lm, params, paged, PAGED_UNFUSED_PATH)
        serve["paged"].update(phase_reference(lm, params, paged=True))
        serve["paged"]["runtime"] = phase_runtime(lm, params, paged, PAGED_UNFUSED_PATH, kernels)
    serve["in_turns"] = phase_ab(lm, params)
    done("qwen3-moe paged and in turns (phases 4, 5)")
    # qwen3's 61.2 GB of weights go before any other model is built
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"qwen3-moe weights freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    families = phase_families()
    done("families (phase 6)")
    deepseek = phase_deepseek()
    done("deepseek-v2 (phase 7)")
    training = phase_train(card)
    done("training (phase 11)")
    recurrent = phase_recurrent(card)
    done("recurrent families (phase 10)")
    # phase 9 last: its eight ranks share the card once every other model is freed
    kernels.update(phase_ep_kernels(ep_arch(), parent))
    kernels.update(phase_tp_kernels())
    ep = phase_ep(card)
    done("expert parallelism (phase 9)")

    # each kernel's launches come from the run of its own path
    launches = {k: serve["dense"]["launches"][k] for k in DENSE_FUSED_PATH}
    launches.update({k: serve["paged"]["launches"][k] for k in PAGED_UNFUSED_PATH})
    granite = families["granite-3-2b"]
    launches["decode_attention_dh64"] = granite["dense"]["launches"]["decode_attention"]
    launches["decode_attention_paged_dh64"] = granite["paged"]["launches"]["decode_attention_paged"]
    launches["decode_attention_dh112"] = recurrent["zamba2-7b"]["launches"]["decode_attention"]
    launches[f"decode_attention_{WHISPER_ROW}"] = recurrent["whisper-base"]["launches"]["decode_attention"]
    launches.update({f"{k}{DSV2_SUFFIX}": deepseek["fused"]["launches"][k] for k in DSV2_FUSED_PATH})
    launches.update({f"{k}{DSV2_SUFFIX}": deepseek["three_call"]["launches"][k] for k in DSV2_THREE_CALL_PATH})
    launches.update({f"{k}{EP_SUFFIX}": ep["runs"]["a2a_fused"]["launches_rank0"][k] for k in EP_PATHS["1"]})
    launches[f"decode_attention_{TP_ROW}"] = ep["tp"]["runs"][TP_RUN]["launches_rank0"]["decode_attention"]
    for name, tag in TP_FAM_ROWS.items():
        launches[f"decode_attention_{tag}"] = ep["tp"]["families"][name]["launches_rank0"]["decode_attention"]
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
        deepseek=deepseek, training=training, recurrent=recurrent, ep=ep, elapsed_s=elapsed,
        tokens=TOKEN_DIGESTS,
    ), indent=1, default=str))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
