"""Inputs and runs of the mesh-training parity tests
(``tests/test_torch_train_mesh.py``), shared by the JAX side
(``_torch_train_mesh_jax.py``, one subprocess with four host devices) and
the port's ranks (``_torch_train_mesh_ranks.py``, four gloo processes).
numpy only.

The proxies are those of ``_torch_tp_cases`` (qwen3-moe, qwen1.5,
deepseek-v2, zamba2, rwkv6, whisper) and qwen2-vl-7b reduced (the vision
stub's patch embeddings and M-RoPE positions; 4 heads on 2 kv heads, so
attention splits on (2, 2) and stays whole on (1, 4)), on the (1, 4) and
(2, 2) meshes: each run computes the loss and every gradient of one
batch of 4 x 16 tokens.  The train steps of ``STEP_RUNS`` (three steps of AdamW with
clipping, from the same weights) run on a few of them, each compiled step
costing the JAX side seconds: without and with int8 compression and with
two microbatches (each microbatch's two rows split over the two data
ranks) on qwen3-moe's (2, 2) mesh, where the aux loss and the capacity
drops are per data rank; compression on zamba2's (1, 4) mesh (fused
Mamba2 leaves split over the model group); qwen1.5's (1, 4) mesh (tied
embeddings over a padded vocabulary).

The qwen3-moe proxy runs again with the port under ``REPRO_EP_MODE=a2a``
(``A2A``) against the reference's replicated-dispatch body: the
reference's all-to-all body has no gradient (JAX's VJP of its
``all_to_all(split_axis=1, concat_axis=0)`` raises a cotangent-shape
error under ``value_and_grad``).  Both bodies compute the same function
when no assignment is dropped, as here, except the aux loss, which the
all-to-all body takes per token shard: that run sets
``router_aux_coef=0``."""

from __future__ import annotations

import dataclasses

import numpy as np

import _torch_tp_cases as tp_cases

CASES = tp_cases.CASES + tp_cases.RECURRENT_CASES + ("qwen2-vl",)
MESHES = tp_cases.MESHES
BATCH, SEQ, STEPS = 4, 16, 3
FRAMES = tp_cases.FRAMES  # whisper's encoder frames
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
# (run, case, mesh, TrainConfig fields)
STEP_RUNS = (
    ("plain", "qwen3-moe", (2, 2), {}),
    ("int8", "qwen3-moe", (2, 2), {"grad_compression": True}),
    ("micro2", "qwen3-moe", (2, 2), {"n_microbatches": 2}),
    ("int8", "zamba2", (1, 4), {"grad_compression": True}),
    ("plain", "qwen1.5", (1, 4), {}),
)
METRICS = ("loss", "ce", "moe_aux", "dropped", "grad_norm", "lr")
A2A_CASE = "qwen3-moe"


def run_arch(get_arch, case: str, ep=None):
    """The proxy of a run: ``_torch_tp_cases.arch``, with no aux loss in
    the loss of an ``A2A`` run."""
    arch = get_arch("qwen2-vl-7b").reduced() if case == "qwen2-vl" else tp_cases.arch(get_arch, case)
    if ep:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, router_aux_coef=0.0))
    return arch


def runs(names=None) -> list:
    """``(case, mesh shape, REPRO_EP_MODE or None)`` of every run, the a2a
    runs of ``A2A_CASE`` last."""
    names = tuple(names or CASES)
    out = [(case, shape, None) for case in names for shape in MESHES]
    if A2A_CASE in names:
        out += [(A2A_CASE, shape, "a2a") for shape in MESHES]
    return out


def step_runs(case: str, shape, ep=None) -> list:
    """``(run, TrainConfig fields)`` of the train steps of a run."""
    return [(run, kw) for run, c, s, kw in STEP_RUNS if (c, s, ep) == (case, shape, None)]


def key(case: str, shape, ep=None) -> str:
    return f"{case}/{shape[0]}x{shape[1]}" + (f"/{ep}" if ep else "")


def make_batches(case: str, arch) -> dict:
    """``STEPS`` seeded batches of next-token labels (and whisper's stub
    frames; for the VLM its patch embeddings in place of tokens, and their
    M-RoPE positions walking 2 frames of 3 x 3 patches and a text tail),
    as inputs-file entries."""
    rng = np.random.default_rng(CASES.index(case) + 53)
    out = {}
    for i in range(STEPS):
        toks = rng.integers(0, arch.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        out[f"{case}/batch{i}/labels"] = toks[:, 1:]
        if arch.family == "vlm":
            out[f"{case}/batch{i}/embeds"] = (rng.standard_normal((BATCH, SEQ, arch.d_model))).astype(np.float32)
            s = np.minimum(np.arange(SEQ), 18)  # positions 18+ (text) share one stream value
            grid = np.stack([s // 9, s // 3 % 3, s % 3]) + np.maximum(np.arange(SEQ) - 17, 0)
            out[f"{case}/batch{i}/mrope_positions"] = np.ascontiguousarray(
                np.broadcast_to(grid[:, None, :], (3, BATCH, SEQ))).astype(np.int32)
            continue
        out[f"{case}/batch{i}/tokens"] = toks[:, :-1]
        if arch.family == "audio":
            frames = 0.1 * rng.standard_normal((BATCH, FRAMES, arch.d_model))
            out[f"{case}/batch{i}/embeds"] = frames.astype(np.float32)
    return out


def batch(inp: dict, case: str, i: int) -> dict:
    prefix = f"{case}/batch{i}/"
    return {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}
