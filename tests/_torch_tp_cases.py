"""Inputs of the tensor-parallel parity tests (``tests/test_torch_tp.py``),
shared by the JAX side (``_torch_tp_jax.py``, one subprocess with four
host devices) and the port's ranks (``_torch_tp_ranks.py``, four gloo
processes).  numpy only: every array comes from a seeded generator or
from JAX's ``LM.init`` in the test process.

Three proxies of the reference's configs, each at a size where a (1, 4)
and a (2, 2) mesh between them reach both attention layouts:

* ``qwen3-moe``: the qwen3-moe proxy (4 heads on 2 kv heads, 64 experts):
  on (1, 4) the kv heads do not divide the model group, so attention stays
  whole and decode runs sequence-parallel; on (2, 2) it splits by heads.
* ``qwen1.5``: qwen1.5-0.5b reduced, a dense MHA model with QKV biases,
  a SwiGLU FFN and tied embeddings, with 8 heads and a vocabulary of 250
  (padded to 256): attention splits by heads on both meshes.
* ``deepseek-v2``: deepseek-v2-236b reduced to the dense prefix block and
  two MoE blocks (MLA, 4 heads; 8 experts; 2 shared experts).

The MoE proxies take a capacity no batch here fills: a mesh sizes
capacity per data shard, so only a run with no drops equals one process
(as ``_torch_ep_cases.lm_arch`` sets it)."""

from __future__ import annotations

import dataclasses

import numpy as np

CASES = ("qwen3-moe", "qwen1.5", "deepseek-v2")
MESHES = ((1, 4), (2, 2))
BATCH, PROMPT, MAX_SEQ, STEPS = 4, 8, 16, 3
# a leaf the reference splits over the model axis where the port keeps it
# whole (``repro_torch.models.sharding``: attention splits by whole heads
# only, where the model group divides the kv heads)
REPLICATED_BY_PORT = {
    ("qwen3-moe", (1, 4)): ("attn/wq", "attn/wk", "attn/wv", "attn/wo"),
}


def _no_drops(arch):
    return dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, min_capacity=4096))


def arch(get_arch, case: str):
    """The proxy ``case`` built from either package's ``get_arch``."""
    from _torch_port import proxy_arch

    if case == "qwen3-moe":
        return _no_drops(proxy_arch(get_arch))
    if case == "qwen1.5":
        a = get_arch("qwen1.5-0.5b").reduced(vocab_size=250)
        return dataclasses.replace(a, attn=dataclasses.replace(a.attn, n_heads=8, n_kv_heads=8))
    if case == "deepseek-v2":
        a = get_arch("deepseek-v2-236b").reduced(n_layers=3)
        return _no_drops(dataclasses.replace(a, moe=dataclasses.replace(a.moe, n_shared=2)))
    raise ValueError(case)


def perturb(tree: dict, seed: int) -> dict:
    """The JAX ``LM.init`` tree (numpy) with random QKV biases and norm
    scales in place of its zeros and ones, so a slice of them is a test of
    values, not of constants."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, v in tree.items():
        last = key.rsplit("/", 1)[-1]
        if last in ("bq", "bk", "bv"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif last in ("scale", "q_norm_scale", "kv_norm_scale"):
            v = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        out[key] = v
    return out


def tokens(case: str, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(CASES.index(case) + 29)
    return rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def unit_inputs() -> dict:
    """The vocab-parallel embedding and logits and the row-parallel MLP at
    a small size: a padded table of 256 rows, width 32, d_ff 64."""
    rng = np.random.default_rng(31)
    f32 = np.float32
    return {
        "table": rng.standard_normal((256, 32)).astype(f32),
        "w_out": rng.standard_normal((32, 256)).astype(f32),
        "tokens": rng.integers(0, 256, (4, 8)).astype(np.int64),
        "h": rng.standard_normal((4, 1, 32)).astype(f32),
        "x": rng.standard_normal((4, 8, 32)).astype(f32),
        "w_gate": (rng.standard_normal((32, 64)) * 32**-0.5).astype(f32),
        "w_up": (rng.standard_normal((32, 64)) * 32**-0.5).astype(f32),
        "w_down": (rng.standard_normal((64, 32)) * 64**-0.5).astype(f32),
    }
