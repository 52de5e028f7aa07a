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
(as ``_torch_ep_cases.lm_arch`` sets it).

The recurrent families (``tests/test_torch_tp_recurrent.py``, the same
two scripts run on ``RECURRENT_CASES``): the reduced zamba2-7b (two
segments of the shared attention block and one Mamba2 block, a 1-block
tail; 8 Mamba2 heads), rwkv6-7b (2 blocks of 4 heads, d_ff 128) and
whisper-base (2 encoder and 2 decoder layers over 16 frames), their
attention with as many kv heads as heads (4), as the full configs have
(32 on 32, 8 on 8): every layer splits on both meshes."""

from __future__ import annotations

import dataclasses

import numpy as np

CASES = ("qwen3-moe", "qwen1.5", "deepseek-v2")
RECURRENT_CASES = ("zamba2", "rwkv6", "whisper")
FRAMES = 16  # whisper's encoder frames (its reduced enc_seq)
MESHES = ((1, 4), (2, 2))
BATCH, PROMPT, MAX_SEQ, STEPS = 4, 8, 16, 3
# a leaf the reference splits over the model axis where the port keeps it
# whole (``repro_torch.models.sharding``: attention splits by whole heads
# only, where the model group divides the kv heads)
REPLICATED_BY_PORT = {
    ("qwen3-moe", (1, 4)): ("attn/wq", "attn/wk", "attn/wv", "attn/wo"),
}
# the leaves a rank of a recurrent family holds in the port's own layout,
# not as ``param_pspecs`` shards them (``repro_torch.models.sharding``'s
# docstring), each with the reason
PORT_LAYOUT = {
    "zamba2": {
        "mamba/w_in": "its heads' z, x and dt columns and B/C whole, where param_pspecs cuts the "
                      "fused columns evenly",
        "mamba/conv_w": "its heads' x channels and B/C whole (param_pspecs: whole)",
        "mamba/conv_b": "as conv_w",
        "mamba/A_log": "by head (param_pspecs: whole)",
        "mamba/D": "by head (param_pspecs: whole)",
        "mamba/dt_bias": "by head (param_pspecs: whole)",
        "mamba/norm_scale": "its heads' channels of d_inner (param_pspecs: whole)",
    },
    "rwkv6": {
        "rwkv/wA": "whole, so the decay comes out per head with no sum (param_pspecs: columns)",
        "rwkv/wB": "by its heads' columns (param_pspecs: rows)",
        "rwkv/w0": "by its heads' channels (param_pspecs: whole)",
        "rwkv/ln_x_scale": "by its heads' channels (param_pspecs: whole)",
        "rwkv/w_cr": "whole: its sigmoid gates the whole-width sum of w_cv (param_pspecs: columns)",
    },
    "whisper": {},
}


def _no_drops(arch):
    return dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, min_capacity=4096))


def _mha(a):
    return dataclasses.replace(a, attn=dataclasses.replace(a.attn, n_kv_heads=a.attn.n_heads))


def arch(get_arch, case: str):
    """The proxy ``case`` built from either package's ``get_arch``."""
    from _torch_port import proxy_arch

    if case == "zamba2":
        return _mha(get_arch("zamba2-7b").reduced())
    if case == "rwkv6":
        return get_arch("rwkv6-7b").reduced()
    if case == "whisper":
        return _mha(get_arch("whisper-base").reduced())

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
    """The JAX ``LM.init`` tree (numpy) with random QKV biases, norm scales
    and the recurrent blocks' constant leaves (``_NEAR``) in place of their
    constants, so a slice of them is a test of values, not of constants."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, v in tree.items():
        last = key.rsplit("/", 1)[-1]
        if last in ("bq", "bk", "bv") or last in _NEAR["zero"]:
            v = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif last in ("scale", "q_norm_scale", "kv_norm_scale") or last in _NEAR["one"]:
            v = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        elif last in _NEAR["half"] or last == "w0":
            v = (v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
        out[key] = v
    return out


# the constant leaves of the recurrent families' blocks (LayerNorm biases,
# Mamba2's D, dt_bias and norm scale, RWKV6's token-shift mixes, ln_x
# scale and decay base) near the constant each starts at
_NEAR = {"zero": ("bias", "dt_bias", "conv_b"), "one": ("D", "norm_scale", "ln_x_scale"),
         "half": ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "cmix_k", "cmix_r")}


def tokens(case: str, vocab: int) -> np.ndarray:
    rng = np.random.default_rng((CASES + RECURRENT_CASES).index(case) + 29)
    return rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def frames(d_model: int) -> np.ndarray:
    """Whisper's seeded stub frames (BATCH, FRAMES, d_model)."""
    rng = np.random.default_rng(41)
    return (0.1 * rng.standard_normal((BATCH, FRAMES, d_model))).astype(np.float32)


def prompt(inp: dict, case: str) -> dict:
    """A case's prefill batch from the inputs file: its tokens, and
    whisper's frames."""
    out = {"tokens": inp[f"{case}/tokens"]}
    if f"{case}/embeds" in inp:
        out["embeds"] = inp[f"{case}/embeds"]
    return out


def kv_keys(arch) -> tuple:
    """The cache entries whose leaves have a position axis (axis 2), padded
    from the prompt's positions to the decode cache's: the decoder-only
    families' blocks, zamba2's shared attention, whisper's self-attention
    (rwkv6's states have none)."""
    return {"hybrid": ("attn",), "audio": ("self",), "ssm": ()}.get(arch.family, ("blocks", "prefix"))


def gated_norm_inputs() -> dict:
    """Mamba2's gated RMSNorm and out projection at a small size: d_inner
    64 (4 heads of 16), d_model 32, 6 tokens."""
    rng = np.random.default_rng(43)
    f32 = np.float32
    return {
        "y": rng.standard_normal((2, 3, 64)).astype(f32),
        "z": rng.standard_normal((2, 3, 64)).astype(f32),
        "norm_scale": (1 + 0.1 * rng.standard_normal(64)).astype(f32),
        "w_out": (rng.standard_normal((64, 32)) * 64**-0.5).astype(f32),
    }


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
