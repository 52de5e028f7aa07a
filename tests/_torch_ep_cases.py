"""Inputs of the expert-parallel parity tests (``tests/test_torch_ep.py``),
shared by the JAX side (``_torch_ep_jax.py``, one subprocess with four
host devices) and the port's ranks (``_torch_ep_ranks.py``, four gloo
processes).  numpy only: every array comes from one seeded generator."""

from __future__ import annotations

import dataclasses

import numpy as np

EXEC_MODES = ("dense", "dual_path", "dual_path_cost")
EP_MODES = ("psum", "a2a")
# (mesh shape, EP body) of the whole-slice runs: (1, 4) decodes
# sequence-parallel (2 kv heads on 4 model ranks), (2, 2) splits the batch
LM_RUNS = (((1, 4), "psum"), ((1, 4), "a2a"), ((2, 2), "psum"), ((2, 2), "a2a"))
MOE_BATCH = (4, 8)  # (B, S) of the moe_block runs on the (2, 2) mesh
SEQPAR = dict(B=4, T=32, d=64, heads=8, kv_heads=2, d_head=16)
LM_BATCH, LM_PROMPT, LM_MAX_SEQ, LM_STEPS = 4, 8, 16, 3
INT8_STEPS = 6


def moe_arch(get_arch, mode: str):
    """The qwen3-moe proxy (64 experts top-4, d_model 128) on ``mode``."""
    from _torch_port import proxy_arch

    return proxy_arch(get_arch, mode)


def lm_arch(get_arch):
    """The proxy with a capacity no batch here fills: the all-to-all body
    sizes capacity per source rank and the replicated body per data shard,
    so only a run with no drops equals one process (as the JAX EP tests
    set it, ``tests/test_moe.py:125``)."""
    from _torch_port import proxy_arch

    arch = proxy_arch(get_arch)
    return dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, min_capacity=4096))


def make_inputs(d_model: int, d_expert: int, n_experts: int) -> dict:
    rng = np.random.default_rng(25)
    f32 = np.float32
    d, f, E = d_model, d_expert, n_experts
    out = {
        "moe/w_router": (rng.standard_normal((d, E)) * 0.3).astype(f32),
        "moe/w_gate": (rng.standard_normal((E, d, f)) * d**-0.5).astype(f32),
        "moe/w_up": (rng.standard_normal((E, d, f)) * d**-0.5).astype(f32),
        "moe/w_down": (rng.standard_normal((E, f, d)) * f**-0.5).astype(f32),
    }
    # tokens sharing a common direction route alike, so experts overflow
    common = rng.standard_normal((1, 1, d))
    out["moe/x"] = (0.8 * common + 0.6 * rng.standard_normal(MOE_BATCH + (d,))).astype(f32)
    s = SEQPAR
    B, T, H, K, dh = s["B"], s["T"], s["heads"], s["kv_heads"], s["d_head"]
    for name, shape, fan_in in (("wq", (s["d"], H * dh), s["d"]), ("wk", (s["d"], K * dh), s["d"]),
                                ("wv", (s["d"], K * dh), s["d"]), ("wo", (H * dh, s["d"]), H * dh)):
        out[f"sp/{name}"] = (rng.standard_normal(shape) * fan_in**-0.5).astype(f32)
    out["sp/x"] = rng.standard_normal((B, 1, s["d"])).astype(f32)
    out["sp/ck"] = rng.standard_normal((B, T, K, dh)).astype(f32)
    out["sp/cv"] = rng.standard_normal((B, T, K, dh)).astype(f32)
    out["sp/pos"] = np.asarray([5, 0, 31, 17], np.int32)  # one position per rank's slice
    out["sp/ck8"] = rng.integers(-127, 128, (B, T, K, dh)).astype(np.int8)
    out["sp/cv8"] = rng.integers(-127, 128, (B, T, K, dh)).astype(np.int8)
    out["sp/ks"] = (rng.random((B, T, K)) * 0.02 + 1e-3).astype(f32)
    out["sp/vs"] = (rng.random((B, T, K)) * 0.02 + 1e-3).astype(f32)
    out["sp/x_steps"] = rng.standard_normal((INT8_STEPS, B, 1, s["d"])).astype(f32)
    out["lm/tokens"] = rng.integers(0, 512, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    return out


def attn_cfg(AttnConfig):
    s = SEQPAR
    return AttnConfig(kind="gqa", n_heads=s["heads"], n_kv_heads=s["kv_heads"], d_head=s["d_head"],
                      rope_theta=1e4)


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays as ``{"a/b/c": array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of the keys under ``prefix``."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
