"""Shared helpers of the ``tests/test_torch_*.py`` files (the PyTorch port
held against the JAX reference)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# float32 comparisons use the repo's tolerance (tests/test_fused_swiglu.py:49):
# the two frameworks sum in different orders, which moves float32 results
# by a few ulps of O(1) values
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def pin_threads() -> None:
    """One intra-op and one inter-op thread: the suite runs in several
    workers on one host beside wall-clock-sensitive JAX tests, and torch
    would otherwise start a thread per core in every worker."""
    torch.set_num_threads(1)
    if torch.get_num_interop_threads() != 1:
        torch.set_num_interop_threads(1)


def proxy_arch(get_arch, expert_exec: str = "dual_path_cost"):
    """The tiny qwen3-moe-30b proxy of benchmarks/moe_bench.py:413
    (_decode_arch), built from either package's ``get_arch``."""
    arch = get_arch("qwen3-moe-30b-a3b")
    return dataclasses.replace(
        arch,
        n_layers=2,
        d_model=128,
        vocab_size=512,
        attn=dataclasses.replace(arch.attn, n_heads=4, n_kv_heads=2, d_head=32),
        moe=dataclasses.replace(
            arch.moe, n_experts=64, top_k=4, d_expert=64,
            expert_exec=expert_exec, dual_tail_tokens=1, dual_max_head=0,
        ),
    )


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def assert_close(got, want, **tol) -> None:
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(tol or F32_TOL))
