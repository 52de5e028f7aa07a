"""Wrappers of the three CUDA kernels, under the JAX wrappers' signatures
(``repro.kernels.ops``; the TPU tile-size and ``interpret`` arguments have
no counterpart here).

A wrapper given CPU tensors runs the kernel's plain version
(:mod:`repro_torch.kernels.ref`).  Given CUDA tensors it checks them,
allocates the outputs and scratch, launches its kernel on the current
stream and raises if the launch failed: it never falls back to the plain
version.  ``LAUNCHES`` counts each wrapper's kernel launches, so a run
can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build, ref

LAUNCHES: Dict[str, int] = {
    "swiglu_gmm_capacity": 0,
    "swiglu_gemv": 0,
    "decode_attention": 0,
}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "fused_swiglu_gmm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fused_swiglu_gemv": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}
# a block's shared-memory ceiling on Hopper (232,448 bytes)
_MAX_SMEM = 232448


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernel(name: str):
    lib = build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def _on_cpu(*tensors) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_bf16(name: str, t: torch.Tensor) -> None:
    _require(t.dtype == torch.bfloat16, f"{name}: CUDA kernels take bfloat16, got {t.dtype}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _check_i32(name: str, t: torch.Tensor, n: int) -> None:
    _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    _require(t.is_contiguous() and tuple(t.shape) == (n,), f"{name} must be a contiguous ({n},)")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def swiglu_gmm_capacity(
    buf: torch.Tensor,  # (G, C, K) capacity-layout dispatch buffer
    wg: torch.Tensor,  # (E, K, F)
    wu: torch.Tensor,  # (E, K, F)
    wd: torch.Tensor,  # (E, F, N)
    group_sizes: torch.Tensor,  # (G,) live rows per group
    rhs_of_group: Optional[torch.Tensor] = None,  # (G,) weight row per group
) -> torch.Tensor:
    """Single-pass SwiGLU over the capacity slab -> (G, C, N); rows at or
    past ``group_sizes[g]`` are zero and dead tiles read no weights."""
    if _on_cpu(buf, wg, wu, wd, group_sizes, rhs_of_group):
        return ref.fused_swiglu_gmm_ref(buf, wg, wu, wd, group_sizes, rhs_of_group)
    G, C, K = buf.shape
    E, _, F = wg.shape
    N = wd.shape[2]
    for name, t in (("buf", buf), ("wg", wg), ("wu", wu), ("wd", wd)):
        _check_bf16(name, t)
    _require(wg.shape == (E, K, F) and wu.shape == wg.shape and wd.shape == (E, F, N),
             f"weight shapes {tuple(wg.shape)} {tuple(wu.shape)} {tuple(wd.shape)} "
             f"do not match buf {tuple(buf.shape)}")
    _require(K % 128 == 0 and F % 64 == 0 and N % 128 == 0,
             f"swiglu_gmm_capacity needs K % 128, F % 64, N % 128 == 0; got {K}, {F}, {N}")
    _check_i32("group_sizes", group_sizes, G)
    if rhs_of_group is not None:
        _check_i32("rhs_of_group", rhs_of_group, G)
    lib, fn = _kernel("fused_swiglu_gmm")
    lib.fused_swiglu_gmm_smem_bytes.argtypes = [_I]
    smem = lib.fused_swiglu_gmm_smem_bytes(K)
    _require(smem <= _MAX_SMEM, f"K={K} needs {smem} B of shared memory per block")
    partial = torch.empty((F // 64, G, C, N), dtype=torch.float32, device=buf.device)
    out = torch.empty((G, C, N), dtype=buf.dtype, device=buf.device)
    rc = fn(_ptr(buf), _ptr(wg), _ptr(wu), _ptr(wd), _ptr(group_sizes),
            _ptr(rhs_of_group), _ptr(partial), _ptr(out), G, C, K, F, N, _stream(buf))
    _raise_on(lib, rc, "fused_swiglu_gmm")
    LAUNCHES["swiglu_gmm_capacity"] += 1
    return out


def swiglu_gemv(
    tokens: torch.Tensor,  # (S, K), unit stride along K
    wg: torch.Tensor,  # (E, K, F)
    wu: torch.Tensor,  # (E, K, F)
    wd: torch.Tensor,  # (E, F, N)
    expert_ids: torch.Tensor,  # (S,)
    valid: Optional[torch.Tensor] = None,  # (S,) 1 = live row
) -> torch.Tensor:
    """Per-row SwiGLU with each row's expert streamed once -> (S, N);
    ``valid=0`` rows are zero and read no weights."""
    S, K = tokens.shape
    if valid is None:
        valid = torch.ones((S,), dtype=torch.int32, device=tokens.device)
    if _on_cpu(tokens, wg, wu, wd, expert_ids, valid):
        return ref.fused_swiglu_gemv_ref(tokens, wg, wu, wd, expert_ids, valid)
    E, _, F = wg.shape
    N = wd.shape[2]
    _require(tokens.dtype == torch.bfloat16 and tokens.stride(1) == 1,
             "tokens must be bfloat16 with unit stride along K")
    for name, t in (("wg", wg), ("wu", wu), ("wd", wd)):
        _check_bf16(name, t)
    _require(wg.shape == (E, K, F) and wu.shape == wg.shape and wd.shape == (E, F, N),
             "weight shapes do not match tokens")
    _require(F % 64 == 0 and N % 8 == 0, f"swiglu_gemv needs F % 64, N % 8 == 0; got {F}, {N}")
    _check_i32("expert_ids", expert_ids, S)
    _check_i32("valid", valid, S)
    lib, fn = _kernel("fused_swiglu_gemv")
    partial = torch.empty((F // 64, S, N), dtype=torch.float32, device=tokens.device)
    out = torch.empty((S, N), dtype=tokens.dtype, device=tokens.device)
    rc = fn(_ptr(tokens), tokens.stride(0), _ptr(wg), _ptr(wu), _ptr(wd),
            _ptr(expert_ids), _ptr(valid), _ptr(partial), _ptr(out),
            S, K, F, N, _stream(tokens))
    _raise_on(lib, rc, "fused_swiglu_gemv")
    LAUNCHES["swiglu_gemv"] += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    cache_k: torch.Tensor,  # (B, T, Kv, dh)
    cache_v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) valid entries per sequence
) -> torch.Tensor:
    """Flash-decode over a dense per-slot cache -> (B, H, dh); positions at
    or past ``lengths[b]`` are masked and length-0 rows are zero."""
    if _on_cpu(q, cache_k, cache_v, lengths):
        return ref.decode_attention_ref(q, cache_k, cache_v, lengths)
    B, H, dh = q.shape
    _, T, Kv, _ = cache_k.shape
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        _check_bf16(name, t)
    _require(cache_v.shape == cache_k.shape and cache_k.shape[0] == B and cache_k.shape[3] == dh,
             "cache shapes do not match q")
    _require(dh == 128 and H % Kv == 0 and H // Kv <= 16,
             f"decode_attention needs dh == 128 and H/Kv <= 16; got dh={dh}, H={H}, Kv={Kv}")
    _check_i32("lengths", lengths, B)
    lib, fn = _kernel("decode_attention")
    out = torch.empty_like(q)
    rc = fn(_ptr(q), _ptr(cache_k), _ptr(cache_v), _ptr(lengths), _ptr(out),
            B, T, Kv, H // Kv, dh, 1.0 / dh**0.5, _stream(q))
    _raise_on(lib, rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
