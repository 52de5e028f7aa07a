"""Wrappers of the CUDA kernels, under the JAX wrappers' signatures
(``repro.kernels.ops``; the TPU tile-size and ``interpret`` arguments have
no counterpart here).

A wrapper given CPU tensors runs the kernel's plain version
(:mod:`repro_torch.kernels.ref`).  Given CUDA tensors it checks them,
allocates the outputs and scratch, launches its kernel on the current
stream and raises if the launch failed: it never falls back to the plain
version.  ``LAUNCHES`` counts each wrapper's kernel launches, so a run
can show that its path went through the kernels.

The wrappers may be captured into a CUDA graph (the serving engine's
compiled decode step).  The state they keep across calls (each library's
init, ticket counters, scratch buffers) is created by a first call made
outside any capture; creating it inside one raises.  A capture launches
nothing, so :func:`recording_launches` keeps the calls it makes out of
``LAUNCHES`` and :func:`add_launches` counts them once per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build, ref

LAUNCHES: Dict[str, int] = {
    "swiglu_gmm_capacity": 0,
    "swiglu_gemv": 0,
    "decode_attention": 0,
    "decode_attention_split": 0,
    "decode_attention_paged": 0,
    "gmm_capacity": 0,
    "gmm_ragged": 0,
    "expert_gemv": 0,
}
# the head dims the decode-attention kernels have an instance for
# (csrc/decode_split.cuh, with_head_dim)
ATTENTION_HEAD_DIMS = (64, 112, 128)
# query heads per block of those kernels (GMAX in csrc/decode_split.cuh):
# a kv head's larger query groups take ceil(G / this) grid rows
ATTENTION_HEAD_BLOCK = 16

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "fused_swiglu_gmm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fused_swiglu_gemv": [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "decode_attention_split": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "decode_attention_paged": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _F, _P],
    "grouped_gemm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "expert_gemv": [_P, _LL, _P, _P, _P, _P, _I, _I, _I, _P],
}
# the libraries' helper entry points: (argtypes, restype)
_IP, _LLP = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)
_HELPERS = {
    "fused_swiglu_gmm": {
        "fused_swiglu_gmm_init": ([_IP, _IP], ctypes.c_int),
        "fused_swiglu_gmm_scratch": ([_I, _I, _I, _I, _LLP, _LLP, _IP], None),
    },
    "decode_attention": {"decode_attention_splits": ([_I], ctypes.c_int)},
    "decode_attention_split": {"decode_attention_splits": ([_I], ctypes.c_int)},
    "decode_attention_paged": {"decode_attention_splits": ([_I], ctypes.c_int)},
    "grouped_gemm": {
        "grouped_gemm_init": ([_IP, _IP], ctypes.c_int),
        "grouped_gemm_scratch": ([_I, _I, _I, _I, _I, _LLP, _LLP, _IP], None),
        # the ragged layout's launch and scratch, in the same library
        "gmm_ragged": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "gmm_ragged_scratch": ([_I, _I, _I, _I, _I, _I, _LLP, _LLP, _IP, _IP], None),
    },
    "fused_swiglu_gemv": {
        "fused_swiglu_gemv_init": ([_IP, _IP], ctypes.c_int),
        "fused_swiglu_gemv_scratch": ([_I, _I, _I, _I, _LLP, _LLP, _IP], None),
    },
    "expert_gemv": {"expert_gemv_init": ([_IP], ctypes.c_int)},
}
# kernels whose library exports ``<name>_init(int* ...)``, run once per
# device when the library is first used there (never inside a launch,
# which a CUDA graph may capture): the ints it returns
_INIT_OUTS = {
    "fused_swiglu_gmm": ("n_sm", "max_smem"),
    "grouped_gemm": ("n_sm", "max_smem"),
    "fused_swiglu_gemv": ("n_sm", "max_smem"),
    "expert_gemv": ("max_smem",),
}
_INIT: Dict[Tuple[str, int], Dict[str, int]] = {}
# zeroed int32 ticket counters, one buffer per (kernel, device, size); each
# launch leaves its counters at zero again.  One buffer per device assumes
# one stream, as the port uses: two streams sharing it would race.
_TICKETS: Dict[Tuple[str, int, int], torch.Tensor] = {}
# scratch a kernel writes before it reads it back in the same launch, one
# buffer per (kernel, device, shape, dtype), kept across launches: on one
# stream the next launch starts after this one has finished with it
_BUFFERS: Dict[Tuple, torch.Tensor] = {}
_SCRATCH: Dict[Tuple, Tuple[int, ...]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def recording_launches(into: Dict[str, int]):
    """Around a CUDA graph capture: the wrapper calls made inside the block
    are written to ``into`` by kernel, and ``LAUNCHES`` is left as it was
    (a capture launches nothing)."""
    before = dict(LAUNCHES)
    try:
        yield into
    finally:
        for k, n in before.items():
            into[k] = LAUNCHES[k] - n
            LAUNCHES[k] = n


def add_launches(counts: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``counts``."""
    for k, n in counts.items():
        LAUNCHES[k] += n


def _not_capturing(what: str) -> None:
    """State kept across launches must not live in a graph's memory pool,
    which the next replay overwrites: create it by a call outside any
    capture first."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} first created during a CUDA graph capture; "
                           "run the step once outside the capture first")


def _kernel(name: str, device: torch.device):
    """The loaded library and launch function of kernel ``name``; on the
    first use on ``device`` it also runs the library's init entry point
    (``_INIT_OUTS``), whose results ``_INIT`` keeps."""
    lib = build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        for helper, (argtypes, restype) in _HELPERS.get(name, {}).items():
            getattr(lib, helper).argtypes = argtypes
            getattr(lib, helper).restype = restype
    if name in _INIT_OUTS and (name, device.index) not in _INIT:
        _not_capturing(f"{name}_init")
        outs = [ctypes.c_int() for _ in _INIT_OUTS[name]]
        with torch.cuda.device(device):
            rc = getattr(lib, f"{name}_init")(*(ctypes.byref(o) for o in outs))
        _raise_on(lib, rc, f"{name}_init")
        _INIT[(name, device.index)] = {k: o.value for k, o in zip(_INIT_OUTS[name], outs)}
    return lib, fn


def _tickets(name: str, device: torch.device, n: int) -> torch.Tensor:
    key = (name, device.index, n)
    buf = _TICKETS.get(key)
    if buf is None:
        _not_capturing(f"the {name} tickets")
        buf = _TICKETS[key] = torch.zeros((n,), dtype=torch.int32, device=device)
    return buf


def _buffer(name: str, device: torch.device, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    key = (name, device.index, shape, dtype)
    buf = _BUFFERS.get(key)
    if buf is None:
        _not_capturing(f"the {name} scratch")
        buf = _BUFFERS[key] = torch.empty(shape, dtype=dtype, device=device)
    return buf


def _split_scratch(name: str, lib, T: int, q: torch.Tensor, Kv: int):
    """The float32 partials and log-sum-exps of a split decode kernel
    (``csrc/decode_split.cuh``) over sequences of at most ``T`` positions,
    and its ticket counters.  A kv head's G query heads take ceil(G / HB)
    grid rows of at most HB = ``ATTENTION_HEAD_BLOCK`` heads, so the
    scratch has B * Kv * ceil(G / HB) rows of min(G, HB) heads.  The split
    count depends on ``T`` alone (not on dh or the head groups); the
    buffers are keyed by their shape."""
    B, H, dh = q.shape
    G, HB = H // Kv, ATTENTION_HEAD_BLOCK
    key = (name, T)
    if key not in _SCRATCH:
        _SCRATCH[key] = (lib.decode_attention_splits(T),)
    (S,) = _SCRATCH[key]
    rows, heads = B * Kv * -(-G // HB), min(G, HB)
    part = _buffer(name, q.device, (rows, S, heads, dh), torch.float32)
    lse = _buffer(name, q.device, (rows, S, heads), torch.float32)
    return part, lse, _tickets(name, q.device, rows)


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors (the plain version runs); False for CUDA ones,
    which the kernel takes.  A kernel launched through ctypes is invisible
    to autograd, so CUDA tensors that require grad while gradients are
    enabled raise here, before any launch, rather than return a result
    with no gradient: a MoE layer under ``expert_exec="dual_path"`` or
    ``"dual_path_cost"`` would otherwise leave its expert weights without
    one.  The plain versions on the CPU carry gradients."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
            raise RuntimeError(
                "a CUDA kernel of the port was called under autograd on tensors that require grad: "
                "the kernels have no backward, in this package or in the JAX package's Pallas "
                "kernels; train MoE models with expert_exec='dense', or call under torch.no_grad()")
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
    _require(min(K, F, N) > 0 and K % 64 == 0 and F % 64 == 0 and N % 64 == 0,
             f"swiglu_gmm_capacity needs K, F, N positive multiples of 64; got {K}, {F}, {N}")
    _check_i32("group_sizes", group_sizes, G)
    if rhs_of_group is not None:
        _check_i32("rhs_of_group", rhs_of_group, G)
    dev = buf.device
    lib, fn = _kernel("fused_swiglu_gmm", dev)
    n_sm = _INIT[("fused_swiglu_gmm", dev.index)]["n_sm"]
    key = ("fused_swiglu_gmm", dev.index, G, C, K, F)
    if key not in _SCRATCH:
        part_floats, n_counters, stages = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
        lib.fused_swiglu_gmm_scratch(G, C, F, n_sm, ctypes.byref(part_floats),
                                     ctypes.byref(n_counters), ctypes.byref(stages))
        _require(stages.value >= 2,
                 f"swiglu_gmm_capacity with G={G}, C={C}, K={K} leaves no room for two ring stages")
        _require(n_counters.value * (K // 64) * n_sm < 2**32,
                 f"swiglu_gmm_capacity with G={G}, C={C}, K={K}, F={F} has too many chunks to split")
        _SCRATCH[key] = (part_floats.value, n_counters.value)
    part_floats, n_counters = _SCRATCH[key]
    # the bf16 SiLU products of the live rows, read back by the down units,
    # and the float32 partials of the gate/up units that blocks share
    h = _buffer("fused_swiglu_gmm", dev, (G, C, F), buf.dtype)
    part = _buffer("fused_swiglu_gmm", dev, (part_floats,), torch.float32)
    out = torch.empty((G, C, N), dtype=buf.dtype, device=dev)
    rc = fn(_ptr(buf), _ptr(wg), _ptr(wu), _ptr(wd), _ptr(group_sizes), _ptr(rhs_of_group),
            _ptr(h), _ptr(part), _ptr(out), _ptr(_tickets("fused_swiglu_gmm", dev, n_counters)),
            G, C, K, F, N, E, n_sm, _stream(buf))
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
    _require(tokens.data_ptr() % 16 == 0 and tokens.stride(0) % 8 == 0,
             "tokens must have a 16-byte aligned base and row stride")
    for name, t in (("wg", wg), ("wu", wu), ("wd", wd)):
        _check_bf16(name, t)
    _require(wg.shape == (E, K, F) and wu.shape == wg.shape and wd.shape == (E, F, N),
             "weight shapes do not match tokens")
    _require(min(K, F, N) > 0 and K % 64 == 0 and F % 64 == 0 and N % 64 == 0,
             f"swiglu_gemv needs K, F, N positive multiples of 64; got {K}, {F}, {N}")
    _check_i32("expert_ids", expert_ids, S)
    _check_i32("valid", valid, S)
    dev = tokens.device
    lib, fn = _kernel("fused_swiglu_gemv", dev)
    n_sm = _INIT[("fused_swiglu_gemv", dev.index)]["n_sm"]
    key = ("fused_swiglu_gemv", dev.index, S, E, F, N)
    if key not in _SCRATCH:
        part_floats, n_tickets, smem = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
        lib.fused_swiglu_gemv_scratch(S, E, F, N, ctypes.byref(part_floats), ctypes.byref(n_tickets),
                                      ctypes.byref(smem))
        max_smem = _INIT[("fused_swiglu_gemv", dev.index)]["max_smem"]
        _require(smem.value <= max_smem,
                 f"swiglu_gemv with S={S}, E={E} needs {smem.value} B of shared memory per block")
        _SCRATCH[key] = (part_floats.value, n_tickets.value)
    part_floats, n_tickets = _SCRATCH[key]
    # the float32 partials of the F slices, summed in the same launch
    part = _buffer("fused_swiglu_gemv", dev, (part_floats,), torch.float32)
    out = torch.empty((S, N), dtype=tokens.dtype, device=dev)
    rc = fn(_ptr(tokens), tokens.stride(0), _ptr(wg), _ptr(wu), _ptr(wd), _ptr(expert_ids),
            _ptr(valid), _ptr(part), _ptr(_tickets("fused_swiglu_gemv", dev, n_tickets)), _ptr(out),
            S, K, F, N, E, n_sm, _stream(tokens))
    _raise_on(lib, rc, "fused_swiglu_gemv")
    LAUNCHES["swiglu_gemv"] += 1
    return out


def gmm_capacity(
    buf: torch.Tensor,  # (G, C, K) capacity-layout dispatch buffer
    rhs: torch.Tensor,  # (E, K, N)
    group_sizes: torch.Tensor,  # (G,) live rows per group
    rhs_of_group: Optional[torch.Tensor] = None,  # (G,) weight row per group
) -> torch.Tensor:
    """Grouped matmul over the capacity slab -> (G, C, N); rows at or past
    ``group_sizes[g]`` are zero and dead tiles read no weights."""
    if _on_cpu(buf, rhs, group_sizes, rhs_of_group):
        return ref.gmm_ref(buf, rhs, group_sizes, rhs_of_group)
    G, C, K = buf.shape
    E, _, N = rhs.shape
    _check_bf16("buf", buf)
    _check_bf16("rhs", rhs)
    _require(rhs.shape[1] == K, f"rhs {tuple(rhs.shape)} does not match buf {tuple(buf.shape)}")
    _require(K % 64 == 0 and N % 64 == 0, f"gmm_capacity needs K % 64, N % 64 == 0; got {K}, {N}")
    _check_i32("group_sizes", group_sizes, G)
    if rhs_of_group is not None:
        _check_i32("rhs_of_group", rhs_of_group, G)
    dev = buf.device
    lib, fn = _kernel("grouped_gemm", dev)
    n_sm = _INIT[("grouped_gemm", dev.index)]["n_sm"]
    key = ("grouped_gemm", dev.index, G, C, K, N)
    if key not in _SCRATCH:
        part_floats, n_tickets, smem = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
        lib.grouped_gemm_scratch(G, C, K, N, n_sm, ctypes.byref(part_floats),
                                 ctypes.byref(n_tickets), ctypes.byref(smem))
        max_smem = _INIT[("grouped_gemm", dev.index)]["max_smem"]
        _require(smem.value <= max_smem,
                 f"gmm_capacity with G={G}, C={C} needs {smem.value} B of shared memory per block")
        _require(n_tickets.value * (K // 64) * n_sm < 2**32,
                 f"gmm_capacity with G={G}, C={C}, K={K}, N={N} has too many chunks to split")
        _SCRATCH[key] = (part_floats.value, n_tickets.value)
    part_floats, n_tickets = _SCRATCH[key]
    # float32 partials of the tiles that blocks share (one block per SM)
    part = torch.empty((part_floats,), dtype=torch.float32, device=dev)
    out = torch.empty((G, C, N), dtype=buf.dtype, device=dev)
    rc = fn(_ptr(buf), _ptr(rhs), _ptr(group_sizes), _ptr(rhs_of_group), _ptr(out), _ptr(part),
            _ptr(_tickets("grouped_gemm", dev, n_tickets)), G, C, K, N, E, n_sm, _stream(buf))
    _raise_on(lib, rc, "grouped_gemm")
    LAUNCHES["gmm_capacity"] += 1
    return out


def gmm_ragged(
    lhs: torch.Tensor,  # (M, K) group-major rows, group starts bm-aligned
    rhs: torch.Tensor,  # (E, K, N)
    group_sizes: torch.Tensor,  # (E,) live rows per group
    bm: int = 128,
) -> torch.Tensor:
    """Grouped matmul over the bm-aligned ragged layout -> (M, N): group g
    owns rows ``[start_g, start_g + round_up(size_g, bm))``, ``start_g``
    the sum of the earlier spans (``bm = min(bm, M)``, a multiple of 8);
    rows past a group's size, and past the spans' sum, are zero.  The
    group starts are found on the device (no host sync)."""
    M, K = lhs.shape
    bm = min(bm, M)
    _require(bm > 0 and bm % 8 == 0, f"gmm_ragged: bm={bm} is not a multiple of 8")
    _require(M % bm == 0, f"gmm_ragged: M={M} is not a multiple of bm={bm}")
    if _on_cpu(lhs, rhs, group_sizes):
        return ref.gmm_ragged_ref(lhs, rhs, group_sizes, bm)
    E, _, N = rhs.shape
    _check_bf16("lhs", lhs)
    _check_bf16("rhs", rhs)
    _require(rhs.shape[1] == K and E > 0, f"rhs {tuple(rhs.shape)} does not match lhs {tuple(lhs.shape)}")
    _require(K % 64 == 0 and N % 64 == 0, f"gmm_ragged needs K % 64, N % 64 == 0; got {K}, {N}")
    _check_i32("group_sizes", group_sizes, E)
    dev = lhs.device
    lib, _ = _kernel("grouped_gemm", dev)  # the library's init covers both layouts
    n_sm = _INIT[("grouped_gemm", dev.index)]["n_sm"]
    key = ("gmm_ragged", dev.index, M, K, N, E, bm)
    if key not in _SCRATCH:
        part_floats, n_tickets, smem = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_int()
        n_blocks = ctypes.c_int()
        lib.gmm_ragged_scratch(M, K, N, E, bm, n_sm, ctypes.byref(part_floats), ctypes.byref(n_tickets),
                               ctypes.byref(smem), ctypes.byref(n_blocks))
        max_smem = _INIT[("grouped_gemm", dev.index)]["max_smem"]
        _require(smem.value <= max_smem,
                 f"gmm_ragged with E={E}, K={K} needs {smem.value} B of shared memory per block")
        _require(n_tickets.value * (K // 64) * n_blocks.value < 2**32,
                 f"gmm_ragged with M={M}, K={K}, N={N} has too many chunks to split")
        _SCRATCH[key] = (part_floats.value, n_tickets.value)
    part_floats, n_tickets = _SCRATCH[key]
    # float32 partials of the tiles that blocks share (two blocks per SM)
    part = _buffer("gmm_ragged", dev, (part_floats,), torch.float32)
    out = torch.empty((M, N), dtype=lhs.dtype, device=dev)
    rc = lib.gmm_ragged(_ptr(lhs), _ptr(rhs), _ptr(group_sizes), _ptr(out), _ptr(part),
                        _ptr(_tickets("gmm_ragged", dev, n_tickets)), M, K, N, E, bm, n_sm,
                        _stream(lhs))
    _raise_on(lib, rc, "gmm_ragged")
    LAUNCHES["gmm_ragged"] += 1
    return out


def expert_gemv(
    tokens: torch.Tensor,  # (S, K), unit stride along K
    weights: torch.Tensor,  # (E, K, N)
    expert_ids: torch.Tensor,  # (S,)
    valid: Optional[torch.Tensor] = None,  # (S,) 1 = live row
) -> torch.Tensor:
    """``tokens[i] @ weights[expert_ids[i]]`` -> (S, N); ``valid=0`` rows
    are zero and read no weights."""
    S, K = tokens.shape
    if valid is None:
        valid = torch.ones((S,), dtype=torch.int32, device=tokens.device)
    if _on_cpu(tokens, weights, expert_ids, valid):
        return ref.expert_gemv_ref(tokens, weights, expert_ids, valid)
    E, _, N = weights.shape
    _require(tokens.dtype == torch.bfloat16 and tokens.stride(1) == 1,
             "tokens must be bfloat16 with unit stride along K")
    _check_bf16("weights", weights)
    _require(weights.shape[1] == K, "weight shape does not match tokens")
    _require(N % 64 == 0, f"expert_gemv needs N % 64 == 0; got {N}")
    _check_i32("expert_ids", expert_ids, S)
    _check_i32("valid", valid, S)
    lib, fn = _kernel("expert_gemv", tokens.device)
    out = torch.empty((S, N), dtype=tokens.dtype, device=tokens.device)
    rc = fn(_ptr(tokens), tokens.stride(0), _ptr(weights), _ptr(expert_ids), _ptr(valid),
            _ptr(out), S, K, N, _stream(tokens))
    _raise_on(lib, rc, "expert_gemv")
    LAUNCHES["expert_gemv"] += 1
    return out


def _check_attention(q, k, v, lengths, B: int, Kv: int) -> None:
    H, dh = q.shape[1], q.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bf16(name, t)
    _require(v.shape == k.shape and k.shape[-1] == dh, "cache shapes do not match q")
    _require(dh in ATTENTION_HEAD_DIMS,
             f"decode attention has CUDA instances for head dims {ATTENTION_HEAD_DIMS} only; got dh={dh}")
    _require(Kv > 0 and H % Kv == 0, f"decode attention needs H % Kv == 0; got H={H}, Kv={Kv}")
    _check_i32("lengths", lengths, B)


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    cache_k: torch.Tensor,  # (B, T, Kv, dh)
    cache_v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) valid entries per sequence
    n_splits: int = 1,
) -> torch.Tensor:
    """Flash-decode over a dense per-slot cache -> (B, H, dh); positions at
    or past ``lengths[b]`` are masked and length-0 rows are zero.

    ``n_splits > 1`` takes the split-KV kernel.  Its plain version
    partitions the KV axis into that many contiguous ranges of whole tiles
    (clamped to the tile count), each giving a float32 partial and its
    log-sum-exp, combined afterwards, as the TPU kernel does; on the card
    the splits follow each sequence's live length instead
    (``csrc/decode_attention_split.cu``), so the two agree within the bf16
    tolerance, not bit for bit."""
    if _on_cpu(q, cache_k, cache_v, lengths):
        if n_splits > 1:
            return ref.decode_attention_split_ref(q, cache_k, cache_v, lengths, n_splits)
        return ref.decode_attention_ref(q, cache_k, cache_v, lengths)
    B, H, dh = q.shape
    _, T, Kv, _ = cache_k.shape
    _check_attention(q, cache_k, cache_v, lengths, B, Kv)
    _require(cache_k.shape[0] == B, "cache batch does not match q")
    out = torch.empty_like(q)
    name = "decode_attention_split" if n_splits > 1 else "decode_attention"
    lib, fn = _kernel(name, q.device)
    part, lse, tickets = _split_scratch(name, lib, T, q, Kv)
    rc = fn(_ptr(q), _ptr(cache_k), _ptr(cache_v), _ptr(lengths), _ptr(part), _ptr(lse),
            _ptr(tickets), _ptr(out), B, T, Kv, H // Kv, dh, 1.0 / dh**0.5, _stream(q))
    _raise_on(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def decode_attention_paged(
    q: torch.Tensor,  # (B, H, dh)
    pool_k: torch.Tensor,  # (n_pool, page, Kv, dh) shared block pool
    pool_v: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_blocks) logical -> physical block
    lengths: torch.Tensor,  # (B,) valid entries per sequence
) -> torch.Tensor:
    """Flash-decode over the paged block pool -> (B, H, dh): each slot
    reads only the blocks below its length, through its table row."""
    if _on_cpu(q, pool_k, pool_v, block_tables, lengths):
        return ref.decode_attention_paged_ref(q, pool_k, pool_v, block_tables, lengths)
    B, H, dh = q.shape
    n_pool, page, Kv, _ = pool_k.shape
    _check_attention(q, pool_k, pool_v, lengths, B, Kv)
    _require(block_tables.dtype == torch.int32 and block_tables.is_contiguous()
             and block_tables.dim() == 2 and block_tables.shape[0] == B,
             f"block_tables must be a contiguous int32 ({B}, max_blocks)")
    max_blocks = block_tables.shape[1]
    lib, fn = _kernel("decode_attention_paged", q.device)
    part, lse, tickets = _split_scratch("decode_attention_paged", lib, max_blocks * page, q, Kv)
    out = torch.empty_like(q)
    rc = fn(_ptr(q), _ptr(pool_k), _ptr(pool_v), _ptr(block_tables), _ptr(lengths), _ptr(part),
            _ptr(lse), _ptr(tickets), _ptr(out), B, n_pool, page, Kv, H // Kv, dh, max_blocks,
            1.0 / dh**0.5, _stream(q))
    _raise_on(lib, rc, "decode_attention_paged")
    LAUNCHES["decode_attention_paged"] += 1
    return out
