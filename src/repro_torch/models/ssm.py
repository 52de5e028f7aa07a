"""State-space blocks: Mamba2 (chunked SSD) and RWKV6 (Finch), the
counterpart of ``repro.models.ssm``.

Both have a sequence form (prefill: Mamba2's chunked SSD, RWKV6's
recurrence over chunks of steps) and a one-token recurrent form (decode,
O(1) state), plus init and state constructors.  Plain PyTorch, as the
reference is plain jnp: no Pallas kernel covers either.  The float32
islands are the reference's: ``dt``, the log decays, the SSD sums and
state, the WKV state and the decay ``exp(-exp(dd))``; the conv and
token-shift states stay in the model dtype.

Simplifications of the reference, kept: Mamba2 with no projection bias
and RMSNorm gating; RWKV6's r/k/v/g token-shift mixes are static learned
ratios (the dynamic mix LoRA is omitted), its decay LoRA is Finch's.

The sequence forms run under autograd (training): neither writes to its
input state, and under autograd each chunk of RWKV6's WKV recurrence is
recomputed in the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint(chunk_body)``), so its per-step states are
not kept.

On a tensor-parallel rank (``sharding.tp_splits``' ``mamba``, ``rwkv`` and
``cmix`` layers) a block's weights are the rank's slices: the functions
read their head counts from them (Mamba2's ``A_log``, RWKV6's ``u``) and
take the model group (``group``) whose sums the block needs: Mamba2's
gated RMSNorm over the whole ``d_inner`` and its ``w_out``, RWKV6's
``w_o`` and ``w_cv`` (row-parallel sums in float32).  What every rank
computes whole and then feeds to its own heads or columns enters them
through ``collectives.enter`` (its gradient summed over the group): the
block's input where it meets the rank's columns, Mamba2's ``B``/``C`` and
its norm's sum of squares, RWKV6's token-shift mixes and the decay LoRA's
``tanh(mix_w @ wA)``.  Mamba2's whole ``B``/``C`` columns of ``w_in`` read
the input itself, so their gradient to it is counted once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SSMConfig
from . import collectives as coll

# leaves the reference keeps in float32 whatever the model dtype
# (repro/models/ssm.py:36-53, 265-293)
FLOAT32_LEAVES = (
    "A_log", "D", "dt_bias", "norm_scale",  # Mamba2
    "mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "cmix_k", "cmix_r",  # RWKV6
    "w0", "wA", "wB", "u", "ln_x_scale",
)
# leaves set to one value at init
_FILL = {"D": 1.0, "dt_bias": 0.0, "norm_scale": 1.0, "conv_b": 0.0, "mix_r": 0.5, "mix_k": 0.5,
         "mix_v": 0.5, "mix_w": 0.5, "mix_g": 0.5, "cmix_k": 0.5, "cmix_r": 0.5, "w0": -6.0,
         "ln_x_scale": 1.0}
# random leaves drawn as normal * scale (the others: normal * scale / sqrt(fan_in))
_NORMAL = {"conv_w": 0.1, "u": 0.1}
_HE_SCALE = {"wB": 0.1}


def init_leaf(name: str, shape, dtype, device,
              randn: Callable[[Tuple[int, ...]], torch.Tensor]) -> torch.Tensor:
    """One parameter of a Mamba2 or RWKV6 block as the reference
    initialises it: its fixed value, or ``randn(shape)`` (float32 standard
    normals on ``device``) scaled.  Float32 for ``FLOAT32_LEAVES``, else
    ``dtype``."""
    dtype = torch.float32 if name in FLOAT32_LEAVES else dtype
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0], device=device))
    if name in _FILL:
        return torch.full(shape, _FILL[name], dtype=dtype, device=device)
    w = randn(tuple(shape))
    if name in _NORMAL:
        return w.mul_(_NORMAL[name]).to(dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return w.mul_(_HE_SCALE.get(name, 1.0) * fan_in**-0.5).to(dtype)


def _init(shapes: dict, gen, dtype, device) -> dict:
    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    return {name: init_leaf(name, shape, dtype, device, randn) for name, shape in shapes.items()}


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def mamba2_dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.expand * d_model
    return d_inner, d_inner // cfg.head_dim


def init_mamba2(gen, d_model: int, cfg: SSMConfig, dtype, device) -> dict:
    d_inner, H = mamba2_dims(d_model, cfg)
    GN = cfg.n_groups * cfg.d_state
    return _init({
        # fused in_proj: [z, xBC, dt]
        "w_in": (d_model, 2 * d_inner + 2 * GN + H),
        "conv_w": (cfg.conv_width, d_inner + 2 * GN),
        "conv_b": (d_inner + 2 * GN,),
        "A_log": (H,),
        "D": (H,),
        "dt_bias": (H,),
        "norm_scale": (d_inner,),
        "w_out": (d_inner, d_model),
    }, gen, dtype, device)


class Mamba2State(NamedTuple):
    conv: torch.Tensor  # (..., B, conv_width-1, conv_channels), model dtype
    ssm: torch.Tensor  # (..., B, H, P, N) float32


def mamba2_init_state(batch: int, d_model: int, cfg: SSMConfig, dtype, device,
                      stack: Tuple[int, ...] = (), heads: int | None = None) -> Mamba2State:
    """Zero states; ``stack`` prepends layer axes (the cache's stacked
    layout).  ``heads``: a tensor-parallel rank's heads (its conv channels
    are their ``x`` channels and ``B``/``C`` whole)."""
    H = heads or mamba2_dims(d_model, cfg)[1]
    d_inner = H * cfg.head_dim
    conv_ch = d_inner + 2 * cfg.n_groups * cfg.d_state
    return Mamba2State(
        conv=torch.zeros(stack + (batch, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
        ssm=torch.zeros(stack + (batch, H, cfg.head_dim, cfg.d_state), dtype=torch.float32,
                        device=device),
    )


def _mamba2_local_dims(params, cfg: SSMConfig):
    """(d_inner, H) of the block whose weights are ``params``: the model's,
    or a tensor-parallel rank's heads (``A_log`` holds one entry a head)."""
    H = params["A_log"].shape[-1]
    return H * cfg.head_dim, H


def _mamba2_preproject(params, x, cfg: SSMConfig, d_inner: int, group=None):
    """``x @ w_in`` split into ``z``, ``xBC`` and ``dt``.  Under autograd
    with ``group`` the rank's ``z``, ``x`` and ``dt`` columns read the
    entered input and the whole ``B``/``C`` columns ``x`` itself (the same
    values)."""
    GN = cfg.n_groups * cfg.d_state
    w = params["w_in"]
    xe = coll.enter(x, group)
    if xe is x:
        proj = x @ w
    else:
        bc = 2 * d_inner + 2 * GN
        proj = torch.cat([xe @ w[:, :2 * d_inner], x @ w[:, 2 * d_inner:bc], xe @ w[:, bc:]], dim=-1)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner: 2 * d_inner + 2 * GN]
    dt = proj[..., 2 * d_inner + 2 * GN:].float()
    return z, xBC, dt


def _split_xbc(xBC, d_inner: int, G: int, N: int):
    return xBC[..., :d_inner], xBC[..., d_inner: d_inner + G * N], xBC[..., d_inner + G * N:]


def _heads(m: torch.Tensor, G: int, H: int, N: int) -> torch.Tensor:
    """(..., G * N) group rows -> (..., H, N) float32, each group's row
    shared by its H // G heads."""
    lead = m.shape[:-1]
    g = m.reshape(lead + (G, 1, N)).float()
    return g.expand(lead + (G, H // G, N)).reshape(lead + (H, N))


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, dtype, group=None) -> torch.Tensor:
    """``y * silu(z)``, RMSNorm in float32 with ``norm_scale``, out
    projection.  With ``group`` the rank holds some heads' channels of
    ``d_inner``: the mean square is the group's sum of squares over the
    whole width, and the projection's partials are summed."""
    yf = (y * F.silu(z)).float()
    if group is None:
        ms = (yf * yf).mean(-1, keepdim=True)
    else:
        ss = coll.row_parallel_sum((yf * yf).sum(-1, keepdim=True), group)
        ms = coll.enter(ss, group) / (yf.shape[-1] * coll.group_size(group))
    yf = yf * torch.rsqrt(ms + 1e-6) * params["norm_scale"]
    return coll.row_parallel_sum(yf.to(dtype) @ params["w_out"], group)


def ssd_chunk(T: int) -> int:
    """Mamba2's SSD chunk: 128 (or T), halved until it divides T."""
    Lc = min(128, T)
    while T % Lc:
        Lc //= 2
    return Lc


def mamba2_seq(
    params: dict,
    x: torch.Tensor,  # (B, T, d_model)
    cfg: SSMConfig,
    state: Mamba2State | None = None,
    group=None,
) -> Tuple[torch.Tensor, Mamba2State]:
    """Chunked SSD over a sequence; returns the output and the final state
    (from zeros when ``state`` is None).  ``group``: the model group of a
    tensor-parallel rank (module docstring)."""
    Bsz, T, d_model = x.shape
    d_inner, H = _mamba2_local_dims(params, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim
    if state is None:
        state = mamba2_init_state(Bsz, d_model, cfg, x.dtype, x.device, heads=H)

    z, xBC, dt = _mamba2_preproject(params, x, cfg, d_inner, group)
    # causal depthwise conv with carried state
    pad = torch.cat([state.conv.to(xBC.dtype), xBC], dim=1)
    new_conv = pad[:, -(cfg.conv_width - 1):, :] if cfg.conv_width > 1 else state.conv
    w = params["conv_w"]  # (W, C)
    conv = sum(pad[:, i: i + T, :] * w[i][None, None, :] for i in range(cfg.conv_width))
    xBC = F.silu(conv + params["conv_b"])
    x_ssm, Bm, Cm = _split_xbc(xBC, d_inner, G, N)
    Bm, Cm = coll.enter(Bm, group), coll.enter(Cm, group)

    xh = x_ssm.reshape(Bsz, T, H, P).float()
    Bh, Ch = _heads(Bm, G, H, N), _heads(Cm, G, H, N)
    dt = F.softplus(dt + params["dt_bias"])  # (B, T, H)
    log_a = dt * -torch.exp(params["A_log"])  # (B, T, H) log decay per step

    Lc = ssd_chunk(T)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=x.device))
    h = state.ssm
    ys = []
    for c0 in range(0, T, Lc):
        xk, Bk, Ck = xh[:, c0:c0 + Lc], Bh[:, c0:c0 + Lc], Ch[:, c0:c0 + Lc]
        dtk, lak = dt[:, c0:c0 + Lc], log_a[:, c0:c0 + Lc]
        l = torch.cumsum(lak, dim=1)  # (B, Lc, H) inclusive
        # intra-chunk: M[t, j] = (C_t . B_j) exp(l_t - l_j) dt_j  (j <= t)
        scores = torch.einsum("bthn,bjhn->bhtj", Ck, Bk)
        # (B, t, j, H); the clip handles the masked pairs
        decay = torch.exp(torch.clamp(l[:, :, None, :] - l[:, None, :, :], -60.0, 0.0))
        M = scores * decay.permute(0, 3, 1, 2) * tri
        M = M * dtk.permute(0, 2, 1)[:, :, None, :]  # times dt_j
        y_intra = torch.einsum("bhtj,bjhp->bthp", M, xk)
        # inter-chunk: y_t += (C_t . h_in) exp(l_t)
        y_inter = torch.einsum("bthn,bhpn->bthp", Ck * torch.exp(l)[..., None], h)
        # state: h_out = h exp(l_L) + sum_j exp(l_L - l_j) dt_j x_j B_j
        lL = l[:, -1:, :]
        w_j = torch.exp(torch.clamp(lL - l, -60.0, 0.0)) * dtk
        h = h * torch.exp(lL[:, 0, :])[:, :, None, None] + torch.einsum(
            "bjhp,bjhn,bjh->bhpn", xk, Bk, w_j)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) + xh * params["D"][None, None, :, None]
    out = _gated_out(params, y.reshape(Bsz, T, d_inner).to(x.dtype), z, x.dtype, group)
    return out, Mamba2State(conv=new_conv.to(state.conv.dtype), ssm=h)


def mamba2_step(
    params: dict,
    x: torch.Tensor,  # (B, 1, d_model)
    cfg: SSMConfig,
    state: Mamba2State,
    group=None,
) -> Tuple[torch.Tensor, Mamba2State]:
    """One-token recurrent update (decode)."""
    Bsz = x.shape[0]
    d_inner, H = _mamba2_local_dims(params, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.head_dim

    z, xBC, dt = _mamba2_preproject(params, x, cfg, d_inner, group)
    z, xBC, dt = z[:, 0], xBC[:, 0], dt[:, 0]
    window = torch.cat([state.conv.to(xBC.dtype), xBC[:, None, :]], dim=1)  # (B, W, C)
    xBC = F.silu(torch.einsum("bwc,wc->bc", window, params["conv_w"]) + params["conv_b"])
    x_ssm, Bm, Cm = _split_xbc(xBC, d_inner, G, N)

    xh = x_ssm.reshape(Bsz, H, P).float()
    Bh, Ch = _heads(Bm, G, H, N), _heads(Cm, G, H, N)
    dt = F.softplus(dt + params["dt_bias"])  # (B, H)
    a = torch.exp(dt * -torch.exp(params["A_log"]))  # (B, H)

    h = state.ssm * a[:, :, None, None] + torch.einsum("bhp,bhn,bh->bhpn", xh, Bh, dt)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + xh * params["D"][None, :, None]
    out = _gated_out(params, y.reshape(Bsz, d_inner).to(x.dtype), z, x.dtype, group)[:, None, :]
    return out, Mamba2State(conv=window[:, 1:, :].to(state.conv.dtype), ssm=h)


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================


def rwkv6_dims(d_model: int, cfg: SSMConfig):
    return d_model // cfg.head_dim, cfg.head_dim


def init_rwkv6(gen, d_model: int, d_ff: int, cfg: SSMConfig, dtype, device) -> dict:
    H, P = rwkv6_dims(d_model, cfg)
    D = d_model
    return _init({
        # time mix
        "mix_r": (D,), "mix_k": (D,), "mix_v": (D,), "mix_w": (D,), "mix_g": (D,),
        "w_r": (D, D), "w_k": (D, D), "w_v": (D, D), "w_g": (D, D), "w_o": (D, D),
        # data-dependent decay LoRA (Finch)
        "w0": (D,), "wA": (D, cfg.decay_lora), "wB": (cfg.decay_lora, D), "u": (H, P),
        "ln_x_scale": (D,),
        # channel mix
        "cmix_k": (D,), "cmix_r": (D,),
        "w_ck": (D, d_ff), "w_cv": (d_ff, D), "w_cr": (D, D),
    }, gen, dtype, device)


class RWKV6State(NamedTuple):
    x_tm: torch.Tensor  # (..., B, D) last input to the time mix
    x_cm: torch.Tensor  # (..., B, D) last input to the channel mix
    wkv: torch.Tensor  # (..., B, H, P, P) float32 [key dim x value dim]


def rwkv6_init_state(batch: int, d_model: int, cfg: SSMConfig, dtype, device,
                     stack: Tuple[int, ...] = (), heads: int | None = None) -> RWKV6State:
    """Zero states; ``stack`` prepends layer axes.  ``heads``: a
    tensor-parallel rank's heads (the WKV state's; the token-shift states
    are whole)."""
    H, P = rwkv6_dims(d_model, cfg)
    H = heads or H
    return RWKV6State(
        x_tm=torch.zeros(stack + (batch, d_model), dtype=dtype, device=device),
        x_cm=torch.zeros(stack + (batch, d_model), dtype=dtype, device=device),
        wkv=torch.zeros(stack + (batch, H, P, P), dtype=torch.float32, device=device),
    )


def _token_shift(x: torch.Tensor, x_last: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> the previous token at each position; position 0 takes
    ``x_last``."""
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, prev: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    m = m.float()
    return (x.float() * m + prev.float() * (1 - m)).to(x.dtype)


def _wkv_scan(r, k, v, w, u, S):
    """The WKV6 recurrence over a span of steps, in float32.

    r, k, v, w: (B, L, H, P); u: (H, P); S: (B, H, P, P).
      y_t = r_t . (S + (u * k_t) outer v_t);   S' = diag(w_t) S + k_t outer v_t
    Returns the final state and y (B, L, H, P)."""
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv))
        S = S * w[:, t, :, :, None] + kv
    return S, torch.stack(ys, dim=1)


def wkv_chunk(T: int, target: int) -> int:
    """RWKV6's WKV chunk: ``target`` (or T), decremented until it divides
    T."""
    Lc = max(min(target, T), 1)
    while T % Lc:
        Lc -= 1
    return Lc


def rwkv6_time_mix_seq(params, x, cfg: SSMConfig, state: RWKV6State, group=None):
    B, T, D = x.shape
    H, P = params["u"].shape  # this rank's heads on a tensor-parallel mesh
    prev = _token_shift(x, state.x_tm.to(x.dtype))

    def mix(name):  # entering the rank's heads' columns
        return coll.enter(_mix(x, prev, params[f"mix_{name}"]), group)

    r = (mix("r") @ params["w_r"]).reshape(B, T, H, P).float()
    k = (mix("k") @ params["w_k"]).reshape(B, T, H, P).float()
    v = (mix("v") @ params["w_v"]).reshape(B, T, H, P).float()
    g = mix("g") @ params["w_g"]
    # data-dependent decay (LoRA): w in (0, 1)
    lora = torch.tanh(_mix(x, prev, params["mix_w"]).float() @ params["wA"])  # wA whole
    dd = params["w0"] + coll.enter(lora, group) @ params["wB"]
    w = torch.exp(-torch.exp(dd)).reshape(B, T, H, P)

    # chunks of the reference's length: under autograd only the state at
    # their boundaries is kept, each chunk recomputed in the backward pass;
    # the sums are the same sequential recurrence
    Lc = wkv_chunk(T, cfg.wkv_chunk)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, params["u"]))
    S, ys = state.wkv, []
    for c0 in range(0, T, Lc):
        span = slice(c0, c0 + Lc)
        args = (r[:, span], k[:, span], v[:, span], w[:, span], params["u"], S)
        S, y = checkpoint(_wkv_scan, *args, use_reentrant=False) if remat else _wkv_scan(*args)
        ys.append(y)
    # group norm over each head (ln_x), then the gate
    yf = torch.cat(ys, dim=1)  # (B, T, H, P)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, correction=0, keepdim=True)
    yf = (yf - mu) * torch.rsqrt(var + 1e-5)
    y = (yf.reshape(B, T, H * P) * params["ln_x_scale"]).to(x.dtype)
    out = coll.row_parallel_sum((y * F.silu(g)) @ params["w_o"], group)
    return out, RWKV6State(x_tm=x[:, -1, :], x_cm=state.x_cm, wkv=S)


def rwkv6_channel_mix_seq(params, x, state: RWKV6State, group=None):
    prev = _token_shift(x, state.x_cm.to(x.dtype))
    xk = _mix(x, prev, params["cmix_k"])
    xr = _mix(x, prev, params["cmix_r"])
    kv = coll.row_parallel_sum(torch.square(F.relu(coll.enter(xk, group) @ params["w_ck"])) @ params["w_cv"],
                               group)
    out = torch.sigmoid((xr @ params["w_cr"]).float()).to(x.dtype) * kv
    return out, RWKV6State(x_tm=state.x_tm, x_cm=x[:, -1, :], wkv=state.wkv)


def rwkv6_block_seq(params, x, cfg: SSMConfig, state: RWKV6State, norm_params, groups=(None, None)):
    """The whole RWKV6 block: time mix and channel mix, each after a
    LayerNorm.  ``groups``: the model groups of the time mix and the channel
    mix on a tensor-parallel rank."""
    from .layers import apply_norm

    h, state = rwkv6_time_mix_seq(params, apply_norm(norm_params[0], x, "layernorm"), cfg, state, groups[0])
    x = x + h
    h, state = rwkv6_channel_mix_seq(params, apply_norm(norm_params[1], x, "layernorm"), state, groups[1])
    return x + h, state


def rwkv6_block_step(params, x, cfg: SSMConfig, state: RWKV6State, norm_params):
    """One-token step: the sequence form with T = 1 (one recurrence
    update)."""
    return rwkv6_block_seq(params, x, cfg, state, norm_params)
