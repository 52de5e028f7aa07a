"""Hardware specs and analytic timing estimators (port's copy).

Counterpart of ``repro.core.cost_model``, the lightweight timing models
of paper §5.1:

    T_total = max(T_Comm, T_GPU(G), T_PIM(S))
    T_GPU(G) = max(T_offchip(G), T_comp(G))

Every scheduling policy of ``repro_torch.core.scheduler`` reads them, and
the serving engine's cost table falls back on the PIM roofline.  The
systems here are modelled ones (the paper's B200 with HBM-PIM, a TPU v5e
without PIM): their figures are specs that drive the split, not the card
the port runs on.

Units: seconds, bytes, FLOPs throughout.  The arithmetic is copied
operation for operation, so the port's policies and cost tables are
bit-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Hardware descriptions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DRAMTiming:
    """HBM3E timing parameters (paper Table 1), in cycles @ tCK seconds."""

    tCK: float = 0.50e-9  # 8.0 Gbps pin → 0.5 ns cycle
    tRCD: int = 28
    tRP: int = 28
    tRAS: int = 68
    tRC: int = 96
    tCL: int = 28
    tWR: int = 32
    tCCD_S: int = 2
    tCCD_L: int = 4
    tRRD_S: int = 6
    tRRD_L: int = 6
    tFAW: int = 12
    tREFI: float = 3900e-9  # seconds
    tRFC: float = 400e-9  # seconds

    def seconds(self, cycles: float) -> float:
        return cycles * self.tCK

    @property
    def refresh_overhead(self) -> float:
        """Fraction of time the DRAM is unavailable due to refresh."""
        return self.tRFC / self.tREFI


@dataclass(frozen=True)
class XPUSpec:
    """A host accelerator: the B200 GPU of the paper, or a TPU v5e."""

    name: str
    peak_flops: float  # at serving dtype (bf16/fp16)
    hbm_bw: float  # external HBM bandwidth, bytes/s
    hbm_capacity: float  # bytes
    link_bw: float  # inter-device bandwidth per direction, bytes/s
    link_latency: float  # seconds
    # Matmul engines operate on fixed tiles; rows are padded up to tile_m.
    tile_m: int = 128

    def gemm_time(self, flops: float) -> float:
        return flops / self.peak_flops

    def padded_rows(self, n_rows: int) -> int:
        t = self.tile_m
        return int(-(-n_rows // t) * t) if n_rows > 0 else 0


@dataclass(frozen=True)
class PIMSpec:
    """HBM-PIM stack description (paper Table 1, Samsung HBM-PIM style)."""

    stacks: int = 8
    pseudo_channels_per_stack: int = 32
    banks_per_channel: int = 24
    page_bytes: int = 1024
    pin_rate_gbps: float = 8.0
    compute_density: float = 1.0  # ops per byte streamed internally
    # Internal (near-bank) bandwidth exceeds the external pin bandwidth by
    # roughly this factor in commercial HBM-PIM (paper §2.2: "an order of
    # magnitude"; Samsung Aquabolt-XL achieves ~4x sustained for GEMV).
    internal_bw_multiplier: float = 4.0
    timing: DRAMTiming = dataclasses.field(default_factory=DRAMTiming)
    # Fixed per-GEMV command overhead: GWRITE broadcast of the input vector
    # to every channel's global buffer + result readback over the external
    # bus + command issue gaps (paper §6.2 sub-steps (i)-(iii)).
    gemv_cmd_overhead: float = 0.35e-6

    @property
    def n_channels(self) -> int:
        return self.stacks * self.pseudo_channels_per_stack

    @property
    def external_bw(self) -> float:
        """External HBM bandwidth implied by the pin rate (bytes/s)."""
        # 1024 DQ pins per stack (HBM3E) at pin_rate.
        return self.stacks * 1024 * self.pin_rate_gbps * 1e9 / 8

    @property
    def internal_bw(self) -> float:
        return self.external_bw * self.internal_bw_multiplier

    @property
    def peak_ops(self) -> float:
        """Peak PIM throughput (ops/s) = internal bytes/s x ops/byte."""
        return self.internal_bw * self.compute_density


@dataclass(frozen=True)
class SystemSpec:
    """One device (xPU + optional attached PIM) within a serving system."""

    xpu: XPUSpec
    pim: Optional[PIMSpec]
    n_devices: int = 1

    def replace(self, **kw) -> "SystemSpec":
        return dataclasses.replace(self, **kw)


# Paper Table 1: DGX B200-class GPU with HBM-PIM stacks (the modelled
# system whose costs drive the split; not the card the port runs on).
B200 = XPUSpec(
    name="B200",
    peak_flops=2250e12,
    hbm_bw=8.0e12,
    hbm_capacity=96e9,  # 50% of 192 GB sacrificed for PIM PUs (Table 1 note)
    link_bw=900e9,
    link_latency=0.8e-6,
)

HBM_PIM = PIMSpec()

# TPU v5e without PIM: a modelled system, as in the JAX package.
TPU_V5E = XPUSpec(
    name="TPUv5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_capacity=16e9,
    link_bw=50e9,
    link_latency=1.0e-6,
)


def b200_pim_system(n_devices: int = 1) -> SystemSpec:
    return SystemSpec(xpu=B200, pim=HBM_PIM, n_devices=n_devices)


def tpu_v5e_system(n_devices: int = 1) -> SystemSpec:
    return SystemSpec(xpu=TPU_V5E, pim=None, n_devices=n_devices)


# ---------------------------------------------------------------------------
# Workload descriptions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoELayerSpec:
    """Dimensions of one MoE layer (all experts share these, paper §3.3)."""

    d_model: int
    d_ff: int  # expert intermediate size
    n_experts: int
    top_k: int
    n_shared: int = 0
    gated: bool = True  # SwiGLU: 3 weight matrices, else 2
    dtype_bytes: int = 2

    @property
    def n_matrices(self) -> int:
        return 3 if self.gated else 2

    @property
    def expert_param_bytes(self) -> int:
        return self.n_matrices * self.d_model * self.d_ff * self.dtype_bytes

    def expert_flops(self, n_tokens: int) -> float:
        return 2.0 * n_tokens * self.n_matrices * self.d_model * self.d_ff

    def token_io_bytes(self, n_tokens: int) -> int:
        # activation in + activation out per expert visit
        return 2 * n_tokens * self.d_model * self.dtype_bytes


@dataclass(frozen=True)
class AttnLayerSpec:
    """Decode-phase attention dims (the op offloaded to PIM, paper §2.2)."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    dtype_bytes: int = 2

    def kv_bytes(self, batch: int, seq: int) -> float:
        return 2.0 * batch * seq * self.n_kv_heads * self.d_head * self.dtype_bytes

    def decode_flops(self, batch: int, seq: int) -> float:
        # q@k^T and p@v per head for one new token.
        return 2.0 * batch * seq * self.n_heads * self.d_head * 2

    def qkvo_param_bytes(self) -> int:
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        return (d * h * dh + 2 * d * kv * dh + h * dh * d) * self.dtype_bytes


# ---------------------------------------------------------------------------
# Cost model (paper §5.1 timing models)
# ---------------------------------------------------------------------------


@dataclass
class CostModel:
    """Analytic T_Comm / T_GPU / T_PIM estimators for one device's MoE layer.

    Parameters
    ----------
    system:     hardware description (xPU + PIM).
    layer:      MoE layer dims.
    ep_degree:  expert-parallel degree (number of devices sharing experts).
    gpu_base_flops / gpu_base_bytes:
        non-expert GPU work in the same stage (QKV gen, o-proj, router,
        norms...).  Paper: "T_comp(G) ... includes all operations except
        decode-phase attention and PIM-side expert computation".
    pim_attn_time:
        decode attention time already committed to PIM in this stage
        (the term PIMoE ignores, §5.2 "Comparison with PIMoE").
    """

    system: SystemSpec
    layer: MoELayerSpec
    ep_degree: int = 1
    gpu_base_flops: float = 0.0
    gpu_base_bytes: float = 0.0
    pim_attn_time: float = 0.0
    grouped_gemm_efficiency: float = 0.85  # achievable fraction of peak
    hbm_efficiency: float = 0.9  # achievable fraction of HBM bandwidth

    # ---- T_Comm ----------------------------------------------------------
    def t_comm(self, total_routed_tokens: int) -> float:
        """All-to-all dispatch + combine across the EP group.

        Independent of the PIM/GPU partition (paper §5.1: tokens are routed
        by the gating result regardless of the partition decision).
        """
        if self.ep_degree <= 1:
            return 0.0
        xpu = self.system.xpu
        remote_frac = 1.0 - 1.0 / self.ep_degree
        bytes_one_way = (
            total_routed_tokens * remote_frac * self.layer.d_model * self.layer.dtype_bytes
        )
        # dispatch + combine, each preceded by the routing-map AllGather (3).
        return 2.0 * (bytes_one_way / xpu.link_bw + xpu.link_latency)

    # ---- T_GPU -----------------------------------------------------------
    def t_gpu_offchip(self, gpu_counts: Sequence[int]) -> float:
        """Weight + activation traffic over external HBM for experts in G."""
        counts = np.asarray(gpu_counts, dtype=np.int64)
        counts = counts[counts > 0]
        n_live = int(counts.size)
        weight_bytes = n_live * self.layer.expert_param_bytes
        act_bytes = self.layer.token_io_bytes(int(counts.sum())) if n_live else 0
        return (weight_bytes + act_bytes + self.gpu_base_bytes) / (
            self.system.xpu.hbm_bw * self.hbm_efficiency
        )

    def t_gpu_comp(self, gpu_counts: Sequence[int]) -> float:
        """Grouped-GEMM compute time; rows pad to the matmul engine tile."""
        xpu = self.system.xpu
        counts = np.asarray(gpu_counts, dtype=np.int64)
        counts = counts[counts > 0]
        padded = ((counts + xpu.tile_m - 1) // xpu.tile_m) * xpu.tile_m
        flops = float(self.layer.expert_flops(int(padded.sum()))) + self.gpu_base_flops
        return flops / (xpu.peak_flops * self.grouped_gemm_efficiency)

    def t_gpu(self, gpu_counts: Sequence[int]) -> float:
        return max(self.t_gpu_offchip(gpu_counts), self.t_gpu_comp(gpu_counts))

    # ---- T_PIM -----------------------------------------------------------
    def t_pim_gemv_roofline(self, n_tokens: int) -> float:
        """Roofline fallback for an expert with ``n_tokens`` serialized GEMVs.

        Paper §5.1: used only until the runtime cost table has an observed
        entry; known to overestimate achievable PIM throughput (i.e.
        underestimate time) by 1.8-4.2x.
        """
        pim = self.system.pim
        if pim is None:
            raise ValueError("system has no PIM")
        flops = self.layer.expert_flops(1)  # one GEMV pass streams the weights
        return n_tokens * flops / pim.peak_ops

    def t_pim_gemv_roofline_vec(self, counts) -> np.ndarray:
        """Vectorized :meth:`t_pim_gemv_roofline` over an int count array.

        Bit-identical per element to the scalar call (same operation order).
        """
        pim = self.system.pim
        if pim is None:
            raise ValueError("system has no PIM")
        c = np.asarray(counts, dtype=np.int64)
        flops = self.layer.expert_flops(1)
        return c.astype(np.float64) * flops / pim.peak_ops

    def t_pim(
        self,
        pim_counts: Sequence[int],
        cost_table=None,
    ) -> float:
        """Attention-on-PIM time + serialized expert GEMV time (paper ③)."""
        counts = [int(c) for c in pim_counts if c > 0]
        if cost_table is not None:
            gemv = sum(cost_table.lookup(c) for c in counts)
        else:
            gemv = sum(self.t_pim_gemv_roofline(c) for c in counts)
        return self.pim_attn_time + gemv

    # ---- batched prefix-split evaluation (vectorized scheduler core) -----
    def pim_gemv_times(self, counts, cost_table=None) -> np.ndarray:
        """Per-expert PIM GEMV seconds for an int count array (zeros -> 0).

        Batched replacement for per-expert ``cost_table.lookup`` /
        ``t_pim_gemv_roofline`` calls; values are bit-identical to the
        scalar path.
        """
        c = np.asarray(counts, dtype=np.int64)
        active = c > 0
        out = np.zeros(c.shape, dtype=np.float64)
        if active.any():
            if cost_table is not None:
                out[active] = cost_table.lookup_vec(c[active])
            else:
                out[active] = self.t_pim_gemv_roofline_vec(c[active])
        return out

    def t_gpu_prefix(self, sorted_counts: np.ndarray) -> np.ndarray:
        """``t_gpu`` for every prefix of ``sorted_counts`` at once.

        ``sorted_counts`` must be the active (>0) token counts sorted
        descending; element ``g`` of the result equals
        ``self.t_gpu(sorted_counts[:g])`` bit-exactly (integer byte/FLOP
        totals are prefix-summed exactly in int64; the float operations then
        mirror the scalar path's order).  O(E) instead of O(E^2).
        """
        xpu = self.system.xpu
        sc = np.asarray(sorted_counts, dtype=np.int64)
        n = sc.shape[0]
        cum_tok = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sc, out=cum_tok[1:])
        padded = ((sc + xpu.tile_m - 1) // xpu.tile_m) * xpu.tile_m
        cum_pad = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(padded, out=cum_pad[1:])
        cum_live = np.arange(n + 1, dtype=np.int64)

        m = self.layer
        # offchip: n_live * expert_param_bytes + token_io_bytes(total) + base
        traffic = cum_live * m.expert_param_bytes + (
            2 * cum_tok * m.d_model * m.dtype_bytes
        )
        t_offchip = (traffic + self.gpu_base_bytes) / (
            xpu.hbm_bw * self.hbm_efficiency
        )
        # comp: expert_flops(padded total) + base, same operation order as
        # MoELayerSpec.expert_flops (2.0 * n * n_matrices * d_model * d_ff)
        flops = 2.0 * cum_pad * m.n_matrices * m.d_model * m.d_ff
        t_comp = (flops + self.gpu_base_flops) / (
            xpu.peak_flops * self.grouped_gemm_efficiency
        )
        return np.maximum(t_offchip, t_comp)

    def t_pim_suffix(self, sorted_counts: np.ndarray, cost_table=None) -> np.ndarray:
        """``t_pim`` for every suffix of ``sorted_counts`` at once.

        Element ``g`` equals ``self.t_pim(sorted_counts[g:][::-1], ...)``
        bit-exactly: the suffix scan accumulates least-popular-first, the
        same association order a scalar left-to-right sum over the reversed
        suffix uses (floating-point addition commutes but does not
        associate, so the order is pinned on both sides).
        """
        sc = np.asarray(sorted_counts, dtype=np.int64)
        n = sc.shape[0]
        per_expert = self.pim_gemv_times(sc, cost_table)
        out = np.empty(n + 1, dtype=np.float64)
        out[n] = 0.0
        if n:
            # cumsum over the reversed per-expert times: entry j holds
            # ts[n-1] + ... + ts[n-1-j]; suffix split g reads entry n-1-g.
            out[:n] = np.cumsum(per_expert[::-1])[::-1]
        return self.pim_attn_time + out

    # ---- objective -------------------------------------------------------
    def t_total(
        self,
        gpu_counts: Sequence[int],
        pim_counts: Sequence[int],
        total_routed_tokens: int,
        cost_table=None,
    ) -> float:
        return max(
            self.t_comm(total_routed_tokens),
            self.t_gpu(gpu_counts),
            self.t_pim(pim_counts, cost_table),
        )


def attention_time_on_pim(
    system: SystemSpec, attn: AttnLayerSpec, batch: int, seq: int
) -> float:
    """Decode attention executed on PIM (GEMV-shaped, internal-bw bound)."""
    pim = system.pim
    if pim is None:
        raise ValueError("system has no PIM")
    t_stream = attn.kv_bytes(batch, seq) / pim.internal_bw
    # per-request score+value GEMV pair (commands per head-group batch)
    t_cmd = batch * 2 * pim.gemv_cmd_overhead
    return (t_stream + t_cmd) / (1.0 - pim.timing.refresh_overhead)


def attention_time_on_xpu(
    system: SystemSpec, attn: AttnLayerSpec, batch: int, seq: int
) -> float:
    """Decode attention kept on the xPU (external-HBM bound)."""
    xpu = system.xpu
    t_mem = attn.kv_bytes(batch, seq) / xpu.hbm_bw
    t_comp = attn.decode_flops(batch, seq) / xpu.peak_flops
    return max(t_mem, t_comp)
