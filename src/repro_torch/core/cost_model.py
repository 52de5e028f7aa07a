"""Hardware specs and analytic timing estimators (port's copy).

Counterpart of ``repro.core.cost_model`` (paper §5.1 timing models),
cut to what the serving engine and the sieve split read:

    T_total = max(T_Comm, T_GPU(G), T_PIM(S))
    T_GPU(G) = max(T_offchip(G), T_comp(G))

Units: seconds, bytes, FLOPs throughout.  The arithmetic is copied
operation for operation, so the port exports bit-identical cost tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class DRAMTiming:
    """HBM3E timing parameters (paper Table 1), in cycles @ tCK seconds."""

    tCK: float = 0.50e-9
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
    tREFI: float = 3900e-9
    tRFC: float = 400e-9

    def seconds(self, cycles: float) -> float:
        return cycles * self.tCK

    @property
    def refresh_overhead(self) -> float:
        return self.tRFC / self.tREFI


@dataclass(frozen=True)
class XPUSpec:
    name: str
    peak_flops: float
    hbm_bw: float
    hbm_capacity: float
    link_bw: float
    link_latency: float
    tile_m: int = 128


@dataclass(frozen=True)
class PIMSpec:
    """HBM-PIM stack description (paper Table 1)."""

    stacks: int = 8
    pseudo_channels_per_stack: int = 32
    banks_per_channel: int = 24
    page_bytes: int = 1024
    pin_rate_gbps: float = 8.0
    compute_density: float = 1.0
    internal_bw_multiplier: float = 4.0
    timing: DRAMTiming = dataclasses.field(default_factory=DRAMTiming)
    gemv_cmd_overhead: float = 0.35e-6

    @property
    def n_channels(self) -> int:
        return self.stacks * self.pseudo_channels_per_stack

    @property
    def external_bw(self) -> float:
        return self.stacks * 1024 * self.pin_rate_gbps * 1e9 / 8

    @property
    def internal_bw(self) -> float:
        return self.external_bw * self.internal_bw_multiplier

    @property
    def peak_ops(self) -> float:
        return self.internal_bw * self.compute_density


@dataclass(frozen=True)
class SystemSpec:
    xpu: XPUSpec
    pim: Optional[PIMSpec]
    n_devices: int = 1


# Paper Table 1: DGX B200-class GPU with HBM-PIM stacks (the modelled
# system whose costs drive the split; not the card the port runs on).
B200 = XPUSpec(
    name="B200",
    peak_flops=2250e12,
    hbm_bw=8.0e12,
    hbm_capacity=96e9,
    link_bw=900e9,
    link_latency=0.8e-6,
)

HBM_PIM = PIMSpec()


def b200_pim_system(n_devices: int = 1) -> SystemSpec:
    return SystemSpec(xpu=B200, pim=HBM_PIM, n_devices=n_devices)


@dataclass(frozen=True)
class MoELayerSpec:
    """Dimensions of one MoE layer (all experts share these, paper §3.3)."""

    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    n_shared: int = 0
    gated: bool = True
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
        return 2 * n_tokens * self.d_model * self.dtype_bytes


@dataclass
class CostModel:
    """Analytic T_Comm / T_GPU / T_PIM estimators for one device's MoE layer."""

    system: SystemSpec
    layer: MoELayerSpec
    ep_degree: int = 1
    gpu_base_flops: float = 0.0
    gpu_base_bytes: float = 0.0
    pim_attn_time: float = 0.0
    grouped_gemm_efficiency: float = 0.85
    hbm_efficiency: float = 0.9

    def t_comm(self, total_routed_tokens: int) -> float:
        if self.ep_degree <= 1:
            return 0.0
        xpu = self.system.xpu
        remote_frac = 1.0 - 1.0 / self.ep_degree
        bytes_one_way = (
            total_routed_tokens * remote_frac * self.layer.d_model * self.layer.dtype_bytes
        )
        return 2.0 * (bytes_one_way / xpu.link_bw + xpu.link_latency)

    def t_pim_gemv_roofline(self, n_tokens: int) -> float:
        """Roofline fallback for an expert with ``n_tokens`` serialized GEMVs."""
        pim = self.system.pim
        if pim is None:
            raise ValueError("system has no PIM")
        flops = self.layer.expert_flops(1)
        return n_tokens * flops / pim.peak_ops

    def t_pim_gemv_roofline_vec(self, counts) -> np.ndarray:
        pim = self.system.pim
        if pim is None:
            raise ValueError("system has no PIM")
        c = np.asarray(counts, dtype=np.int64)
        flops = self.layer.expert_flops(1)
        return c.astype(np.float64) * flops / pim.peak_ops

    def pim_gemv_times(self, counts, cost_table=None) -> np.ndarray:
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
        """``t_gpu`` for every prefix of the descending active counts."""
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
        traffic = cum_live * m.expert_param_bytes + (
            2 * cum_tok * m.d_model * m.dtype_bytes
        )
        t_offchip = (traffic + self.gpu_base_bytes) / (
            xpu.hbm_bw * self.hbm_efficiency
        )
        flops = 2.0 * cum_pad * m.n_matrices * m.d_model * m.d_ff
        t_comp = (flops + self.gpu_base_flops) / (
            xpu.peak_flops * self.grouped_gemm_efficiency
        )
        return np.maximum(t_offchip, t_comp)

    def t_pim_suffix(self, sorted_counts: np.ndarray, cost_table=None) -> np.ndarray:
        """``t_pim`` for every suffix, summed least-popular-first."""
        sc = np.asarray(sorted_counts, dtype=np.int64)
        n = sc.shape[0]
        per_expert = self.pim_gemv_times(sc, cost_table)
        out = np.empty(n + 1, dtype=np.float64)
        out[n] = 0.0
        if n:
            out[:n] = np.cumsum(per_expert[::-1])[::-1]
        return self.pim_attn_time + out
