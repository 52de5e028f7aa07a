"""DRAM-timing-aware PIM GEMV model (paper §5.1 + Table 1) — port's copy.

Counterpart of ``repro.sim.dram.PimGemvModel``, cut to the pipelined
``expert_time`` the serving engine feeds into its cost table each step.
Same expressions in the same order, so both packages observe
bit-identical times.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.cost_model import MoELayerSpec, PIMSpec


@dataclass(frozen=True)
class PimGemvModel:
    """Timing for serialized expert GEMVs on channel-TP HBM-PIM."""

    pim: PIMSpec
    bank_conflict_factor: float = 1.25
    row_reuse: float = 0.5
    cmd_issue_overhead: float = 0.05e-6
    n_dependent_stages: int = 2

    @property
    def n_banks_total(self) -> int:
        return self.pim.n_channels * self.pim.banks_per_channel

    @property
    def refresh_factor(self) -> float:
        return 1.0 / (1.0 - self.pim.timing.refresh_overhead)

    def cmd_time_per_token(self, layer: MoELayerSpec) -> float:
        """GWRITE broadcast + GEMV issue + result readback per (token, expert)."""
        per_stack_bw = self.pim.external_bw / self.pim.stacks
        gwrite = (
            self.pim.pseudo_channels_per_stack
            * layer.d_model
            * layer.dtype_bytes
            / per_stack_bw
        )
        readback = layer.d_model * layer.dtype_bytes / self.pim.external_bw
        return self.n_dependent_stages * (self.cmd_issue_overhead + gwrite) + readback

    def expert_time(self, layer: MoELayerSpec, n_tokens: int) -> float:
        """Pipelined marginal time of ``n_tokens`` serialized GEMVs of one
        expert inside a batched PIM execution (all channels)."""
        if n_tokens <= 0:
            return 0.0
        banks = self.pim.n_channels * self.pim.banks_per_channel
        bytes_per_bank = layer.expert_param_bytes / banks
        pages_per_bank = max(bytes_per_bank / self.pim.page_bytes, 1.0)
        t_activate = self.pim.timing.seconds(self.pim.timing.tRC) * self.bank_conflict_factor
        per_bank_bw = self.pim.internal_bw / self.n_banks_total
        t_burst = self.pim.page_bytes / per_bank_bw
        act = pages_per_bank * t_activate * (
            1.0 + (n_tokens - 1) * (1.0 - self.row_reuse)
        )
        stream_tok = pages_per_bank * t_burst
        cmd_tok = self.cmd_time_per_token(layer)
        return self.refresh_factor * act + n_tokens * max(
            self.refresh_factor * stream_tok, cmd_tok
        )
