"""Launching the port over ranks: the rank grid of ``torch.distributed``."""
