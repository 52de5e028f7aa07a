"""Cost model, cost table, host scheduler and on-device split."""
