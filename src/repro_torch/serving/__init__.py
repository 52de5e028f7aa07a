"""Sieve serving runtime: continuous batching + scheduler in the loop."""

from .batching import BatchingConfig, SlotScheduler  # noqa: F401
from .engine import EngineStats, ServingEngine  # noqa: F401
from .request import Request  # noqa: F401
