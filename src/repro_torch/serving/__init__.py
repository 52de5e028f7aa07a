"""Sieve serving runtime: continuous batching + scheduler in the loop."""

from .batching import BatchingConfig, PagedKVCache, SlotScheduler  # noqa: F401
from .engine import EngineStats, ServingEngine  # noqa: F401
from .request import Request  # noqa: F401
