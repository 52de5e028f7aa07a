"""Fault detection for the serving runtime (port's copy of the part of
``repro.faults`` the engine runs)."""

from .health import HealthMonitor  # noqa: F401
