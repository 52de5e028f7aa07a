"""Training data (counterpart of ``repro.data``)."""

from .pipeline import DataConfig, Prefetcher, SyntheticLM, to_device  # noqa: F401
