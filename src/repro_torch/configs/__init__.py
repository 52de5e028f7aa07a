"""Architecture configs ported so far."""

from .base import ArchConfig, AttnConfig, MoEConfig, get_arch  # noqa: F401
