"""Architecture configs ported so far."""

from .base import ArchConfig, AttnConfig, MLAConfig, MoEConfig, SSMConfig, get_arch  # noqa: F401
